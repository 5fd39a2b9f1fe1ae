"""The sorted-scan fleet: scans prepared before the window are bitwise the
port's own host prep (``pipeline.prepare_scan``); a planted scan is
unsorted by one pair and sorts back to its prepared rows; the check maps
the sorted outputs back to the raw order, and comes out false without that
map, when a prepared drive was sorted against a center one cell off (the
step's sortedness check counts more fallbacks than were planted), or when
the step drops its check or its count. The unsorted fleet still steps the
raw scans it stepped before prepared drives existed."""

import json
import types

import numpy as np
import pytest
import torch

from groundgrid_torch import GroundGridConfig, pipeline
from groundgrid_torch.core import exactf32
from groundgrid_torch.parallel.sharding import FleetStep
from portbench import loops, prepare, scenes
from portbench.bench import Cell, Context, run_cell
from portbench.roofline import drive_centers
from portbench.tests import tiny
from portbench.traffic import WARMUP_DRIVE, Schedule

SORTED = "tinyfleet-sorted.tiny-sorted"


def run(root, workload, seed=5):
    return run_cell(root, workload, seed, 3.0, False, "cpu", log=lambda line: None)


def _pool_rows(cfg, seed):
    mix = dict(tiny.TRAFFIC, vehicles=4, phase_step=2)
    pool = scenes.render_pool(tiny.SENSOR, mix["scene"], 4, 1.0, cfg.max_points, seed, "cpu")
    rows = torch.zeros((5, 4, cfg.max_points))
    rows[:3] = pool.points.permute(2, 0, 1)
    rows[3].view(torch.int32)[:] = pool.rings
    rows[4].view(torch.int32)[:] = (torch.arange(cfg.max_points)[None]
                                    < torch.tensor(pool.counts)[:, None]).int()
    return pool, Schedule(mix, seed, pool.poses), rows


@pytest.mark.parametrize("seed", [2**31 + 5, 7])
def test_preparation_is_prepare_scan_bitwise(seed):
    cfg = GroundGridConfig(**tiny.SORTED)
    pool, schedule, rows = _pool_rows(cfg, seed)
    idx, poses = schedule.drive_poses(1)
    centers = drive_centers(poses, cfg.resolution)
    hi, lo = exactf32.f64_to_ds(centers)
    seen = set()
    for pos in range(schedule.drive_scans):
        out, order = prepare.prepare_rows(rows[:, idx[pos]], poses[pos], hi[pos], lo[pos], cfg)
        cells = prepare.cells(cfg, hi[pos], lo[pos], out[0], out[1],
                              out[4].view(torch.int32) != 0)
        for v in range(schedule.vehicles):
            i = int(idx[pos, v])
            c = pool.counts[i]
            scan, want = pipeline.prepare_scan(cfg, pool.points[i, :c].numpy(),
                                               pool.rings[i, :c].numpy(), poses[pos, v],
                                               centers[pos, v], "cpu")
            assert np.array_equal(order[v].numpy(), want)
            for got, row in zip(out[:, v], (scan.px, scan.py, scan.pz, scan.rings, scan.valid)):
                assert torch.equal(got.view(row.dtype), row)
            assert np.array_equal(scan.center, hi[pos, v])
            assert np.array_equal(scan.center_lo, lo[pos, v])
            host = pipeline.predict_cells(cfg, scan.center, scan.px.numpy(), scan.py.numpy(),
                                          scan.valid.numpy(), center_lo=scan.center_lo)
            assert np.array_equal(cells[v].numpy(), host)
            seen.update(np.unique(host).tolist())
    # the scans span many cells, in the map and out of it
    n2 = cfg.cell_count ** 2
    assert n2 in seen and len(seen) > 50


@pytest.mark.parametrize("seed", [2**31 + 5, 7])
def test_planted_scan_is_unsorted_by_one_pair_and_sorts_back(seed):
    cfg = GroundGridConfig(**tiny.SORTED)
    pool, schedule, rows = _pool_rows(cfg, seed)
    idx, poses = schedule.drive_poses(0)
    hi, lo = exactf32.f64_to_ds(drive_centers(poses, cfg.resolution))
    out, _ = prepare.prepare_rows(rows[:, idx[2]], poses[2], hi[2], lo[2], cfg)
    prepared = out[:, 0].clone()
    planted = out[:, 0]
    prepare.plant(cfg, planted, hi[2, 0], lo[2, 0])

    def ids(r):
        return prepare.cells(cfg, hi[2, :1], lo[2, :1], r[0][None], r[1][None],
                             r[4].view(torch.int32)[None] != 0)[0]

    cell = ids(planted)
    assert int((cell[1:] < cell[:-1]).sum()) == 1
    assert not torch.equal(planted, prepared)
    # the step's stable sort of its ids gives back the prepared scan, bit for bit
    order = torch.argsort(cell, stable=True)
    assert torch.equal(planted[:, order].view(torch.int32), prepared.view(torch.int32))


def test_drives_step_the_prepared_sets():
    mix = dict(tiny.TRAFFIC, vehicles=4, phase_step=2)
    poses = np.tile(np.eye(4), (4, 1, 1))
    poses[:, 0, 3] = np.arange(4.0)
    s = Schedule(mix, 11, poses)
    s.sets = prepare.SETS
    for drive in (2, 5, WARMUP_DRIVE):
        want_idx, want_poses = s.drive_poses(drive % 2)
        got_idx, got_poses = s.drive_poses(drive)
        assert (got_idx == want_idx).all() and (got_poses == want_poses).all()
    assert not (s.drive_poses(0)[1] == s.drive_poses(1)[1]).all()


def test_sorted_fleet_run_is_correct_and_counts_the_planted_fallbacks(tmp_path, monkeypatch):
    counts = []
    counted = loops.Fleet.counted
    monkeypatch.setattr(loops.Fleet, "counted",
                        lambda self: counts.append((self.step.fallbacks, self.planted))
                        or counted(self))
    result = run(tiny.write(tmp_path), SORTED)
    assert result["correct"] is True
    assert result["checks"]["fallbacks_off"] == {"value": 0, "limit": 0}
    # the warm-up drive and each drive of the window that reached the planted position
    (fallbacks, planted), = counts
    assert fallbacks == planted >= 2


def test_outputs_left_in_the_sorted_order_are_not_correct(tmp_path, monkeypatch):
    monkeypatch.setattr(loops, "in_raw_order", lambda kept: kept)
    result = run(tiny.write(tmp_path), SORTED)
    assert result["correct"] is False
    assert result["checks"]["point_mismatch"]["value"] > 0.01


def test_drive_sorted_against_a_center_one_cell_off_counts_fallbacks(tmp_path, monkeypatch):
    rows = prepare.prepare_rows
    res = np.float32(tiny.SORTED["resolution"])

    def one_cell_off(raw, poses, center_hi, center_lo, cfg):
        return rows(raw, poses, center_hi + np.array([res, 0], np.float32), center_lo, cfg)

    monkeypatch.setattr(prepare, "prepare_rows", one_cell_off)
    result = run(tiny.write(tmp_path), SORTED)
    assert result["correct"] is False
    assert result["checks"]["fallbacks_off"]["value"] > 0
    # the step's fallback sort keeps the labels sound: only the count gives it away
    points = result["checks"]["point_mismatch"]
    assert points["value"] <= points["limit"]


@pytest.mark.parametrize("fault", ["count_dropped", "check_skipped"])
def test_step_without_its_sortedness_check_is_not_correct(tmp_path, monkeypatch, fault):
    """A step that stops counting its fallbacks, or skips the check (and
    its sort) altogether, counts none of the planted scans."""
    root = tiny.write(tmp_path)
    if fault == "count_dropped":
        monkeypatch.setattr(FleetStep, "fallbacks", property(lambda self: 0))
    else:
        conf = root / "portbench" / "configs" / "tiny-sorted.json"
        data = json.loads(conf.read_text())
        data["groundgrid"]["sorted_fallback_check"] = False
        conf.write_text(json.dumps(data))
    result = run(root, SORTED)
    assert result["correct"] is False
    assert result["checks"]["fallbacks_off"]["value"] >= 2


class _Recorder:
    """Stands in for the fleet step: records the scan blocks of each tick."""

    def __init__(self):
        self.ticks = []

    def __call__(self, states, scans):
        self.ticks.append(scans)
        return states, None, types.SimpleNamespace(ground_points=torch.zeros(()))


@pytest.mark.parametrize("workload", ["tinyfleet.tiny", "tinyfleet2.tiny"])
def test_unsorted_fleet_steps_the_raw_scans_as_before(tmp_path, workload):
    """The scans each tick hands over, against how the loop built them
    before prepared drives: vehicle v at pool index pingpong(2 v + t), its
    drive's seed-drawn offset times the pool pose, the raw rows, and the
    host tracker's center from the drive's first pose."""
    root = tiny.write(tmp_path)
    seed = 2**31 + 9
    cx = Context(Cell(root, workload), seed, torch.device("cpu"))
    cx.cfg = GroundGridConfig(**cx.params)
    cx.pool = scenes.render_pool(cx.sensor, cx.traffic["scene"], int(cx.traffic["pool_scans"]),
                                 float(cx.traffic["step_m"]), cx.cfg.max_points, seed, "cpu")
    loop = loops.Fleet(cx)
    loop.step = rec = _Recorder()
    loop.keeping = False
    d, s, res = loop.schedule.drive_scans, loop.schedule.pool, cx.cfg.resolution
    ticks = 2 * d + 2
    for t in range(ticks):
        loop._unit(t, *divmod(t, d))
    pool = cx.pool
    for t, blocks in enumerate(rec.ticks):
        drive, pos = divmod(t, d)
        offsets = loop.schedule.offsets(drive)
        vehicles = [v for b, _ in loop.blocks for v in range(4)[b]]
        got = {name: torch.cat([getattr(b, name) for b in blocks])
               for name in ("px", "py", "pz", "rings", "valid")}
        center = np.concatenate([b.center for b in blocks])
        center_lo = np.concatenate([b.center_lo for b in blocks])
        velo = np.concatenate([b.t_map_velo for b in blocks])
        for v in vehicles:
            u = (2 * v + t) % (2 * s)
            i = u if u < s else 2 * s - 1 - u
            c = pool.counts[i]
            for k, name in enumerate(("px", "py", "pz")):
                assert torch.equal(got[name][v], pool.points[i, :, k])
            assert torch.equal(got["rings"][v], pool.rings[i])
            assert got["valid"][v].sum() == c and bool(got["valid"][v][:c].all())
            first = [(2 * v + drive * d) % (2 * s)]
            first = first[0] if first[0] < s else 2 * s - 1 - first[0]
            c64 = (offsets[v] @ pool.poses[first])[:2, 3]
            for p in range(pos + 1):
                u = (2 * v + drive * d + p) % (2 * s)
                j = u if u < s else 2 * s - 1 - u
                delta = ((offsets[v] @ pool.poses[j])[:2, 3] - c64) / res
                c64 = c64 + np.sign(delta) * np.floor(np.abs(delta) + 0.5) * res
            assert np.array_equal(center[v], c64.astype(np.float32))
            assert np.array_equal(center_lo[v],
                                  (c64 - c64.astype(np.float32).astype(np.float64)).astype(
                                      np.float32))
            assert np.array_equal(velo[v], (offsets[v] @ pool.poses[i]).astype(np.float32))
