"""The harness finds a cell's configuration, traffic mix, limits and
per-layer metrics by name: a cell or a metric is added by adding files and
an entry, and the run's result line keeps the contract's shape."""

import json

import pytest

from portbench.bench import Cell, run_cell
from portbench.tests import tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("workload", ["tinylive.tiny", "tinyfleet.tiny", "tinyreplay.tiny",
                                      "tinyfleet2.tiny", "tinyfleet-sorted.tiny-sorted"])
def test_throwaway_cell_runs_and_reports_its_metrics(tmp_path, workload):
    root = tiny.write(tmp_path)
    result = run_cell(root, workload, 2**31 + 7, 3.0, False, "cpu", log=lambda line: None)
    assert list(result) == KEYS
    assert result["correct"] is True
    assert result["attempted"] > 0 and result["failed"] == 0
    cell = Cell(root, workload)
    assert result["device"]["count"] == cell.cards == cell.workload["chips"]
    want = {m["name"] for m in cell.end_to_end()}
    assert set(result["metrics"]) == want
    assert "setup_s" in want and len(want) >= 2
    for m in result["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    json.dumps(result)


def test_added_metric_is_found_by_name_and_silent_metrics_are_left_out(tmp_path):
    reader = "def read(cx):\n    return 1.5 if cx.window.scans else None\n"
    root = tiny.write(tmp_path, extra_metric=reader)
    result = run_cell(root, "tinylive.tiny", 3, 3.0, True, "cpu", log=lambda line: None)
    assert result["metrics"]["tiny_metric"] == {"value": 1.5, "unit": "ms"}
    # no profile on the CPU: the device-trace readers find nothing and stay out
    assert "device_busy_ms.vehicle" not in result["metrics"]
    assert "dispatch_host_ms.live" in result["metrics"]
    assert list(result)[-1] == "checks"


def test_added_traffic_file_is_a_new_cell(tmp_path):
    root = tiny.write(tmp_path)
    base = root / "portbench"
    mix = json.loads((base / "traffic" / "tinylive.json").read_text())
    mix["drive_scans"] = mix["pool_scans"] = 4
    (base / "traffic" / "tinyshort.json").write_text(json.dumps(mix))
    (base / "checks" / "tinyshort.tiny.json").write_text(json.dumps({"limits": tiny.LIMITS}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tinyshort.tiny", "config": "tiny",
                               "traffic": "tinyshort", "chips": 1, "why": "test"})
    rate = [m for m in bench["end_to_end"] if m["name"] == "scans_per_s.vehicle"][0]
    rate["workloads"].append("tinyshort.tiny")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    result = run_cell(root, "tinyshort.tiny", 11, 3.0, False, "cpu", log=lambda line: None)
    assert result["correct"] is True
    assert set(result["metrics"]) == {"setup_s", "scans_per_s.vehicle"}


def test_same_seed_same_traffic(tmp_path):
    from portbench import scenes
    from portbench.traffic import Schedule, check_positions

    mix = dict(tiny.TRAFFIC, vehicles=4, phase_step=2)
    a = scenes.render_pool(tiny.SENSOR, mix["scene"], 3, 1.0, 4096, 2**31 + 5, "cpu")
    b = scenes.render_pool(tiny.SENSOR, mix["scene"], 3, 1.0, 4096, 2**31 + 5, "cpu")
    c = scenes.render_pool(tiny.SENSOR, mix["scene"], 3, 1.0, 4096, 2**31 + 6, "cpu")
    assert a.counts == b.counts and bool((a.points == b.points).all())
    assert not bool((a.points == c.points).all())
    sa, sb = Schedule(mix, 9, a.poses), Schedule(mix, 9, a.poses)
    assert (sa.drive_poses(3)[1] == sb.drive_poses(3)[1]).all()
    assert not (sa.drive_poses(3)[1] == sa.drive_poses(4)[1]).all()
    assert check_positions(mix, 9) == check_positions(mix, 9)
    # vehicles drive: no vehicle steps the same scan on consecutive ticks
    # except where it turns at the pool's end
    idx = sa.drive_poses(0)[0]
    assert (idx[1:] != idx[:-1]).mean() > 0.5


def test_scene_seed_fixes_the_scene():
    """A traffic file's ``scene.seed`` fixes the scene: two run seeds drive
    the same path past the same boxes, and differ only by range noise."""
    from portbench import scenes

    fixed = dict(tiny.TRAFFIC["scene"], seed=2**31 + 7)
    a = scenes.render_pool(tiny.SENSOR, fixed, 3, 1.0, 4096, 2**31 + 5, "cpu")
    b = scenes.render_pool(tiny.SENSOR, fixed, 3, 1.0, 4096, 2**31 + 6, "cpu")
    assert (a.poses == b.poses).all()
    assert a.counts == b.counts
    n = a.counts[0]
    gap = (a.points[0, :n] - b.points[0, :n]).norm(dim=-1)
    assert 0 < float(gap.max()) < 10 * tiny.SENSOR["range_noise_m"]
    assert bool((a.rings == b.rings).all())
    free = scenes.render_pool(tiny.SENSOR, tiny.TRAFFIC["scene"], 3, 1.0, 4096, 2**31 + 6, "cpu")
    assert not (free.poses == b.poses).all()


def test_a_cell_whose_chips_differ_from_its_cards_is_refused(tmp_path):
    root = tiny.write(tmp_path)
    assert Cell(root, "tinyfleet2.tiny").cards == 2
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        if w["name"] == "tinyfleet2.tiny":
            w["chips"] = 1
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(ValueError, match="2 cards"):
        Cell(root, "tinyfleet2.tiny")
