"""The port's fleet driver against per-vehicle streaming and the JAX fleet.

Eight vehicles, each on its own synthetic stream, on an 8-entry CPU mesh
(``["cpu"] * 8``, the counterpart of the JAX tests' 8 virtual CPU devices):
the port's ``FleetDriver`` equals 8 of the port's ``StreamingDriver`` s
bitwise, sorted and unsorted and at the half-cell snap tie, and agrees with
the JAX ``FleetDriver`` on its 8-device mesh on >= 99.9 % of labels, the bar
``tests/test_torch_pipeline.py`` holds the step to. The unsorted fleet
steps each device's block as one batch: the ``unsorted-16`` case runs 16
vehicles on ``["cpu"] * 2`` (8 a block) against the JAX ``FleetDriver(
batch=16)``, 2 vehicles a device of its ``jax.vmap`` branch.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from groundgrid_tpu.config import GroundGridConfig as JConfig
from groundgrid_tpu.data.semantickitti import ScanRecord as JRecord
from groundgrid_tpu.runtime.fleet import FleetDriver as JFleetDriver

from groundgrid_torch import FleetDriver, GroundGridConfig, ScanRecord, StreamingDriver
from groundgrid_torch.core import transforms as tf
from groundgrid_torch.data.synthetic import synthetic_sequence
from groundgrid_torch.golden import GoldenGroundGrid
from groundgrid_torch.parallel.sharding import make_fleet_step
from groundgrid_torch.runtime import bench

torch.set_num_threads(1)

AGREE = 0.999
N_VEHICLES = 8
MESH = ["cpu"] * N_VEHICLES
# tests/test_runtime.py's tiny_config
TINY = dict(dimension=24.0, resolution=0.5, max_points=4096, ray_steps=28,
            max_outlier_candidates=256)


def _sequences(seed0, cls=ScanRecord, n_scans=2, n_vehicles=N_VEHICLES):
    """One 2-scan synthetic stream per vehicle (seed ``seed0 + v``), as the
    JAX fleet tests build them."""
    sequences = []
    for v in range(n_vehicles):
        recs = []
        for k, (pts, lbl, T) in enumerate(
                synthetic_sequence(n_scans, seed=seed0 + v, n_beams=8, n_azimuth=128)):
            recs.append(cls(index=k, timestamp=0.1 * k,
                            points=np.concatenate([pts, np.zeros((len(pts), 1), np.float32)], 1),
                            labels=lbl, t_map_velo=T))
        sequences.append(recs)
    return sequences


@pytest.fixture(scope="module", params=[(True, N_VEHICLES, MESH), (False, N_VEHICLES, MESH),
                                        (False, 16, ["cpu"] * 2)],
                ids=["sorted", "unsorted", "unsorted-16"])
def fleet_run(request):
    """Both fleets and the per-vehicle streaming runs over the same streams:
    ``batch`` vehicles on the port's ``mesh``, on the JAX package's 8
    devices."""
    sorted_scans, batch, mesh = request.param
    cfg = GroundGridConfig(**TINY, sorted_scans=sorted_scans)
    seed0 = 40 if sorted_scans else 20
    sequences = _sequences(seed0, n_vehicles=batch)
    fleet = FleetDriver(cfg, batch=batch, mesh=mesh)
    ticks = list(fleet.run(sequences))
    streams = []
    for recs in sequences:
        driver = StreamingDriver(cfg, device="cpu")
        streams.append([driver.process(r) for r in recs])
    jfleet = JFleetDriver(JConfig(**TINY, sorted_scans=sorted_scans), batch=batch)
    jticks = list(jfleet.run(_sequences(seed0, JRecord, n_vehicles=batch)))
    return fleet, ticks, streams, jticks


def test_fleet_matches_streaming(fleet_run):
    """The fleet equals one StreamingDriver per vehicle, bitwise; the summary
    counts the fleet's own labels."""
    fleet, ticks, streams, _ = fleet_run
    assert len(ticks) == 2
    assert fleet.step.batched == (not fleet.config.sorted_scans)
    for k, tick in enumerate(ticks):
        assert tick.labels.shape == (fleet.batch, fleet.config.max_points)
        for v in range(fleet.batch):
            res = streams[v][k]
            assert tick.n_points[v] == res.n_points
            np.testing.assert_array_equal(tick.labels[v][:res.n_points], res.labels)
            np.testing.assert_array_equal(tick.outlier[v][:res.n_points] > 0, res.outlier)
        assert tick.ground_points == int((tick.labels == 49).sum()) > 0
        assert tick.nonground_points == int((tick.labels == 99).sum()) > 0
        assert tick.outliers == int(tick.outlier.sum())
    assert fleet.step.fallbacks == 0


def test_fleet_matches_jax(fleet_run):
    """The port's fleet against the JAX FleetDriver on its 8-device mesh."""
    fleet, ticks, _, jticks = fleet_run
    assert len(jax.devices()) == N_VEHICLES and len(jticks) == len(ticks)
    assert fleet.states[0].ground.shape[0] == fleet.batch // len(fleet.mesh)
    total = mism = 0
    for tick, jtick in zip(ticks, jticks):
        assert jtick.labels.shape == tick.labels.shape
        mism += int((tick.labels != jtick.labels).sum())
        total += int((jtick.labels != 0).sum())
    assert total > 10000
    assert 1 - mism / total >= AGREE, f"{mism} of {total} labels differ"


def test_fleet_halfcell_tie_matches_streaming():
    """Fleet vehicles at the half-cell snap tie == streaming, bitwise, with
    each vehicle's f64 tracker equal to golden's center recurrence
    (``tests/test_runtime.py``'s case: every vehicle steps half a cell per
    scan from x = 100 + v)."""
    cfg = GroundGridConfig(**dict(TINY, resolution=0.33))
    half = np.float64(cfg.resolution) / 2.0
    rng = np.random.default_rng(9)
    sequences = []
    for v in range(N_VEHICLES):
        pts = np.concatenate(
            [rng.uniform(-8, 8, (256, 2)), rng.uniform(-1.6, -1.4, (256, 1)),
             np.zeros((256, 1))], axis=1,
        ).astype(np.float32)
        lbl = np.full(256, 40, np.int32)
        recs = []
        x = np.float64(100.0 + v)
        for k in range(6):
            T = np.eye(4, dtype=np.float64)
            T[0, 3] = x
            T[2, 3] = 1.7
            recs.append(ScanRecord(index=k, timestamp=0.1 * k, points=pts, labels=lbl,
                                   t_map_velo=T))
            x = x + half
        sequences.append(recs)

    fleet = FleetDriver(cfg, batch=N_VEHICLES, mesh=MESH)
    ticks = list(fleet.run(sequences))
    assert len(ticks) == 6
    for v in range(N_VEHICLES):
        driver = StreamingDriver(cfg, device="cpu")
        golden = GoldenGroundGrid(cfg)
        for k, rec in enumerate(sequences[v]):
            res = driver.process(rec)
            _, _, bm = tf.scan_poses(rec.t_map_velo)
            golden.update_odom(rec.t_map_velo, np.asarray(bm, np.float64))
            np.testing.assert_array_equal(
                ticks[k].labels[v][:res.n_points], res.labels,
                err_msg=f"vehicle {v} scan {k}: fleet != streaming at the tie")
        np.testing.assert_array_equal(fleet._trackers[v].center64, golden.state.center,
                                      err_msg=f"vehicle {v}: fleet tracker lost the f64 tie")


def test_bench_fleet_smoke():
    """The fleet bench's inputs and step at a small size on the CPU (the
    bench itself gives no CPU number: ``run_benchmark`` raises there)."""
    cfg = GroundGridConfig(resolution=0.5, dimension=40.0, max_points=4096, sorted_scans=True)
    records = bench.synthetic_records(cfg, 4, n_beams=8, n_azimuth=128)
    mesh, states, scans = bench.fleet_inputs(cfg, records, 6, "cpu")
    fleet = make_fleet_step(cfg, mesh)
    for _ in range(2):
        states, outs, summary = fleet(states, scans)
    (out,) = outs
    assert out.labels.shape == (6, cfg.max_points)
    # vehicles 0 and 4 step the same scan from the same start
    np.testing.assert_array_equal(out.labels[0].numpy(), out.labels[4].numpy())
    assert not torch.equal(out.labels[0], out.labels[1])
    assert int(summary.ground_points) == int((out.labels == 49).sum()) > 0
    with pytest.raises(RuntimeError, match="a CUDA device is required"):
        bench.run_benchmark(n_scans=4, batch=2, resolution=0.5, dimension=40.0, warmup=1,
                            n_beams=8, n_azimuth=128, max_points=4096, device="cpu")


def test_fleet_driver_requires_explicit_device(monkeypatch):
    """No device, or both a device and a mesh, raise; so does a batch the
    mesh cannot split, and a card when none is present."""
    cfg = GroundGridConfig(**TINY)
    with pytest.raises(TypeError, match="explicit device"):
        FleetDriver(cfg, batch=N_VEHICLES, device=None)
    with pytest.raises(TypeError, match="explicit device"):
        FleetDriver(cfg, batch=N_VEHICLES, device="cpu", mesh=MESH)
    with pytest.raises(ValueError, match="not divisible"):
        FleetDriver(cfg, batch=6, mesh=["cpu"] * 4)
    with pytest.raises(ValueError, match="wire_format"):
        FleetDriver(dataclasses.replace(cfg, sorted_scans=True, wire_format=True), batch=2,
                    device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FleetDriver(cfg, batch=N_VEHICLES, device="cuda")
