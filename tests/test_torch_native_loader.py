"""The port's binding of the native threaded scan loader (``native/loader.cpp``).

Mirrors ``tests/test_native_loader.py`` on the CPU: the sorted and wire
loaders' scans are bitwise the port's ``prepare_scan`` / ``prepare_scan_wire``
against the driver's center track; seeking and truncation; the driver over
``PreparedRecord``s labels as over raw records; the pipelined driver is
bitwise the lock-step one, aux layers included, and drops a non-finite pose.
Skips when the library cannot be built (no C++ toolchain); the NumPy
fallback is checked either way.
"""

import dataclasses

import numpy as np
import pytest
import torch

from groundgrid_torch.config import GroundGridConfig
from groundgrid_torch.core.grid import state_to_numpy
from groundgrid_torch.data import native_loader as nl
from groundgrid_torch.data.semantickitti import SemanticKITTI, write_sequence
from groundgrid_torch.data.synthetic import synthetic_sequence
from groundgrid_torch.pipeline import CenterTracker, prepare_scan, prepare_scan_wire
from groundgrid_torch.runtime.driver import StreamingDriver

CPU = torch.device("cpu")
CFG = GroundGridConfig(dimension=24.0, resolution=0.5, max_points=4096, ray_steps=28,
                       max_outlier_candidates=256, sorted_scans=True)
WIRE = dataclasses.replace(CFG, wire_format=True)
SCAN_FIELDS = {False: ("px", "py", "pz", "rings", "valid"), True: ("qx", "qy", "qz", "rings")}


@pytest.fixture(scope="module")
def native():
    if nl.load_library() is None:
        pytest.skip("native loader not built (no C++ toolchain?)")


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    """Five scans, the last beyond ``max_points`` (overflow)."""
    root = tmp_path_factory.mktemp("torch_native_loader")
    scans = list(synthetic_sequence(4, seed=13, n_beams=12, n_azimuth=300, step_m=1.3))
    big = synthetic_sequence(5, seed=13, n_beams=16, n_azimuth=400, step_m=1.3)
    scans.append(list(big)[-1])
    assert scans[-1][0].shape[0] > CFG.max_points > scans[0][0].shape[0]
    write_sequence(str(root), 0, scans)
    return SemanticKITTI(str(root), 0)


@pytest.fixture(scope="module")
def small_ds(tmp_path_factory):
    """Eight tiny random scans of growing size (the JAX test's dataset)."""
    root = tmp_path_factory.mktemp("torch_native_loader_small")
    rng = np.random.default_rng(1)
    scans = []
    for k in range(8):
        pts = rng.normal(size=(200 + 10 * k, 4)).astype(np.float32)
        lbl = (np.uint32(5) << 16) + rng.choice([40, 10, 72], size=200 + 10 * k).astype(np.uint32)
        T = np.eye(4)
        T[0, 3] = float(k)
        scans.append((pts, lbl, T))
    write_sequence(str(root), 0, scans)
    return SemanticKITTI(str(root), 0), scans


def _want(ds, config, start=0, center64=None):
    """prepare_scan(_wire) of every scan from ``start`` on, against the track
    a driver starting there keeps."""
    prep = prepare_scan_wire if config.wire_format else prepare_scan
    tracker = None
    for idx in range(start, len(ds)):
        rec = ds.read_scan(idx)
        pos = np.asarray(rec.t_map_velo, np.float64)[:2, 3]
        if tracker is None:
            tracker = CenterTracker(config, pos if center64 is None else center64)
        center = tracker.update(pos).copy()
        yield rec, center, prep(config, rec.points[:, :3], rec.labels, rec.t_map_velo,
                                center, CPU)


def _assert_same_scans(got, ds, config, start=0, center64=None):
    wants = list(_want(ds, config, start, center64))
    assert [r.index for r in got] == list(range(start, len(ds)))
    for prep_rec, (rec, center, (want, want_order)) in zip(got, wants):
        np.testing.assert_array_equal(prep_rec.order, want_order)
        for f in SCAN_FIELDS[config.wire_format]:
            a, b = getattr(prep_rec.scan, f), getattr(want, f)
            assert a.dtype == b.dtype and a.device == CPU, f
            assert torch.equal(a, b), f
        for f in ("center", "center_lo", "t_map_velo", "t_map_base", "t_base_map"):
            np.testing.assert_array_equal(getattr(prep_rec.scan, f), getattr(want, f), err_msg=f)
        if config.wire_format:
            assert prep_rec.scan.count == want.count
        np.testing.assert_array_equal(prep_rec.center64, center)
        # the scan's own count; overflow ids are unread (0) natively
        n, cap = rec.points.shape[0], config.max_points
        assert prep_rec.n_points == n and prep_rec.timestamp == rec.timestamp
        np.testing.assert_array_equal(prep_rec.labels[:cap], rec.labels[:cap])
        assert prep_rec.labels.shape == (n,) and set(prep_rec.labels[cap:]) <= {0, *rec.labels}


@pytest.mark.parametrize("config", [CFG, WIRE], ids=["sorted", "wire"])
def test_loader_matches_python_prep(native, seq, config):
    kind = nl.WirePrefetchingLoader if config.wire_format else nl.SortedPrefetchingLoader
    loader = kind(seq, config, CPU, n_threads=2, queue_depth=2)
    assert loader.native
    got = list(loader)
    loader.close()
    _assert_same_scans(got, seq, config)


@pytest.mark.parametrize("config", [CFG, WIRE], ids=["sorted", "wire"])
def test_loader_start_and_seed(native, seq, config):
    """``start`` seeds the track at that scan's pose, or at a given center
    (a resumed driver's); seeking before ``start`` raises."""
    kind = nl.WirePrefetchingLoader if config.wire_format else nl.SortedPrefetchingLoader
    loader = kind(seq, config, CPU, start=2, n_threads=2, queue_depth=2)
    _assert_same_scans(list(loader), seq, config, start=2)
    with pytest.raises(ValueError):
        loader.seek(1)
    loader.close()
    seed = seq.poses[0][:2, 3] + np.array([0.3, -0.2])
    loader = kind(seq, config, CPU, start=3, center64=seed)
    _assert_same_scans(list(loader), seq, config, start=3, center64=seed)
    loader.close()


@pytest.mark.parametrize("config", [CFG, WIRE], ids=["sorted", "wire"])
def test_fallback_without_library(seq, config, monkeypatch):
    """Without the library the loaders prepare the same scans in NumPy."""
    monkeypatch.setattr(nl, "load_library", lambda auto_build=True: None)
    kind = nl.WirePrefetchingLoader if config.wire_format else nl.SortedPrefetchingLoader
    loader = kind(seq, config, CPU, start=1)
    assert not loader.native
    _assert_same_scans(list(loader), seq, config, start=1)
    plain = nl.PrefetchingLoader(seq, cap=1000)
    assert not plain.native
    assert [r.points.shape[0] for r in plain] == [min(1000, len(seq.read_scan(k).points))
                                                  for k in range(len(seq))]


def test_wire_loader_needs_wire_config(seq):
    with pytest.raises(ValueError):
        nl.WirePrefetchingLoader(seq, CFG, CPU)
    with pytest.raises(TypeError):
        nl.SortedPrefetchingLoader(seq, CFG, None)


def test_matches_numpy_reader(native, small_ds):
    ds, _ = small_ds
    loader = nl.PrefetchingLoader(ds, cap=512, n_threads=3, queue_depth=4)
    assert loader.native
    got = list(loader)
    loader.close()
    assert [r.index for r in got] == list(range(len(ds)))
    for rec, ref in zip(got, ds.iter_scans()):
        np.testing.assert_array_equal(rec.points, ref.points)
        np.testing.assert_array_equal(rec.labels, ref.labels)  # low 16 bits
        np.testing.assert_array_equal(rec.t_map_velo, ref.t_map_velo)
        assert rec.timestamp == ref.timestamp


def test_seek_semantics(native, small_ds):
    ds, _ = small_ds
    loader = nl.PrefetchingLoader(ds, cap=512, n_threads=2, queue_depth=3)
    it = iter(loader)
    assert next(it).index == 0
    loader.seek(5)
    assert [r.index for r in loader] == [5, 6, 7]
    loader.seek(1)  # backward seek after the end
    assert [r.index for r in loader][:2] == [1, 2]
    loader.close()


def test_truncation_to_cap(native, small_ds):
    ds, scans = small_ds
    loader = nl.PrefetchingLoader(ds, cap=100, n_threads=2, queue_depth=2)
    rec = next(iter(loader))
    assert rec.points.shape == (100, 4)
    np.testing.assert_array_equal(rec.points, scans[0][0][:100])
    loader.close()


def _same_results(a, b, aux=False):
    assert [r.index for r in a] == [r.index for r in b]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.labels, y.labels)
        np.testing.assert_array_equal(x.outlier, y.outlier)
        assert x.n_points == y.n_points
        if aux:
            assert sorted(x.aux) == sorted(y.aux) and len(x.aux) == 11
            for k in x.aux:
                np.testing.assert_array_equal(x.aux[k], y.aux[k], err_msg=k)
            for f in ("x", "y", "z"):
                np.testing.assert_array_equal(getattr(x, f), getattr(y, f), err_msg=f)


@pytest.mark.parametrize("config", [CFG, WIRE], ids=["sorted", "wire"])
def test_driver_over_prepared_records(native, seq, config):
    """Prepared records label as raw ones do, and leave the driver's tracker
    on the same exact center (what a checkpoint stores)."""
    raw = StreamingDriver(config, CPU)
    want = [raw.process(seq.read_scan(k)) for k in range(len(seq))]
    kind = nl.WirePrefetchingLoader if config.wire_format else nl.SortedPrefetchingLoader
    prepped = StreamingDriver(config, CPU)
    loader = kind(seq, config, CPU)
    got = [prepped.process(rec) for rec in loader]
    loader.close()
    _same_results(got, want)
    assert want[-1].n_points > config.max_points and (want[-1].labels[config.max_points:] == 0).all()
    np.testing.assert_array_equal(prepped.center64, raw.center64)
    assert prepped.step.fallbacks == raw.step.fallbacks == 0


@pytest.mark.parametrize("prepared", [False, True], ids=["raw", "prepared"])
def test_pipelined_run_bitwise(native, seq, prepared):
    """run(pipeline_depth=0, 1, 3): bitwise equal results, aux layers
    included, in order; the timing stats record the depth."""
    def records():
        if not prepared:
            return (seq.read_scan(k) for k in range(len(seq)))
        return iter(nl.SortedPrefetchingLoader(seq, CFG, CPU))

    runs = {}
    for depth in (0, 1, 3):
        driver = StreamingDriver(CFG, CPU, with_aux=True)
        seen = []
        runs[depth] = list(driver.run(records(), callback=seen.append, pipeline_depth=depth))
        assert [r.index for r in seen] == [r.index for r in runs[depth]]
        assert driver.stats.scans == len(seq) and driver.stats.pipeline_depth == depth
    _same_results(runs[1], runs[0], aux=True)
    _same_results(runs[3], runs[0], aux=True)


def test_pipelined_run_drops_non_finite_pose(seq):
    recs = [seq.read_scan(k) for k in range(len(seq))]
    recs[2] = dataclasses.replace(recs[2], t_map_velo=np.full((4, 4), np.nan))
    want = list(StreamingDriver(CFG, CPU).run(recs))
    got = list(StreamingDriver(CFG, CPU).run(recs, pipeline_depth=2))
    assert [r.index for r in got] == [0, 1, 3, 4]
    _same_results(got, want)


def test_stale_pose_reuse_never_patches_prepared(seq):
    """Under ``stale_pose_reuse`` a raw record with a non-finite pose runs
    with the last good pose; a prepared one (binned against its own pose)
    is dropped."""
    cfg = dataclasses.replace(CFG, stale_pose_reuse=True)
    loader = nl.SortedPrefetchingLoader(seq, cfg, CPU)
    prepped = list(loader)
    loader.close()
    nan = np.full((4, 4), np.nan)
    raw = [seq.read_scan(k) for k in range(3)]
    raw[2] = dataclasses.replace(raw[2], t_map_velo=nan)
    assert [r.index for r in StreamingDriver(cfg, CPU).run(raw)] == [0, 1, 2]
    prepped[2] = dataclasses.replace(prepped[2], t_map_velo=nan)
    assert [r.index for r in StreamingDriver(cfg, CPU).run(prepped[:3])] == [0, 1]


def test_reconfigure_keeps_compatible_state(seq):
    """A new runtime parameter keeps the grid state; a new geometry drops it."""
    driver = StreamingDriver(CFG, CPU)
    for k in range(2):
        driver.process(seq.read_scan(k))
    state = state_to_numpy(driver.state)
    driver.reconfigure(dataclasses.replace(CFG, minimum_point_height_obstacle_threshold=0.4))
    # kept: copied into the new step's own layers, values and center unchanged
    for kept, before in zip(state_to_numpy(driver.state), state):
        np.testing.assert_array_equal(kept, before)
    assert driver.config.minimum_point_height_obstacle_threshold == 0.4
    assert driver.process(seq.read_scan(2)) is not None
    driver.reconfigure(dataclasses.replace(CFG, dimension=20.0))
    assert driver.state is None and driver.center64 is None
    assert driver.process(seq.read_scan(3)).labels.shape == (seq.read_scan(3).points.shape[0],)
