"""The layer-publishing wire path of the port against the JAX package's.

The path is ``StreamingDriver(GroundGridConfig(sorted_scans=True,
wire_format=True, fused_detect=True), with_aux=True)``: s16 wire ingest,
the fused detect stencil (K4) and all eleven grid layers. Both drivers run
``small_scans`` (the JAX step on CPU, its fused kernel in interpret mode;
the port's with its plain kernel versions on CPU tensors).

Bounds: labels agree on >= 99.9 % of points and ground on >= 99.9 % of cells
within 1e-4 (the bar of ``tests/test_pallas_raster.py``); ``points_raw``,
``min_ground_height``, ``max_ground_height``, the non-ground count and the
dequantized coordinates bitwise; the other layers within rtol/atol 1e-4, and
groundpatch within 1e-5 (XLA rewrites the detect stage's divisions by
constants into reciprocal products, an ulp off the division the port keeps).
Wire prep and checkpoints are bitwise in both directions.
"""

import dataclasses

import numpy as np
import pytest
import torch

from groundgrid_tpu import pipeline as jpipe
from groundgrid_tpu.config import GroundGridConfig as JConfig
from groundgrid_tpu.data.semantickitti import ScanRecord as JRecord
from groundgrid_tpu.runtime import checkpoint as jckpt
from groundgrid_tpu.runtime.driver import StreamingDriver as JDriver

from groundgrid_torch import GroundGridConfig as TConfig
from groundgrid_torch import ScanRecord, StreamingDriver, load_state, save_state
from groundgrid_torch import pipeline as tpipe
from groundgrid_torch import state_from_numpy, state_to_numpy
from groundgrid_torch.core import classify as tclassify
from groundgrid_torch.core import rasterize as traster
from groundgrid_torch.core import scalars as tscalars
from groundgrid_torch.data.synthetic import synthetic_sequence

torch.set_num_threads(1)

AGREE = 0.999
BITWISE = ("points", "points_raw", "min_ground_height", "max_ground_height")


def _configs(small_config, **change):
    kw = {f: getattr(small_config, f) for f in small_config.__dataclass_fields__}
    kw.update(sorted_scans=True, wire_format=True, fused_detect=True)
    kw.update(change)
    return JConfig(**kw), TConfig(**kw)


def _records(scans, cls):
    return [cls(index=i, timestamp=0.1 * i, points=p, labels=l, t_map_velo=T)
            for i, (p, l, T) in enumerate(scans)]


@pytest.fixture(scope="module")
def runs(small_config, small_scans):
    jcfg, tcfg = _configs(small_config)
    jdriver = JDriver(jcfg, with_aux=True)
    jres = [jdriver.process(r) for r in _records(small_scans, JRecord)]
    tdriver = StreamingDriver(tcfg, "cpu", with_aux=True)
    tres = [tdriver.process(r) for r in _records(small_scans, ScanRecord)]
    return jcfg, tcfg, jres, tres, tdriver


def test_layers_path_matches_jax(runs):
    _, _, jres, tres, tdriver = runs
    total = mism = 0
    for a, b in zip(jres, tres):
        assert b.labels.shape == a.labels.shape
        mism += int((a.labels != b.labels).sum())
        total += a.labels.size
        np.testing.assert_array_equal(b.outlier, a.outlier)
        for axis in "xyz":  # the dequantized map-frame coordinates
            np.testing.assert_array_equal(getattr(b, axis), getattr(a, axis))
        assert sorted(b.aux) == sorted(a.aux) and len(b.aux) == 11
        for name, want in a.aux.items():
            got = b.aux[name]
            assert got.shape == want.shape and got.dtype == np.float32, name
            if name in BITWISE:
                np.testing.assert_array_equal(got, want, err_msg=name)
            elif name == "ground":
                close = np.abs(got - want) <= 1e-4
                assert close.mean() >= AGREE, f"ground: {int((~close).sum())} cells beyond 1e-4"
            elif name == "groundpatch":
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=name)
            else:
                np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4, err_msg=name)
        assert b.aux["points"].sum() == (b.labels == 99).sum() > 0
    assert 1 - mism / total >= AGREE, f"{mism} of {total} labels differ"
    assert tdriver.step.fallbacks == 0


def test_nonground_count_plain_form(runs, small_scans):
    """The step's K1 count equals the scatter form over the sorted scan."""
    _, tcfg, _, tres, _ = runs
    driver = StreamingDriver(tcfg, "cpu", with_aux=True)
    recs = _records(small_scans, ScanRecord)
    driver.process(recs[0])
    scan, _ = driver.make_scan(recs[1])
    deq = tpipe.dequantize_scan(tcfg, scan)
    state, out, aux = driver.step(driver.state, scan)
    s = tscalars.host(tcfg, state.center_np, state.center_lo_np, deq.t_map_velo)
    binning = traster.bin_points(tcfg, s, deq.px, deq.py, deq.rings, deq.valid > 0)
    want = tclassify.nonground_counts(tcfg, binning, out.labels)
    assert torch.equal(aux.points, want)
    np.testing.assert_array_equal(aux.points.numpy(), tres[1].aux["points"])


def test_aux_layers_survive_the_next_step(small_config, small_scans):
    """The spiral writes in place into detect's fresh layers: the aux tensors
    of one scan must not change when the next scan is stepped."""
    _, tcfg = _configs(small_config)
    driver = StreamingDriver(tcfg, "cpu", with_aux=True)
    recs = _records(small_scans, ScanRecord)
    driver.process(recs[0])
    state, _, aux = driver.step(driver.state, driver.make_scan(recs[1])[0])
    kept = [t.clone() for t in aux]
    driver.step(state, driver.make_scan(recs[2])[0])
    for name, a, b in zip(aux._fields, aux, kept):
        assert torch.equal(a, b), name


def _wire_cases(small_scans):
    pts, labels, T = small_scans[1]
    far = pts.copy()
    far[::7, :2] *= 40.0  # beyond the s16 span: clamped, still outside the map
    big = np.concatenate([pts, pts[:4000]])
    big_lbl = np.concatenate([labels, labels[:4000]])
    return [(pts, labels, T), (far, labels, T), (big, big_lbl, T), (pts[:0], labels[:0], T)]


def test_wire_prep_and_dequantize_bitwise(small_config, small_scans):
    jcfg, tcfg = _configs(small_config)
    tracker = jpipe.CenterTracker(jcfg, small_scans[0][2][:2, 3].astype(np.float64))
    center = tracker.update(small_scans[1][2][:2, 3].astype(np.float64))
    for pts, labels, T in _wire_cases(small_scans):
        jw, jorder = jpipe.prepare_scan_wire(jcfg, pts, labels, T, center)
        tw, torder = tpipe.prepare_scan_wire(tcfg, pts, labels, T, center, "cpu")
        np.testing.assert_array_equal(torder, jorder)
        assert tw.count == int(jw.count) == min(pts.shape[0], tcfg.max_points)
        for name in tw._fields:
            if name == "count":
                continue
            a, b = getattr(tw, name), np.asarray(getattr(jw, name))
            a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        ts, js = tpipe.dequantize_scan(tcfg, tw), jpipe.dequantize_scan(jcfg, jw)
        for name in ("px", "py", "pz", "rings", "valid"):
            np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                          np.asarray(getattr(js, name)), err_msg=name)
        # and the host's dequantized coordinates the points were sorted by
        sxy, sz = tpipe.wire_scales(tcfg)
        q = np.stack([tw.qx.numpy(), tw.qy.numpy(), tw.qz.numpy()], 1).astype(np.float32)
        refs = np.array([tw.center[0], tw.center[1], np.float32(T[2, 3])], np.float32)
        dq = q * np.array([sxy, sxy, sz], np.float32) + refs
        np.testing.assert_array_equal(np.stack([ts.px, ts.py, ts.pz], 1), dq)
        cells = tpipe.predict_cells(tcfg, tw.center, ts.px.numpy(), ts.py.numpy(),
                                    ts.valid.numpy(), center_lo=tw.center_lo)
        assert (np.diff(cells) >= 0).all()


def test_make_wire_step(small_config):
    _, tcfg = _configs(small_config, wire_format=False)
    step = tpipe.make_wire_step(tcfg, with_aux=True)
    assert step.config.wire_format and step.with_aux
    with pytest.raises(ValueError):
        tpipe.make_wire_step(dataclasses.replace(tcfg, sorted_scans=False))


def test_checkpoint_across_packages(tmp_path, runs, small_scans):
    """A port checkpoint loads in the JAX package and a JAX one in the port,
    bitwise, with the f64 tracker center."""
    jcfg, tcfg, _, _, tdriver = runs
    path = str(tmp_path / "port.npz")
    save_state(path, tdriver.state, 3, tcfg, extra={"seq": "00"}, center64=tdriver.center64)
    jstate, nxt, extra = jckpt.load_state(path, jcfg)
    assert nxt == 3 and extra["seq"] == "00"
    np.testing.assert_array_equal(extra["center64"], tdriver.center64)
    for a, b in zip(state_to_numpy(tdriver.state), jstate):
        np.testing.assert_array_equal(a, np.asarray(b))

    jdriver = JDriver(jcfg)
    for rec in _records(small_scans[:2], JRecord):
        jdriver.process(rec)
    jpath = str(tmp_path / "jax.npz")
    jckpt.save_state(jpath, jdriver.state, 2, jcfg, center64=jdriver.center64)
    tstate, nxt, extra = load_state(jpath, tcfg, "cpu")
    assert nxt == 2
    np.testing.assert_array_equal(extra["center64"], jdriver.center64)
    for a, b in zip(state_to_numpy(tstate), jdriver.state):
        np.testing.assert_array_equal(a, np.asarray(b))
    with pytest.raises(ValueError, match="checkpoint grid"):
        load_state(jpath, dataclasses.replace(tcfg, resolution=0.25), "cpu")


def test_checkpoint_resume_bitwise(tmp_path, runs, small_scans):
    _, tcfg, _, tres, _ = runs
    recs = _records(small_scans, ScanRecord)
    first = StreamingDriver(tcfg, "cpu", with_aux=True)
    first.process(recs[0])
    path = str(tmp_path / "ckpt.npz")
    save_state(path, first.state, 1, tcfg, center64=first.center64)
    state, nxt, extra = load_state(path, tcfg, "cpu")
    resumed = StreamingDriver(tcfg, "cpu", with_aux=True)
    resumed.restore(state, extra["center64"])
    np.testing.assert_array_equal(resumed.center64, first.center64)
    for rec, want in zip(recs[nxt:], tres[nxt:]):
        got = resumed.process(rec)
        np.testing.assert_array_equal(got.labels, want.labels)
        for name in want.aux:
            np.testing.assert_array_equal(got.aux[name], want.aux[name], err_msg=name)


def test_driver_requires_explicit_device(small_config, monkeypatch):
    _, tcfg = _configs(small_config, wire_format=False, fused_detect=False)
    with pytest.raises(TypeError):
        StreamingDriver(tcfg)
    with pytest.raises(TypeError):
        StreamingDriver(tcfg, None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamingDriver(tcfg, "cuda")


@pytest.fixture(scope="module")
def off_center_scans():
    """Scans 1.2 m apart on 0.33 m cells: the poses sit off the cell centers,
    so the grid center trails odometry by a fraction of a cell."""
    return list(synthetic_sequence(5, seed=3, n_beams=24, n_azimuth=720, step_m=1.2))


@pytest.mark.parametrize("k", [1, 2])
def test_installed_state_resumes_bitwise(off_center_scans, k):
    """A state installed as ``driver.state`` (no tracker, no restore) seeds
    the tracker from its own center, not the next pose."""
    cfg = TConfig(dimension=26.4, resolution=0.33, max_points=16384, ray_steps=40,
                  max_outlier_candidates=1024, sorted_scans=True)
    recs = _records(off_center_scans, ScanRecord)
    whole = StreamingDriver(cfg, "cpu")
    labels, states = [], []
    for rec in recs:
        labels.append(whole.process(rec).labels)
        states.append(state_to_numpy(whole.state))
    c64 = states[k][2].astype(np.float64) + states[k][3].astype(np.float64)
    pose = recs[k + 1].t_map_velo[:2, 3]
    assert (np.abs(c64 - pose) > 1e-3).any()  # the test would catch a pose seed
    resumed = StreamingDriver(cfg, "cpu")
    resumed.state = state_from_numpy(*states[k], device="cpu")
    for i, rec in enumerate(recs[k + 1:], start=k + 1):
        np.testing.assert_array_equal(resumed.process(rec).labels, labels[i])
        ground, conf, center, center_lo = state_to_numpy(resumed.state)
        for a, b in zip((ground, conf, center), states[i][:3]):
            np.testing.assert_array_equal(a, b)
        # the ds pair reconstructs the f64 center to ~2^-48 (a checkpoint's
        # center64 restores it exactly): the tail may move by its last ulp
        np.testing.assert_allclose(center_lo, states[i][3], rtol=0, atol=1e-12)


def test_unsorted_scan_aux_counts(small_config, small_scans):
    """After a sortedness fallback the count reduces the permuted cells and
    labels: the same non-ground count as the sorted scan, bitwise."""
    _, tcfg = _configs(small_config, wire_format=False)
    driver = StreamingDriver(tcfg, "cpu", with_aux=True)
    recs = _records(small_scans, ScanRecord)
    driver.process(recs[0])
    scan, _ = driver.make_scan(recs[1])
    perm = torch.from_numpy(np.random.default_rng(1).permutation(tcfg.max_points))
    shuffled = scan._replace(**{k: getattr(scan, k)[perm]
                                for k in ("px", "py", "pz", "rings", "valid")})
    step = tpipe.make_step(tcfg, with_aux=True)
    start = state_to_numpy(driver.state)
    _, want_out, want = step(state_from_numpy(*start, device="cpu"), scan)
    _, got_out, got = step(state_from_numpy(*start, device="cpu"), shuffled)
    assert step.fallbacks == 1
    assert torch.equal(got.points, want.points) and got.points.sum() > 0
    np.testing.assert_array_equal(got_out.labels.numpy(), want_out.labels.numpy()[perm.numpy()])
