"""Unsorted mode (``sorted_scans=False``, the config default) against the JAX
package's default step.

The port transforms raw scans on the device, bins against the shipped center
or the device center recurrence (``grid.index_shift_ds``), and stable-sorts
the cell ids before K1, where the JAX step scatters. Held to the JAX package:

* the transform and the recurrence bitwise against eager JAX (jitted,
  XLA:CPU contracts ``a*x + b*y`` into FMAs);
* on one scan, cell ids bitwise, and the sort-and-K1 raster against the JAX
  scatter rasterizer at the bars of ``tests/test_pallas_raster.py``: min and
  max layers bitwise, the others within rtol / atol 1e-4;
* over a moving sequence against the jitted JAX default step, both through
  ``pad_scan`` (center None) and through the drivers (shipped f64 center):
  centers bitwise, labels and outliers on >= 99.9 % of points, ground within
  1e-4 on >= 99.9 % of cells, coordinates within 4 ulps of the scan's
  largest (XLA's FMAs);
* two port runs bitwise, and a checkpoint resumed bitwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from groundgrid_tpu import pipeline as jpipe
from groundgrid_tpu.config import GroundGridConfig as JConfig
from groundgrid_tpu.core import grid as jgrid
from groundgrid_tpu.core import rasterize as jraster
from groundgrid_tpu.core import transforms as jtf
from groundgrid_tpu.data.semantickitti import ScanRecord as JRecord
from groundgrid_tpu.data.synthetic import synthetic_sequence
from groundgrid_tpu.runtime.driver import StreamingDriver as JDriver

from groundgrid_torch import GroundGridConfig as TConfig
from groundgrid_torch import ScanRecord, StreamingDriver, state_to_numpy
from groundgrid_torch import pipeline as tpipe
from groundgrid_torch.core import grid as tgrid
from groundgrid_torch.core import rasterize as traster
from groundgrid_torch.core import scalars as tscalars
from groundgrid_torch.core import transforms as ttf
from groundgrid_torch.ops import raster
from groundgrid_torch.runtime.checkpoint import load_state, save_state

# the test workers share the CPU: torch's intra-op thread pools would
# oversubscribe it and stall on the many small ops of the plain versions
torch.set_num_threads(1)

AGREE = 0.999
N_SCANS = 5


def _configs(small_config, **change):
    kw = {f: getattr(small_config, f) for f in small_config.__dataclass_fields__}
    kw.update(change)
    assert kw["sorted_scans"] is False
    return JConfig(**kw), TConfig(**kw)


@pytest.fixture(scope="module")
def scans():
    """A moving sequence for the small grid: 1.5 m between scans."""
    return list(synthetic_sequence(N_SCANS, seed=7, n_beams=24, n_azimuth=720, step_m=1.5))


def _records(scans, cls):
    return [cls(index=i, timestamp=0.1 * i, points=p, labels=l, t_map_velo=T)
            for i, (p, l, T) in enumerate(scans)]


def _pose(rng, scale=500.0):
    yaw, pitch = rng.uniform(-3, 3), rng.uniform(-0.2, 0.2)
    cy, sy, cp, sp = np.cos(yaw), np.sin(yaw), np.cos(pitch), np.sin(pitch)
    T = np.eye(4)
    T[:3, :3] = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]]) @ np.array(
        [[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    T[:3, 3] = rng.normal(0, scale, 3)
    return T.astype(np.float32)


def test_transform_points_soa_bitwise():
    rng = np.random.default_rng(0)
    for _ in range(4):
        T = _pose(rng)
        pts = rng.normal(0, 40, (3, 5000)).astype(np.float32)
        with jax.disable_jit():
            want = jtf.transform_points_soa(jnp.asarray(T), *(jnp.asarray(p) for p in pts))
        got = ttf.transform_points_soa(T, *(torch.from_numpy(p) for p in pts))
        on_numpy = ttf.transform_points_soa(T, *pts)
        for a, b, c in zip(want, got, on_numpy):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
            np.testing.assert_array_equal(c, np.asarray(a))


def _shift_cases():
    res = np.float32(0.5)
    return [
        # (resolution, center, center_lo, new position)
        (0.5, [10.0, -3.0], [0.0, 0.0], [11.3, -4.9]),
        (0.5, [10.0, -3.0], [0.0, 0.0], [10.0 + res / 2, -3.0 - res / 2]),  # +-half cell
        (0.5, [10.0, -3.0], [0.0, 0.0], [10.0 + 3 * res / 2, -3.0 - 5 * res / 2]),
        (0.33, [0.0, 0.0], [0.0, 0.0], [0.165, -0.165]),  # half of an inexact cell
        (0.33, [123456.5, -98765.25], [1e-3, -2e-3], [123470.1, -98770.7]),  # far out
        (0.37, [-5000.0, 7000.0], [0.0, 0.0], [-5000.0, 7000.0]),  # no movement
    ]


@pytest.mark.parametrize("case", range(len(_shift_cases())))
def test_index_shift_ds_bitwise(case):
    res, center, lo, pos = _shift_cases()[case]
    kw = dict(dimension=40.0, resolution=res)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    center, lo, pos = (np.asarray(v, np.float32) for v in (center, lo, pos))
    with jax.disable_jit():
        k, nh, nl = jgrid.index_shift_ds(jcfg, jnp.asarray(center), jnp.asarray(lo),
                                         jnp.asarray(pos))
    tk, th, tl = tgrid.index_shift_ds(tcfg, center, lo, pos)
    assert tk == tuple(int(v) for v in np.asarray(k))
    np.testing.assert_array_equal(th.numpy(), np.asarray(nh))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(nl))


def test_index_shift_ds_recurrence_bitwise():
    """Forty chained steps of a drive at 1.37 m, including exact half-cell
    steps, far from the origin: the (hi, lo) center stays bitwise."""
    kw = dict(dimension=40.0, resolution=0.33)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    jc = tc = np.float32([81234.5, -4321.25])
    jl = tl = np.zeros(2, np.float32)
    rng = np.random.default_rng(3)
    for i in range(40):
        step = np.float32(0.165) if i % 7 == 3 else np.float32(1.37)
        pos = (np.asarray(jc, np.float32) + step * rng.choice([-1, 1], 2)).astype(np.float32)
        with jax.disable_jit():
            _, jc, jl = jgrid.index_shift_ds(jcfg, jnp.asarray(jc), jnp.asarray(jl),
                                             jnp.asarray(pos))
        _, tc, tl = tgrid.index_shift_ds(tcfg, tc, tl, pos)
        jc, jl = np.asarray(jc), np.asarray(jl)
        np.testing.assert_array_equal(tc.numpy(), jc)
        np.testing.assert_array_equal(tl.numpy(), jl)


def test_move_without_center_matches_jax(small_config):
    jcfg, tcfg = _configs(small_config)
    rng = np.random.default_rng(1)
    n = jcfg.cell_count
    ground = rng.normal(0, 1, (n, n)).astype(np.float32)
    conf = rng.random((n, n)).astype(np.float32)
    center, lo = np.float32([3.0, -7.5]), np.float32([1e-6, 0.0])
    T = _pose(rng, scale=0.0)
    _, _, t_base_map = ttf.scan_poses(T)
    for pos in ([5.4, -2.2], [3.25, -7.75], [-30.0, 12.0]):
        pos = np.float32(pos)
        with jax.disable_jit():
            want = jgrid.move(jcfg, jgrid.GridState(jnp.asarray(ground), jnp.asarray(conf),
                                                    jnp.asarray(center), jnp.asarray(lo)),
                              jnp.asarray(pos), jnp.asarray(t_base_map))
        k, new_center, new_lo = tgrid.index_shift_ds(tcfg, center, lo, pos)
        s = tscalars.host(tcfg, new_center.numpy(), new_lo.numpy(), T.astype(np.float32),
                          t_map_base=np.eye(4), t_base_map=t_base_map, k=k)
        got = tgrid.move(tcfg, torch.from_numpy(ground), torch.from_numpy(conf), s)
        for a, b in zip((*got, new_center, new_lo), want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_unsorted_scan_bins_and_rasterizes_like_jax(small_config, scans):
    """One raw scan: transform and cell ids bitwise; the port's stable sort
    and K1 (plain version) against the JAX scatter rasterizer."""
    jcfg, tcfg = _configs(small_config)
    pts, labels, T = scans[1]
    scan = tpipe.pad_scan(tcfg, pts, labels, T, "cpu")
    center, lo = np.float32(T[:2, 3]), np.zeros(2, np.float32)
    origin = scan.t_map_velo[:3, 3]
    x, y, z = ttf.transform_points_soa(scan.t_map_velo, scan.px, scan.py, scan.pz)
    with jax.disable_jit():
        jx, jy, jz = jtf.transform_points_soa(
            jnp.asarray(scan.t_map_velo), *(jnp.asarray(t.numpy()) for t in (scan.px, scan.py,
                                                                              scan.pz)))
        jb = jraster.bin_points(jcfg, jnp.asarray(center), jx, jy, jz,
                                jnp.asarray(scan.rings.numpy()),
                                jnp.asarray(scan.valid.numpy() > 0), jnp.asarray(origin),
                                center_lo=jnp.asarray(lo))
    for a, b in ((x, jx), (y, jy), (z, jz)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    s = tscalars.host(tcfg, center, lo, scan.t_map_velo, scan.t_map_base, scan.t_base_map)
    tb = traster.bin_points(tcfg, s, x, y, scan.rings, scan.valid > 0)
    for f in ("gi0", "gi1", "cell", "inmap", "ignored"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(), np.asarray(getattr(jb, f)), f)
    assert not bool((tb.cell[1:] >= tb.cell[:-1]).all())  # raw scans are unsorted

    accept = tb.inmap & ~tb.ignored
    want = jraster.rasterize(jcfg, jb, jz, jnp.asarray(origin), jb.inmap & ~jb.ignored,
                             with_max=True, center=jnp.asarray(center),
                             t_base_map=jnp.asarray(scan.t_base_map))
    order = torch.argsort(tb.cell, stable=True)
    got = traster.rasterize_sorted(tcfg, tb.permute(order), z[order], accept[order], s,
                                   raster.raster_reduce, with_max=True)
    for name in want._fields:
        a, b = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        if name in ("min_ground_height", "max_ground_height"):
            np.testing.assert_array_equal(b, a, err_msg=name)
            continue
        mask = np.isfinite(a) & (np.abs(a) < 1e30)
        np.testing.assert_allclose(b[mask], a[mask], rtol=1e-4, atol=1e-4, err_msg=name)
        np.testing.assert_array_equal(b[~mask], a[~mask], err_msg=name)


def _compare_step_outputs(jstate, jout, tstate, tout, n, totals):
    np.testing.assert_array_equal(tstate.center.numpy(), np.asarray(jstate.center))
    np.testing.assert_array_equal(tstate.center_lo.numpy(), np.asarray(jstate.center_lo))
    la, lb = np.asarray(jout.labels)[:n], tout.labels.numpy()[:n]
    oa, ob = np.asarray(jout.outlier)[:n], tout.outlier.numpy()[:n]
    totals["points"] += n
    totals["labels"] += int((la != lb).sum())
    totals["outliers"] += int((oa != ob).sum())
    for k in "xyz":
        # XLA's FMAs round the transform's products differently: a few ulps
        # of the largest term
        a, b = getattr(tout, k).numpy(), np.asarray(getattr(jout, k))
        assert np.abs(a - b).max() <= 4 * np.spacing(np.abs(b).max()), k
    close = np.abs(tstate.ground.numpy() - np.asarray(jstate.ground)) <= 1e-4
    assert close.mean() >= AGREE, f"ground: {int((~close).sum())} cells beyond 1e-4"


def test_unsorted_step_pad_scan_matches_jax(small_config, scans):
    """``pad_scan`` scans (no center: the center recurrence) through the
    port's eager step, which steps center-less scans, and the jitted JAX
    default step."""
    jcfg, tcfg = _configs(small_config)
    jstep, tstep = jpipe.make_step(jcfg), tpipe.make_step_fn(tcfg)
    T0 = scans[0][2]
    jstate, tstate = jpipe.init_state(jcfg, T0), tpipe.init_state(tcfg, T0, "cpu")
    totals = dict(points=0, labels=0, outliers=0)
    for pts, labels, T in scans:
        jscan, tscan = jpipe.pad_scan(jcfg, pts, labels, T), tpipe.pad_scan(tcfg, pts, labels,
                                                                            T, "cpu")
        assert tscan.center is None
        jstate, jout = jstep(jstate, jscan)
        tstate, tout = tstep(tstate, tscan)
        _compare_step_outputs(jstate, jout, tstate, tout, pts.shape[0], totals)
        # per-point outputs in the scan's own order: the device transform's
        x, y, z = ttf.transform_points_soa(tscan.t_map_velo, tscan.px, tscan.py, tscan.pz)
        for a, b in ((x, tout.x), (y, tout.y), (z, tout.z)):
            np.testing.assert_array_equal(b.numpy(), a.numpy())
    assert totals["labels"] <= (1 - AGREE) * totals["points"], totals
    assert totals["outliers"] <= (1 - AGREE) * totals["points"], totals
    assert tstep.fallbacks == 0


@pytest.fixture(scope="module")
def driver_runs(small_config, scans):
    """JAX and port drivers (default config, with aux layers) over the scans."""
    jcfg, tcfg = _configs(small_config)
    jdriver, tdriver = JDriver(jcfg, with_aux=True), StreamingDriver(tcfg, "cpu", with_aux=True)
    jres, tres, jstates, tstates = [], [], [], []
    for a, b in zip(_records(scans, JRecord), _records(scans, ScanRecord)):
        jres.append(jdriver.process(a))
        jstates.append([np.asarray(v) for v in jdriver.state])
        tres.append(tdriver.process(b))
        tstates.append(state_to_numpy(tdriver.state))
    return tcfg, jres, tres, jstates, tstates


def test_unsorted_driver_matches_jax(driver_runs):
    """Through the drivers: the shipped f64 center, labels in input order,
    and the aux non-ground count, which rides the raster's permutation."""
    _, jres, tres, jstates, tstates = driver_runs
    total = mism = cells = same = 0
    for a, b, sa, sb in zip(jres, tres, jstates, tstates):
        assert b.labels.shape == a.labels.shape and b.labels.dtype == a.labels.dtype
        np.testing.assert_array_equal(sb[2], sa[2])  # center
        np.testing.assert_array_equal(sb[3], sa[3])  # center_lo
        close = np.abs(sb[0] - sa[0]) <= 1e-4
        assert close.mean() >= AGREE, f"ground: {int((~close).sum())} cells beyond 1e-4"
        mism += int((a.labels != b.labels).sum())
        total += a.labels.size
        assert b.aux["points"].sum() == (b.labels == 99).sum()
        same += int((b.aux["points"] == a.aux["points"]).sum())
        cells += b.aux["points"].size
        np.testing.assert_array_equal(b.aux["min_ground_height"] == np.finfo(np.float32).max,
                                      a.aux["min_ground_height"] == np.finfo(np.float32).max)
    assert 1 - mism / total >= AGREE, f"{mism} of {total} labels differ"
    assert same / cells >= AGREE


def test_unsorted_port_runs_bitwise_and_near_sorted(small_config, scans, driver_runs):
    """A second port run is bitwise the first; the sorted mode's labels agree
    on >= 99.9 % of points (the JAX package's sorted-vs-default bar)."""
    tcfg, _, tres, _, tstates = driver_runs
    driver = StreamingDriver(tcfg, "cpu", with_aux=True)
    again = [driver.process(r) for r in _records(scans, ScanRecord)]
    for a, b in zip(tres, again):
        np.testing.assert_array_equal(a.labels, b.labels)
        for k in a.aux:
            np.testing.assert_array_equal(a.aux[k], b.aux[k])
    for a, b in zip(tstates[-1], state_to_numpy(driver.state)):
        np.testing.assert_array_equal(a, b)
    sorted_driver = StreamingDriver(dataclasses.replace(tcfg, sorted_scans=True), "cpu")
    srt = [sorted_driver.process(r) for r in _records(scans, ScanRecord)]
    total = sum(r.labels.size for r in srt)
    mism = sum(int((a.labels != b.labels).sum()) for a, b in zip(tres, srt))
    assert 1 - mism / total >= AGREE, f"{mism} of {total} labels differ"


def test_unsorted_checkpoint_resumes_bitwise(small_config, scans, driver_runs, tmp_path):
    tcfg, _, tres, _, tstates = driver_runs
    first = StreamingDriver(tcfg, "cpu", with_aux=True)
    recs = _records(scans, ScanRecord)
    for r in recs[:2]:
        first.process(r)
    path = str(tmp_path / "unsorted.npz")
    save_state(path, first.state, 2, tcfg, center64=first.center64)
    state, nxt, extra = load_state(path, tcfg, "cpu")
    resumed = StreamingDriver(tcfg, "cpu", with_aux=True)
    resumed.restore(state, extra["center64"])
    for r, want in zip(recs[nxt:], tres[nxt:]):
        got = resumed.process(r)
        np.testing.assert_array_equal(got.labels, want.labels)
        np.testing.assert_array_equal(got.aux["ground"], want.aux["ground"])
    for a, b in zip(tstates[-1], state_to_numpy(resumed.state)):
        np.testing.assert_array_equal(a, b)


def test_unsorted_empty_overflow_and_prepared_records(small_config, scans):
    """An empty scan, one past ``max_points`` (the tail labelled 0, in input
    order) and a dropped pose, as the JAX default driver; a prepared (sorted)
    record is refused."""
    jcfg, tcfg = _configs(small_config)
    pts, labels, T = scans[0]
    big = np.concatenate([pts] * 2)[: tcfg.max_points + 500]
    big_lbl = np.concatenate([labels] * 2)[: tcfg.max_points + 500]
    bad = T.copy()
    bad[0, 3] = np.nan
    jdriver, tdriver = JDriver(jcfg), StreamingDriver(tcfg, "cpu")
    for i, (p, l, pose) in enumerate([(pts[:0], labels[:0], T), (big, big_lbl, T),
                                      (pts, labels, bad)]):
        a = jdriver.process(JRecord(index=i, timestamp=0.0, points=p, labels=l, t_map_velo=pose))
        b = tdriver.process(ScanRecord(index=i, timestamp=0.0, points=p, labels=l,
                                       t_map_velo=pose))
        if a is None:
            assert b is None
            continue
        assert b.labels.shape == (p.shape[0],) == a.labels.shape
        assert (b.labels[tcfg.max_points:] == 0).all()
        assert (a.labels != b.labels).sum() <= (1 - AGREE) * p.shape[0]
    from groundgrid_torch.data.native_loader import PreparedRecord

    scan, order = tpipe.prepare_scan(dataclasses.replace(tcfg, sorted_scans=True), pts, labels,
                                     T, T[:2, 3].astype(np.float64), "cpu")
    rec = PreparedRecord(index=0, timestamp=0.0, scan=scan, order=order, n_points=len(pts),
                         labels=labels, t_map_velo=T, center64=T[:2, 3].astype(np.float64))
    with pytest.raises(ValueError, match="sorted"):
        StreamingDriver(tcfg, "cpu").process(rec)
