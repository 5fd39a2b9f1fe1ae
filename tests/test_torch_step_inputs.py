"""The step takes every per-scan value from the scan scalars, and computes
what it did when it took them as host floats.

Before the scan scalars (``core/scalars.py``), the step baked each per-scan
value into its launches as a Python float or int: ``t - float(origin[0])``,
the ds binning constants, ``c + half``, the base plane, ``base_z``, and a
move that rolled by host ints and was skipped for a zero shift. A CUDA graph
would freeze those at their capture values. Those old forms are rebuilt here
as references: the step's body run with every scan scalar read into a host
float or int, and a test-local move that rolls with ``torch.roll`` by the
host's own (unclamped) shift. The device forms must equal them bitwise over
a moving sequence with a still pose, shifts of each sign and a teleport, in
sorted, unsorted-with-center and wire modes, with the aux layers and the
fused detect stencil. Also: the gather-roll against ``torch.roll`` for every
shift around the grid size, K3's plain version with a tensor ``base_z``
against its float form, and the slice against the JAX step.
"""

import numpy as np
import pytest
import torch

from groundgrid_tpu.config import GroundGridConfig as JConfig
from groundgrid_tpu.data.semantickitti import ScanRecord as JRecord
from groundgrid_tpu.runtime.driver import StreamingDriver as JDriver

from groundgrid_torch import GroundGridConfig, ScanRecord, StreamingDriver, state_to_numpy
from groundgrid_torch import pipeline as tpipe
from groundgrid_torch.core import grid as tgrid
from groundgrid_torch.core import scalars as tscalars
from groundgrid_torch.core import transforms
from groundgrid_torch.data.synthetic import synthetic_sequence
from groundgrid_torch.ops import spiral

torch.set_num_threads(1)

# tests/conftest.py's small_config
SMALL = dict(dimension=40.0, resolution=0.5, max_points=16384, ray_steps=40,
             max_outlier_candidates=1024)
AGREE = 0.999  # tests/test_torch_pipeline.py's bar


def tilted(T, roll=0.02, pitch=-0.015):
    """``T`` with its rotation tilted: the base plane's row 2 then has
    nonzero x and y terms, as a vehicle on a slope gives it."""
    cr, sr, cp, sp = np.cos(roll), np.sin(roll), np.cos(pitch), np.sin(pitch)
    out = np.array(T, np.float64)
    out[:3, :3] = out[:3, :3] @ np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]]) @ np.array(
        [[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    return out


def moving_scans():
    """Three forward scans, a still pose (k = 0), a step back and sideways
    (k of each sign) and a teleport (|k| >= n), as (points, labels, pose),
    on tilted poses."""
    scans = [(p, l, tilted(T)) for p, l, T in
             synthetic_sequence(3, seed=7, n_beams=24, n_azimuth=720, step_m=1.5)]
    still = scans[2]
    back = scans[0][2].copy()
    back[0, 3] -= 2.2
    back[1, 3] += 1.7
    far = back.copy()
    far[0, 3] += 300.0
    far[1, 3] -= 250.0
    return scans + [still, (scans[0][0], scans[0][1], back), (scans[1][0], scans[1][1], far)]


def records(scans, cls=ScanRecord):
    return [cls(index=i, timestamp=0.1 * i, points=p, labels=l, t_map_velo=T)
            for i, (p, l, T) in enumerate(scans)]


VIEW = tscalars.view


def float_form(t):
    """The scan scalars as the host floats and ints the step once took."""
    s = VIEW(t)
    return tscalars.ScanScalars(*(float(v) for v in s[:tscalars.N_FLOATS]),
                                velo=[[float(v) for v in row] for row in s.velo],
                                k0=int(s.k0), k1=int(s.k1), count=int(s.count))


def host_move(shifts):
    """The move before the scan scalars: a roll by the host's shift (the
    last one ``shifts`` recorded, unclamped), the exposed cells from host
    ints, skipped for a zero shift."""

    def move(config, ground, groundpatch, s):
        k = shifts[-1]
        if k == (0, 0):
            return ground, groundpatch
        n = config.cell_count
        ground = torch.roll(ground, shifts=k, dims=(0, 1))
        groundpatch = torch.roll(groundpatch, shifts=k, dims=(0, 1))
        idx = torch.arange(n)

        def axis_mask(kk):
            if abs(kk) >= n:
                return torch.ones(n, dtype=torch.bool)
            return idx < kk if kk >= 0 else idx >= n + kk

        exposed = axis_mask(k[0])[:, None] | axis_mask(k[1])[None, :]
        res = float(np.float32(config.resolution))
        half = float(np.float32(config.half_length))
        coord = half - (torch.arange(n, dtype=torch.float32) + 0.5) * res
        px = (s.cx + coord[:, None]).expand(n, n)
        py = (s.cy + coord[None, :]).expand(n, n)
        z_base = (s.b20 * px + s.b21 * py) + s.b23
        ground = torch.where(exposed, -z_base, ground)
        groundpatch = torch.where(exposed, torch.zeros_like(groundpatch), groundpatch)
        return ground, groundpatch

    return move


def run(config, recs, with_aux, step=None):
    driver = StreamingDriver(config, "cpu", with_aux=with_aux)
    if step is not None:
        driver.step = step
    out = []
    for rec in recs:
        res = driver.process(rec)
        out.append((res, state_to_numpy(driver.state)))
    return out


MODES = {
    "sorted": (dict(sorted_scans=True), False),
    "sorted-aux-fused": (dict(sorted_scans=True, fused_detect=True), True),
    "unsorted-aux": (dict(sorted_scans=False), True),
    "wire-aux-fused": (dict(sorted_scans=True, wire_format=True, fused_detect=True), True),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_step_matches_host_float_forms(mode, monkeypatch):
    """The driver's step (the captured step's protocol on the CPU) against
    the eager body with host-float scan scalars and the host-int roll."""
    change, with_aux = MODES[mode]
    config = GroundGridConfig(**SMALL, **change)
    recs = records(moving_scans())
    got = run(config, recs, with_aux)
    assert isinstance(StreamingDriver(config, "cpu").step, tpipe.CapturedStep)

    shifts = []
    shift_cells = tgrid.shift_cells

    def recorded(*args):
        shifts.append(shift_cells(*args))
        return shifts[-1]

    with monkeypatch.context() as m:
        m.setattr(tpipe.gridlib, "shift_cells", recorded)
        m.setattr(tpipe.moveops, "move_plain", host_move(shifts))  # K12's CPU route
        m.setattr(tpipe.scalarlib, "view", float_form)
        want = run(config, recs, with_aux, tpipe.make_step_fn(config, with_aux))

    n = config.cell_count
    assert (0, 0) in shifts and any(max(abs(k0), abs(k1)) >= n for k0, k1 in shifts)
    for axis in (0, 1):
        assert any(k[axis] > 0 for k in shifts) and any(k[axis] < 0 for k in shifts), shifts
    for (a, sa), (b, sb) in zip(got, want):
        np.testing.assert_array_equal(a.labels, b.labels)
        np.testing.assert_array_equal(a.outlier, b.outlier)
        for x, y in zip(sa, sb):  # ground, groundpatch, center, center_lo
            np.testing.assert_array_equal(x.view(np.int32), y.view(np.int32))
        if with_aux:
            assert sorted(a.aux) == sorted(b.aux)
            for name in a.aux:
                np.testing.assert_array_equal(a.aux[name], b.aux[name], err_msg=name)
            for k in "xyz":
                np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    assert (got[-1][0].labels == 49).sum() > 1000


def test_roll_cells_is_torch_roll():
    """The gather-roll and the device exposed mask against ``torch.roll`` and
    the host-int mask, for every shift in [-n-2, n+2]^2 on a 5x5 grid."""
    n = 5
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(n, n)).astype(np.float32))
    x[0, 1], x[2, 3] = -0.0, float("nan")
    idx = torch.arange(n)

    def host_axis(kk):
        if abs(kk) >= n:
            return torch.ones(n, dtype=torch.bool)
        return idx < kk if kk >= 0 else idx >= n + kk

    for k0 in range(-n - 2, n + 3):
        for k1 in range(-n - 2, n + 3):
            t0, t1 = torch.tensor(k0, dtype=torch.int32), torch.tensor(k1, dtype=torch.int32)
            got = tgrid.roll_cells(x, t0, t1)
            want = torch.roll(x, shifts=(k0, k1), dims=(0, 1))
            assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (k0, k1)
            mask = host_axis(k0)[:, None] | host_axis(k1)[None, :]
            assert torch.equal(tgrid.exposed_mask(n, t0, t1, "cpu"), mask), (k0, k1)


@pytest.mark.parametrize("base_z", [0.37, -1.7312345, 123.456789, 1e-7])
def test_plain_spiral_tensor_base_z_is_its_float_form(base_z):
    """K3's plain version seeds the same f32 from a 0-dim tensor as from a
    host float, and walks to the same layers."""
    cfg = GroundGridConfig(dimension=16.0, resolution=0.5)
    n = cfg.cell_count
    rng = np.random.default_rng(3)
    g = rng.normal(0, 0.5, (n, n)).astype(np.float32)
    c = np.where(rng.random((n, n)) < 0.4, rng.uniform(0, 1, (n, n)), 0).astype(np.float32)
    want = spiral.spiral_interpolation_plain(cfg, torch.from_numpy(g.copy()),
                                             torch.from_numpy(c.copy()), base_z)
    tz = torch.tensor(np.float32(base_z))
    got = spiral.spiral_interpolation_plain(cfg, torch.from_numpy(g.copy()),
                                            torch.from_numpy(c.copy()), tz)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert float(got[0][cfg.center_cell, cfg.center_cell]) == float(np.float32(base_z))


def test_packed_scalars_are_the_host_values():
    """Each packed field is the value the step once computed on the host."""
    config = GroundGridConfig(**SMALL)
    pts, _, T = moving_scans()[1]
    mv, mb, bm = transforms.scan_poses(T)
    assert bm[2, 0] != 0 and bm[2, 1] != 0 and bm[2, 0] != bm[2, 1]
    center = np.float32([1234.5, -987.25])
    lo = np.float32([1e-5, -2e-6])
    s = tscalars.host(config, center, lo, mv, mb, bm, k=(3, -500), count=77)
    half = np.float32(config.half_length)
    assert [float(v) for v in (s.ox, s.oy, s.oz)] == [float(v) for v in mv[:3, 3]]
    assert float(s.base_z) == float(mb[2, 3])
    assert (float(s.cxh), float(s.cyh)) == (float(center[0] + half), float(center[1] + half))
    assert (float(s.cx), float(s.cy)) == (float(center[0]), float(center[1]))
    assert [float(v) for v in (s.b20, s.b21, s.b23)] == [float(bm[2, 0]), float(bm[2, 1]),
                                                        float(bm[2, 3])]
    consts = tscalars.binning_constants(config, center, lo)
    assert [float(v) for v in (s.sh0, s.sl0, s.sh1, s.sl1)] == [float(v) for v in consts]
    np.testing.assert_array_equal(s.velo.numpy(), mv[:3])
    # |k| >= n exposes every cell: the shift is clamped to n, int32-safe
    assert (int(s.k0), int(s.k1), int(s.count)) == (3, -config.cell_count, 77)


def test_slice_matches_jax():
    """The moving sequence through the port's driver (the captured step's
    protocol) and the JAX driver, sorted mode: centers bitwise, outliers
    bitwise, labels >= 99.9 %, ground within 1e-4 on >= 99.9 % of cells
    (``tests/test_torch_pipeline.py``'s bars)."""
    kw = dict(SMALL, sorted_scans=True)
    jdriver = JDriver(JConfig(**kw))
    scans = moving_scans()
    got = run(GroundGridConfig(**kw), records(scans), False)
    total = mism = 0
    for rec, (res, state) in zip(records(scans, JRecord), got):
        jres = jdriver.process(rec)
        jstate = [np.asarray(a) for a in jdriver.state]
        np.testing.assert_array_equal(state[2], jstate[2])
        np.testing.assert_array_equal(state[3], jstate[3])
        np.testing.assert_array_equal(res.outlier, jres.outlier)
        close = np.abs(state[0] - jstate[0]) <= 1e-4
        assert close.mean() >= AGREE, f"ground: {int((~close).sum())} cells beyond 1e-4"
        mism += int((res.labels != jres.labels).sum())
        total += res.labels.size
    assert 1 - mism / total >= AGREE, f"{mism} of {total} labels differ"


def test_wire_valid_prefix_comes_from_the_device_count():
    """``dequantize`` marks the first ``count`` points valid, read from the
    scan scalars, for counts at 0, inside and at the buffer's end."""
    config = GroundGridConfig(**SMALL, sorted_scans=True, wire_format=True)
    p = 64
    q = torch.zeros(p, dtype=torch.int16)
    for count in (0, 17, p):
        s = tscalars.host(config, np.zeros(2, np.float32), None, np.eye(4, dtype=np.float32),
                          count=count)
        *_, valid = tpipe.dequantize(config, q, q, q, q, s)
        assert valid.dtype == torch.int32 and int(valid.sum()) == count
        assert bool(valid[:count].all())
