"""The raster stage's plain versions (K9's ``raster_columns_ordered``, K10's
``finish_layers``) against the route they replace, and against the JAX
package.

The route: ``Binning.permute`` and ``take_points`` through the sort's order,
``raster_columns``, the plain K1 and ``finish_partials`` as the step ran
them before K9 and K10 (``_route_finish`` keeps that finish verbatim).
The plain versions must be bitwise it: on sorted scans (no order) and
unsorted ones (the stable ``argsort`` order), on a (B, P) batch against its
rows, on S = 1, 2 and 4 shards, on the seams of ``raster_scenes`` and at
364^2; without the aux layers they read neither the z sum nor the plane
shift. Against the JAX package's ``rasterize_sorted`` (its Pallas kernel in
interpret mode) they hold the JAX raster test's bounds: the points, raw
points, min and max layers bitwise, the other layers within rtol 1e-4 /
atol 1e-4 (the JAX kernel sums in another order), and the m2 layer zero
exactly where the JAX one is. The wrappers of ``ops/raster_stage.py`` on
CPU tensors run the plain versions and launch nothing.
"""

import unittest.mock as mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raster_scenes
from groundgrid_tpu.config import GroundGridConfig as JConfig
from groundgrid_tpu.core import rasterize as jraster
from groundgrid_tpu.ops.pallas_raster import raster_sums

from groundgrid_torch.config import GroundGridConfig
from groundgrid_torch.core import rasterize as rasterlib
from groundgrid_torch.core.rasterize import (ALL_LAYERS, FLT_MAX, FLT_TINY, MAIN_LAYERS,
                                             MIN_SENT, RasterLayers, take_points)
from groundgrid_torch.ops import launch_counts, raster, raster_stage, reset_launch_counts

torch.set_num_threads(1)


def _bitwise(a, b):
    if a.dtype.is_floating_point:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def _route_columns(config, binning, z, outlier, s, order):
    """The step's columns before K9: the permutes, then ``raster_columns``."""
    accept = binning.inmap & ~binning.ignored & ~outlier
    rb, rz, racc = binning, z, accept
    if order is not None:
        rb, rz, racc = binning.permute(order), take_points(z, order), take_points(accept, order)
    cols, _ = rasterlib.raster_columns(config, rb, rz, racc, s)
    return rb.cell, cols


def _route_finish(config, partials, s, with_max=False):
    """``finish_partials`` as it was before K10, verbatim."""
    if len(partials) == 1:
        out = list(partials[0])
    else:
        out = [torch.stack(col) for col in zip(*partials)]
        has = out[0] > 0
        out[5] = torch.where(has, out[5], MIN_SENT).amin(0)
        out[6] = torch.where(has, out[6], -MIN_SENT).amax(0)
        for j in range(5):
            total = out[j][0]
            for part in out[j][1:]:
                total = total + part
            out[j] = total
    raw, zmin, zmax = out[0], out[5], out[6]
    o2 = s.oz
    mins = torch.where((raw > 0) & (zmin < 1e30), zmin - float(np.float32(1e-4)),
                       torch.full_like(raw, FLT_MAX))
    has_spread = (zmin - o2) < (zmax - o2)
    if with_max:
        maxs = torch.where(raw > 0, torch.clamp_min(zmax, FLT_TINY), FLT_TINY)
    else:
        maxs = torch.full_like(raw, FLT_TINY)
    shift = rasterlib._plane_shift_map(config, s, raw.device)
    n = config.cell_count

    def grid(a):
        return a.reshape(*a.shape[:-1], n, n)

    count, sum_pdc = grid(out[1]), grid(out[3])
    zero = torch.zeros_like(count)
    safe = torch.clamp_min(count, 1.0)
    mean_pdc = sum_pdc / safe
    mean_pd = torch.where(count > 0, mean_pdc + grid(shift), zero)
    residue = grid(out[4]) - sum_pdc * mean_pdc
    m2 = torch.where((count > 1.0) & grid(has_spread),
                     torch.clamp_min(residue, float(2.0 ** -80)), zero)
    return RasterLayers(
        points=count, points_raw=grid(raw), ground_candidates=grid(out[2]) / safe,
        plane_dist=mean_pd, mean_variance=mean_pd, m2=m2, min_ground_height=grid(mins),
        max_ground_height=grid(maxs), variance=m2 / (count + FLT_TINY))


def _order(binning, sort):
    return torch.argsort(binning.cell, dim=-1, stable=True) if sort else None


def _shards(config, binning, z, outlier, s, n_shards, columns):
    """S shards' K1 columns: the points cut into S chunks, each read
    through its own stable sort by ``columns``, then the plain K1."""
    n2 = config.cell_count ** 2
    bounds = np.linspace(0, z.shape[-1], n_shards + 1).astype(int)
    parts = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        chunk = rasterlib.Binning(*(t[..., lo:hi] for t in binning))
        cell, cols = columns(config, chunk, z[..., lo:hi], outlier[..., lo:hi], s,
                             _order(chunk, True))
        parts.append(raster.raster_reduce_plain(cell, cols, rasterlib.COLUMN_OPS, n2))
    return parts


def _same_layers(got, want, layers=ALL_LAYERS):
    for name in ALL_LAYERS:
        g = getattr(got, name)
        if name not in layers:
            assert g is None, name
            continue
        w = getattr(want, name)
        assert _bitwise(g, w), (name, int((g != w).sum()))


@pytest.mark.parametrize("sort", [False, True], ids=["sorted-scan", "argsort-order"])
@pytest.mark.parametrize("seed", [0, 1])
def test_columns_match_route(seed, sort):
    cfg, s, b, z, outlier = raster_scenes.seam_inputs((seed,), sort=not sort)
    order = _order(b, sort)
    cell, cols = rasterlib.raster_columns_ordered(cfg, b, z, outlier, s, order)
    want_cell, want_cols = _route_columns(cfg, b, z, outlier, s, order)
    assert _bitwise(cell, want_cell)
    assert len(cols) == len(want_cols) == len(rasterlib.COLUMN_OPS)
    for j, (g, w) in enumerate(zip(cols, want_cols)):
        assert _bitwise(g, w), j
    if not sort:  # of sorted ids the stable sort is the identity
        identity = _order(b, True)
        assert torch.equal(identity, torch.arange(z.shape[-1]))
        again = rasterlib.raster_columns_ordered(cfg, b, z, outlier, s, identity)
        assert all(_bitwise(g, w) for g, w in zip(again[1], cols))


@pytest.mark.parametrize("with_max", [False, True], ids=["no-max", "with-max"])
@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_finish_matches_route(n_shards, with_max):
    cfg, s, b, z, outlier = raster_scenes.seam_inputs((n_shards,))
    parts = _shards(cfg, b, z, outlier, s, n_shards, rasterlib.raster_columns_ordered)
    want = _route_finish(cfg, parts, s, with_max)
    _same_layers(rasterlib.finish_partials(cfg, parts, s, with_max), want)
    if with_max:  # the aux layers come with the max
        _same_layers(rasterlib.finish_layers(cfg, parts, s, aux=True), want)
    _same_layers(rasterlib.finish_layers(cfg, parts, s), want, MAIN_LAYERS)


@pytest.mark.parametrize("n_shards", [1, 4])
def test_finish_main_layers_read_no_aux_input(n_shards):
    """Without the aux layers the finish reads neither the z sum (column 2:
    NaN there changes nothing) nor the plane shift map (never computed)."""
    cfg, s, b, z, outlier = raster_scenes.seam_inputs((n_shards + 20,), p=4096)
    parts = _shards(cfg, b, z, outlier, s, n_shards, rasterlib.raster_columns_ordered)
    want = rasterlib.finish_layers(cfg, parts, s)
    poisoned = [[torch.full_like(c, float("nan")) if j == 2 else c for j, c in enumerate(part)]
                for part in parts]
    with mock.patch.object(rasterlib, "_plane_shift_map", side_effect=AssertionError("read")):
        got = rasterlib.finish_layers(cfg, poisoned, s)
    _same_layers(got, want, MAIN_LAYERS)
    assert not torch.isnan(want.variance).any()


def _stage(cfg, b, z, outlier, s, order, aux=True):
    cell, cols = rasterlib.raster_columns_ordered(cfg, b, z, outlier, s, order)
    part = raster.raster_reduce_plain(cell, cols, rasterlib.COLUMN_OPS, cfg.cell_count ** 2)
    return rasterlib.finish_layers(cfg, [part], s, aux)


@pytest.mark.parametrize("sort", [False, True], ids=["sorted-scan", "argsort-order"])
def test_stage_batch_matches_rows(sort):
    """A (B, P) batch, each row its own scene and scan scalars, bitwise its
    rows run alone."""
    seeds = (3, 4, 5)
    cfg, s, b, z, outlier = raster_scenes.seam_inputs(seeds, p=4096, sort=not sort)
    got = _stage(cfg, b, z, outlier, s, _order(b, sort))
    for v, seed in enumerate(seeds):
        _, s1, b1, z1, o1 = raster_scenes.seam_inputs((seed,), p=4096, sort=not sort)
        assert all(_bitwise(t[v], t1) for t, t1 in zip(b, b1))
        want = _stage(cfg, b1, z1, o1, s1, _order(b1, sort))
        for name in ALL_LAYERS:
            assert _bitwise(getattr(got, name)[v], getattr(want, name)), (seed, name)


@pytest.mark.parametrize("sort", [False, True], ids=["sorted-scan", "argsort-order"])
def test_stage_at_full_grid(sort):
    """The default 364^2 grid: the stage bitwise the route."""
    cfg = GroundGridConfig(max_ring=60)
    _, s, b, z, outlier = raster_scenes.seam_inputs((7,), p=16384, sort=not sort, config=cfg)
    order = _order(b, sort)
    got = _stage(cfg, b, z, outlier, s, order, aux=False)
    cell, cols = _route_columns(cfg, b, z, outlier, s, order)
    part = raster.raster_reduce_plain(cell, cols, rasterlib.COLUMN_OPS, cfg.cell_count ** 2)
    _same_layers(got, _route_finish(cfg, [part], s, True), MAIN_LAYERS)


def test_seams_reach_their_values():
    """The seam scene reaches what it is for: negative residues clamped to
    2^-80, zero m2 for one point and for identical pds, FLT_MAX minima of
    all-ignored cells, FLT_MIN maxima of all-negative cells, the overflow
    id through the columns, and -0.0 z in the z column."""
    cfg, s, b, z, outlier = raster_scenes.seam_inputs((0,))
    n2 = cfg.cell_count ** 2
    order = _order(b, True)
    cell, cols = rasterlib.raster_columns_ordered(cfg, b, z, outlier, s, order)
    part = raster.raster_reduce_plain(cell, cols, rasterlib.COLUMN_OPS, n2)
    layers = rasterlib.finish_layers(cfg, [part], s, True)
    count, raw, m2 = (t.reshape(-1) for t in (layers.points, layers.points_raw, layers.m2))
    residue = part[4] - part[3] * (part[3] / torch.clamp_min(part[1], 1.0))
    assert int(((m2 == 2.0 ** -80) & (residue < 0)).sum()) > 10
    assert int(((count == 1) & (m2 == 0)).sum()) > 10
    assert int(((count > 1) & (m2 == 0)).sum()) > 10  # identical pds
    assert int(((raw > 0) & (count == 0)
                & (layers.min_ground_height.reshape(-1) == FLT_MAX)).sum()) > 10
    maxs = layers.max_ground_height.reshape(-1)
    assert int(((count > 0) & (maxs == np.float32(FLT_TINY))).sum()) > 10
    assert int((cell == n2).sum()) > 10
    negzero = (cols[2] == 0) & torch.signbit(cols[2]) & (cols[1] > 0)
    assert int(negzero.sum()) > 10


def test_wrappers_on_cpu_take_the_plain_versions():
    cfg, s, b, z, outlier = raster_scenes.seam_inputs((2,), p=3000)
    order = _order(b, True)
    reset_launch_counts()
    cell, cols = raster_stage.raster_columns_ordered(cfg, b, z, outlier, s, order)
    want_cell, want_cols = rasterlib.raster_columns_ordered(cfg, b, z, outlier, s, order)
    assert _bitwise(cell, want_cell) and all(_bitwise(g, w) for g, w in zip(cols, want_cols))
    part = raster.raster_reduce(cell, cols, rasterlib.COLUMN_OPS, cfg.cell_count ** 2)
    for aux, layers in ((True, ALL_LAYERS), (False, MAIN_LAYERS)):
        got = raster_stage.finish_layers(cfg, [part], s, aux)
        _same_layers(got, rasterlib.finish_layers(cfg, [part], s, True), layers)
    counts = launch_counts()
    assert counts["raster_columns"] == counts["raster_finish"] == 0


def _jax_layers(jcfg, b, z, accept, poses, with_max):
    center, t_map_velo, t_base_map = poses
    jb = jraster.Binning(*(jnp.asarray(t.numpy()) for t in b))
    with mock.patch("groundgrid_tpu.ops.pallas_raster.raster_sums",
                    lambda *a: raster_sums(*a, interpret=True)):
        return jraster.rasterize_sorted(
            jcfg, jb, jnp.asarray(z.numpy()), jnp.asarray(np.float32(t_map_velo[:3, 3])),
            jnp.asarray(accept.numpy()), with_max=with_max, center=jnp.asarray(center),
            t_base_map=jnp.asarray(np.float32(t_base_map)))


@pytest.mark.parametrize("case", ["seams-sorted", "seams-argsort", "full-grid"])
def test_stage_vs_jax(case):
    """The stage against the JAX package's ``rasterize_sorted`` on the same
    points: the port reads an unsorted scan through its sort's order, the
    JAX kernel takes the points sorted (bounds in the module docstring)."""
    kw = dict(raster_scenes.SEAM_CONFIG, sorted_scans=True)
    p = 6144
    if case == "full-grid":
        kw = dict(max_ring=60, sorted_scans=True)
        p = 10240
    cfg, jcfg = GroundGridConfig(**kw), JConfig(**kw)
    sort = case != "seams-sorted"
    seed = 11
    _, s, b, z, outlier = raster_scenes.seam_inputs((seed,), p=p, sort=not sort, config=cfg)
    poses = raster_scenes.seam_poses(np.random.default_rng(seed))
    order = _order(b, sort)
    got = _stage(cfg, b, z, outlier, s, order)
    accept = b.inmap & ~b.ignored & ~outlier
    if order is not None:
        b, z, accept = b.permute(order), take_points(z, order), take_points(accept, order)
    want = _jax_layers(jcfg, b, z, accept, poses, with_max=True)
    for name in want._fields:
        a, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        if name in ("min_ground_height", "max_ground_height", "points", "points_raw"):
            np.testing.assert_array_equal(a, w, err_msg=name)
        else:
            np.testing.assert_allclose(a, w, rtol=1e-4, atol=1e-4, err_msg=name)
    np.testing.assert_array_equal(got.m2.numpy() == 0, np.asarray(want.m2) == 0)
    assert int((got.m2.numpy() > 0).sum()) > 10


def test_stage_us_counts_nested_ranges():
    """``kernel_timing.stage_us`` counts a device activity in every named
    range whose host span holds its launch: the raster stage and its part
    both hold K9's launch, a launch after the part ends only the stage, a
    launch outside both neither."""
    from types import SimpleNamespace

    from groundgrid_torch.runtime.kernel_timing import stage_us

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

    def event(name, start, end, device=cpu, annotation=False, id_=0):
        return SimpleNamespace(name=name, device_type=device, is_user_annotation=annotation,
                               time_range=SimpleNamespace(start=start, end=end), id=id_)

    events = [event("raster", 0, 100, annotation=True),
              event("raster.columns", 10, 20, annotation=True),
              event("cudaLaunchKernel", 12, 13, id_=1), event("k9", 200, 203, cuda, id_=1),
              event("cudaLaunchKernel", 30, 31, id_=2), event("k1", 210, 215, cuda, id_=2),
              event("cudaLaunchKernel", 150, 151, id_=3), event("k2", 220, 222, cuda, id_=3)]
    prof = SimpleNamespace(events=lambda: events)
    got = stage_us(prof, ("raster", "raster.columns", "detect"))
    assert got == {"raster": (8.0, 2), "raster.columns": (3.0, 1), "detect": (0.0, 0)}
