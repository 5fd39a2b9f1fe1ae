"""K8's wrapper, ``ops.detect_stage.detect_stage``, on the CPU.

On CPU tensors the wrapper takes its plain version, ``core/detect.py``'s
stage, which is what ``chip_smoke.py`` and ``tests/test_torch_cuda.py``
hold the CUDA kernel to on the card (bitwise). Here: the wrapper bitwise
the plain stage on the whole grid, on the spatial step's halo'd row blocks
and on a batch, launching nothing; its argument checks; the step, the
spatial step and the sharded detect choosing it; its launch counter; its
CPU path against the JAX package's stage on a warm scan, within
``test_torch_stages.test_detect_vs_jax``'s bounds (ground 1e-4,
confidence 1e-5); ``tile_plan``, the Python twin of the kernel's split
into blocks and each thread's strip of ``STRIP`` cells; and the tables'
16-byte records the kernel reads.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from groundgrid_tpu.core import detect as jdetect
from groundgrid_tpu.core import rasterize as jraster
from tests.test_torch_stages import _binnings, _t, warm  # noqa: F401

from groundgrid_torch import ops
from groundgrid_torch.config import GroundGridConfig
from groundgrid_torch.core import detect as tdetect
from groundgrid_torch.data.synthetic import detect_layers, detect_seam_layers
from groundgrid_torch.ops import detect as fusedops
from groundgrid_torch.ops import detect_stage as stageops
from groundgrid_torch.ops.detect_stage import (SHARED_BYTES, STRIP, THREADS, TILE_H, TILE_W,
                                               detect_stage, tile_plan)
from groundgrid_torch.parallel import spatial
from groundgrid_torch.pipeline import Step

torch.set_num_threads(1)

GEOMETRIES = {12: (6.0, 0.5), 44: (22.0, 0.5), 45: (16.65, 0.37), 80: (40.0, 0.5)}


def _config(n, **kw):
    dim, res = GEOMETRIES[n]
    return GroundGridConfig(dimension=dim, resolution=res, max_points=1024, ray_steps=20,
                            max_outlier_candidates=256, **kw)


def _layers(n, seed, variant):
    """``detect_layers``; "dense": points x10 (the 12-cell grid passes no
    skip threshold at the default density); "quiet": variance x0.01 (the
    main update fires); "seam": ``detect_seam_layers``."""
    if variant == "seam":
        arrs = detect_seam_layers(n, seed)
    else:
        arrs = list(detect_layers(n, seed))
        if variant == "dense":
            arrs[0] = arrs[0] * np.float32(10.0)
        if variant == "quiet":
            arrs[1] = arrs[1] * np.float32(0.01)
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def _bitwise(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


CASES = [(n, v) for n in GEOMETRIES for v in ("random", "dense", "quiet")] + [
    (n, "seam") for n in (44, 45, 80)]


@pytest.mark.parametrize("n,variant", CASES)
def test_cpu_path_is_the_plain_stage(n, variant):
    cfg = _config(n)
    tabs = tdetect.make_tables(cfg, "cpu")
    before = ops.counter_values()
    for seed in range(2):
        layers = _layers(n, seed, variant)
        got = detect_stage(cfg, tabs, *layers)
        want = tdetect.detect_ground_patches(cfg, tabs, *layers)
        assert all(_bitwise(g, w) for g, w in zip(got, want))
        assert all(g is not t for g, t in zip(got, layers[3:]))  # fresh outputs
    assert ops.counter_values() == before  # no kernel launch on the CPU


def test_seam_layers_reach_the_seams():
    """The seam layers' bands do what ``detect_seam_layers`` says: signed
    zeros taken by the local-min branch, -0.0 from the main update, NaN
    windows kept, ties of the ladder met."""
    n = 80
    cfg = _config(n)
    tabs = tdetect.make_tables(cfg, "cpu")
    p, v, m, g, c = _layers(n, 0, "seam")
    out_g, out_c = detect_stage(cfg, tabs, p, v, m, g, c)
    band = torch.clamp(torch.arange(n) * 5 // n, max=4).expand(n, n)
    interior = tabs.interior
    took = out_c != c
    assert (took & (out_g == 0) & (band == 0)).any()  # the local-min branch took a zero
    assert (took & (out_g == 0) & out_g.signbit() & (band == 1)).any()  # -0.0, main update
    assert (interior & (band == 2) & torch.isnan(m)).any()
    assert (interior & (band == 3) & (c == 0.5)).any()
    assert (interior & (band == 3) & (v == 0) & (p > 0)).any()
    # a window count at its skip threshold: the `>=` tie
    box3 = tdetect._box(p, 3)
    box5 = tdetect._box(p, 5)
    psum = torch.where(tabs.use3, box3, box5)
    assert (interior & (psum == tabs.skip_thr)).any()
    # ground equal to its window's minimum: the `<` tie
    lmin = torch.where(tabs.use3, tdetect._minpool(m, 3), tdetect._minpool(m, 5))
    assert (interior & (band == 3) & (lmin == g)).any()


@pytest.mark.parametrize("n,shards", [(44, 2), (44, 4), (80, 2), (80, 4)])
@pytest.mark.parametrize("variant", ["quiet", "seam"])
def test_halo_blocks_are_detect_block_and_the_full_sweep(n, shards, variant):
    cfg = _config(n)
    tabs = tdetect.make_tables(cfg, "cpu")
    layers = _layers(n, 3, variant)
    full = tdetect.detect_ground_patches(cfg, tabs, *layers)
    rows = n // shards
    blocks = []
    for s in range(shards):
        at = slice(s * rows, (s + 1) * rows)
        halos = [torch.nn.functional.pad(t, (0, 0, 2, 2))[at.start:at.stop + 4]
                 for t in layers[:3]]
        rt = tdetect.row_tables(tabs, at)
        got = detect_stage(cfg, rt, *halos, layers[3][at], layers[4][at], halo=2)
        want = tdetect.detect_block(cfg, rt, *halos, layers[3][at], layers[4][at])
        assert all(_bitwise(g, w) for g, w in zip(got, want))
        blocks.append(got)
    for i in range(2):
        assert _bitwise(torch.cat([b[i] for b in blocks]), full[i])


def test_batch_is_its_single_calls():
    n = 45
    cfg = _config(n)
    tabs = tdetect.make_tables(cfg, "cpu")
    grids = [_layers(n, seed, "quiet") for seed in range(3)]
    batch = [torch.stack([g[j] for g in grids]) for j in range(5)]
    got = detect_stage(cfg, tabs, *batch)
    for k, layers in enumerate(grids):
        single = detect_stage(cfg, tabs, *layers)
        assert all(_bitwise(g[k], w) for g, w in zip(got, single))


def _bad_calls():
    """(name, config, tables, layers, halo) of calls the wrapper refuses."""
    n = 12
    cfg = _config(n)
    tabs = tdetect.make_tables(cfg, "cpu")
    layers = _layers(n, 0, "dense")
    rows = slice(0, 6)
    block = [torch.nn.functional.pad(t, (0, 0, 2, 2))[:10] for t in layers[:3]]
    small = dataclasses.replace(cfg, dimension=2.0)  # 4 cells a side
    ok_block = (tdetect.row_tables(tabs, rows), block + [layers[3][rows], layers[4][rows]])
    return {
        "halo 1": (cfg, tabs, layers, 1),
        "halo 3": (cfg, tabs, layers, 3),
        "n < 5": (small, tdetect.make_tables(small, "cpu"),
                  [t[:4, :4].contiguous() for t in layers], 0),
        "short stencil row": (cfg, tabs, [layers[0][:-1]] + layers[1:], 0),
        "narrow ground": (cfg, tabs, layers[:3] + [layers[3][:, :-1], layers[4]], 0),
        "groundpatch shape": (cfg, tabs, layers[:4] + [layers[4][:-1]], 0),
        "f64 variance": (cfg, tabs, [layers[0], layers[1].double()] + layers[2:], 0),
        "f64 ground": (cfg, tabs, layers[:3] + [layers[3].double(), layers[4]], 0),
        "4-d layers": (cfg, tabs, [t[None, None] for t in layers], 0),
        "block without halo": (cfg, ok_block[0], ok_block[1], 0),
        "halo without block": (cfg, tabs, layers, 2),
        "full tables on a block": (cfg, tabs, ok_block[1], 2),
        "float use3": (cfg, tabs._replace(use3=tabs.use3.float()), layers, 0),
        "f64 skip_thr": (cfg, tabs._replace(skip_thr=tabs.skip_thr.double()), layers, 0),
        "int interior": (cfg, tabs._replace(interior=tabs.interior.int()), layers, 0),
        "batch against single": (cfg, tabs, [t[None] for t in layers[:3]] + layers[3:], 0),
        "meta tensors": (cfg, tabs, [t.to("meta") for t in layers], 0),
    }


@pytest.mark.parametrize("name", list(_bad_calls()))
def test_bad_calls_raise(name):
    cfg, tabs, layers, halo = _bad_calls()[name]
    with pytest.raises(ValueError):
        detect_stage(cfg, tabs, *layers, halo=halo)


def test_unsupported_device_raises():
    n = 12
    cfg = _config(n)
    tabs = tdetect.make_tables(cfg, "meta")
    layers = [t.to("meta") for t in _layers(n, 0, "dense")]
    with pytest.raises(RuntimeError, match="unsupported device"):
        detect_stage(cfg, tabs, *layers)


@pytest.mark.parametrize("kw,want", [
    ({}, stageops.detect_stage),
    ({"fused_detect": True}, fusedops.detect_fused),
    ({"use_pallas": False}, tdetect.detect_ground_patches),
    ({"use_pallas": False, "fused_detect": True}, fusedops.detect_fused_plain),
])
def test_step_detects_through(kw, want):
    assert Step(_config(44, **kw))._detect is want


@pytest.mark.parametrize("use_pallas", [None, False])
def test_spatial_bodies_detect_through_k8(monkeypatch, use_pallas):
    """The sharded detect's shard bodies call K8 with ``halo=2``, one call a
    shard (``detect_block`` with ``use_pallas=False``), bitwise the sweep."""
    calls = []
    real = stageops.detect_stage

    def spy(*args, **kw):
        calls.append(kw)
        return real(*args, **kw)

    monkeypatch.setattr(stageops, "detect_stage", spy)
    n, mesh = 44, ["cpu"] * 4
    cfg = _config(n, use_pallas=use_pallas)
    layers = _layers(n, 3, "quiet")
    g, c = spatial.ShardedDetect(cfg, mesh)(*(spatial.split_rows(t, mesh) for t in layers))
    assert calls == ([] if use_pallas is False else [{"halo": 2}] * 4)
    want = tdetect.detect_ground_patches(cfg, tdetect.make_tables(cfg, "cpu"), *layers)
    assert _bitwise(torch.cat(g), want[0]) and _bitwise(torch.cat(c), want[1])


def test_counter_is_registered():
    counts = ops.launch_counts()
    assert counts["detect_stage"] == detect_stage.launches
    saved = ops.counter_values()
    try:
        ops.reset_launch_counts()
        assert detect_stage.launches == 0
        ops.add_launches([0] * (len(saved) - 2) + [3, 0])  # K8's slot, then K3's global one
        assert ops.launch_counts()["detect_stage"] == 3
        values = ops.counter_values()
        ops.reset_launch_counts()
        ops.set_counters(values)
        assert detect_stage.launches == 3
    finally:
        ops.set_counters(saved)


def test_cpu_path_vs_jax(warm):  # noqa: F811
    jcfg, tcfg, d = warm
    jb, _, z = _binnings(jcfg, tcfg, d)
    layers = jraster.rasterize(jcfg, jb, jnp.asarray(z), jnp.asarray(d["origin"]),
                               jb.inmap & ~jb.ignored, with_max=False,
                               center=jnp.asarray(d["center"]),
                               t_base_map=jnp.asarray(d["t_base_map"]))
    args = [np.asarray(a) for a in (layers.points, layers.variance, layers.min_ground_height,
                                    d["ground"], d["groundpatch"])]
    g_j, c_j = jax.jit(lambda *a: jdetect.detect_ground_patches(
        jcfg, jdetect.make_tables(jcfg), *a))(*args)
    g_t, c_t = detect_stage(tcfg, tdetect.make_tables(tcfg, "cpu"), *(_t(a) for a in args))
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=0, atol=1e-4)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=0, atol=1e-5)
    assert (np.asarray(c_j) != args[4]).any()  # the sweep changed something


def _check_plan(rows, n, halo):
    """Every output cell in exactly one block; each block's staged rows and
    columns inside the input; every interior cell's 5x5 window, in input
    rows, inside its block's staged ranges; a block's threads and staged
    tile within the kernel's shape."""
    written = np.zeros((rows, n), np.int32)
    for b in tile_plan(rows, n, halo):
        assert 1 <= len(b.rows) <= TILE_H and 1 <= len(b.cols) <= TILE_W
        written[b.rows.start:b.rows.stop, b.cols.start:b.cols.stop] += 1
        assert 0 <= b.staged_rows.start and b.staged_rows.stop <= rows + 2 * halo
        assert 0 <= b.staged_cols.start and b.staged_cols.stop <= n
        assert len(b.staged_rows) <= TILE_H + 4 and len(b.staged_cols) <= TILE_W + 8
        # the window rows and columns that lie on the input are staged (the
        # columns with a 4-cell rim: staged rows start on 16-byte boundaries)
        lo_r, hi_r = b.rows.start + halo - 2, b.rows.stop - 1 + halo + 2
        assert b.staged_rows.start == max(lo_r, 0)
        assert b.staged_rows.stop == min(hi_r + 1, rows + 2 * halo)
        assert b.staged_cols.start == max(b.cols.start - 4, 0)
        assert b.staged_cols.stop == min(b.cols.start + TILE_W + 4, n)
        assert b.staged_cols.start <= max(b.cols.start - 2, 0)
        assert b.staged_cols.stop >= min(b.cols.stop + 2, n)
        assert (b.cols.start - 4) % 4 == 0
    np.testing.assert_array_equal(written, np.ones((rows, n), np.int32))


def _check_strips(rows, n, halo):
    """Every output cell in exactly one thread's strip; a strip holds 1 to
    ``STRIP`` consecutive cells of one of its block's rows, inside the
    block's columns, starting on a ``STRIP`` boundary of the tile; no more
    strips a block than threads; the strips' staged words (the window's
    ``STRIP`` + 4 columns, two a side) inside the staged tile and 8-byte
    aligned in it."""
    covered = np.zeros((rows, n), np.int32)
    for b in tile_plan(rows, n, halo):
        assert len(b.strips) <= THREADS
        for r, cols in b.strips:
            assert r in b.rows and 1 <= len(cols) <= STRIP
            assert cols.start in b.cols and cols.stop - 1 in b.cols
            assert (cols.start - b.cols.start) % STRIP == 0
            covered[r, cols.start:cols.stop] += 1
            # staged column j is input column b.cols.start - 4 + j
            first = cols.start - 2 - (b.cols.start - 4)
            assert 0 <= first and first + STRIP + 4 <= TILE_W + 8 and first % 2 == 0
    np.testing.assert_array_equal(covered, np.ones((rows, n), np.int32))


@pytest.mark.parametrize("lo", range(5, 701, 58))
def test_plan_covers_whole_grids(lo):
    for n in range(lo, min(lo + 58, 701)):
        _check_plan(n, n, 0)


@pytest.mark.parametrize("n", [1200, 2416])
def test_plan_covers_large_grids(n):
    _check_plan(n, n, 0)


@pytest.mark.parametrize("rows", range(1, 9))
def test_plan_covers_halo_blocks(rows):
    for n in (5, 12, 33, 45, 80, 364, 1200):
        _check_plan(rows, n, 2)


@pytest.mark.parametrize("n", [12, 45, 63, 64, 65, 80, 127, 364, 601, 1200])
def test_strips_cover_whole_grids(n):
    _check_strips(n, n, 0)


@pytest.mark.parametrize("rows", [1, 3, 8, 9, 17, 91])
def test_strips_cover_halo_blocks(rows):
    for n in (5, 12, 45, 66, 364, 1200):
        _check_strips(rows, n, 2)


def test_plan_is_the_kernel_shape():
    """``tile_plan``'s constants are ``detect_stage.cu``'s, read from its
    source: the tile, the strip and the threads a block."""
    import re

    from groundgrid_torch.ops import _build

    source = (_build.CSRC / "detect_stage.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (kTile[WH]|kStrip) = (\d+);",
                                               source)}
    assert consts == {"kTileW": TILE_W, "kTileH": TILE_H, "kStrip": STRIP}
    assert THREADS == TILE_W // STRIP * TILE_H
    blocks = tile_plan(364, 364, 0)
    assert len(blocks) == -(-364 // TILE_W) * -(-364 // TILE_H)


def test_records_pack_the_tables():
    """``DetectTables.records``, the kernel's one 16-byte load a cell: the
    three f32 tables' bits and use3 | interior << 1, also for a block's
    rows (``row_tables``)."""
    n = 45
    tabs = tdetect.make_tables(_config(n), "cpu")
    for t in (tabs, tdetect.row_tables(tabs, slice(10, 17))):
        rec = t.records
        assert rec.dtype == torch.int32 and rec.shape == (*t.use3.shape, 4)
        assert rec.is_contiguous()
        for k, table in enumerate((t.var_thr_sq, t.skip_thr, t.min_expected_s)):
            assert torch.equal(rec[..., k], table.view(torch.int32))
        flags = rec[..., 3]
        assert torch.equal(flags, t.use3.int() * tdetect.RECORD_USE3
                           + t.interior.int() * tdetect.RECORD_INTERIOR)


def test_shared_memory_fits():
    assert SHARED_BYTES == 13824  # 4 layers of 12 x 72 staged floats
    assert SHARED_BYTES <= fusedops.SHARED_LIMIT
