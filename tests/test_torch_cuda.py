"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test skips when ``torch.cuda.is_available()`` is false
(decided inside the ``cuda`` fixture, never at import). This file imports
neither JAX nor ``groundgrid_tpu``, so on a machine without JAX it runs
alone:

    python -m pytest tests/test_torch_cuda.py -m gpu --noconftest -q

Small sizes, including grids below 32 cells a side: K1 bitwise on every
column (also on the cell distributions of ``test_torch_raster_tiles.py``:
one cell, all overflow, runs across many tiles; two runs bitwise; and no
CUDA error on ids out of order), K2
bitwise (any point count, unsorted ids, ids at n2, an offset id view),
K3 confidence bitwise and heights within atol 2e-5 / rtol 1e-5 (up to n =
2414 on the band kernel, 2416 to 2800 on the global-band one; two runs
bitwise; its ring ranges over the bands of ``ring_bands`` bitwise one full
launch, n = 10 to 2416), K4 bitwise (n = 12 to 1200, grids that cut its tiles raggedly and
one where the use3 disc's edge crosses a tile; two runs bitwise; border
cells passed through); K8 bitwise the plain detect stage (n = 12 to
1200, the seam layers' signed zeros, NaN and ties; the spatial step's
halo'd row blocks; a batch of 3 against single launches; two runs
bitwise; its strips across the use3 circle; and each of
``STAGE_MUTATIONS`` built alone fails a case); K6 reading the old ground
itself on the seams of ``march_scenes.fold_inputs`` (overflow ids, -0.0
and NaN words, a batch; each of ``MARCH_MUTATIONS`` fails a case); the
occlusion march shedding candidates at the cap, on both selection keys, bitwise the CPU's; K5, K6 and K7 (the fused
binning and march) bitwise their plain versions on a warm scan, on random
points (cell edges and +-1 ulp from them, -0.0, both selection keys), on
a batch of 64 against 64 single launches, in two runs, and replayed from a
CUDA graph on another scan's scalars; K5's groups cut by rows, tails and
unaligned arrays (and ``BINNING_MUTATIONS``' dropped tail point fails);
K9 and K10 (the raster stage around K1) bitwise their plain versions on
the seams of ``raster_scenes`` (sorted and through the sort's order, a
batch, 4 and 8 shards), 64 scenes in one launch against single launches,
two runs, a graph replayed on another scene's scalars, and each of
``RASTER_STAGE_MUTATIONS`` built alone fails a case; K11 (the march's
candidate selection) bitwise its plain version, indices and marchable
count, under the cap, at it and over it (the radix select) on both keys up
to 2^18 points, 64 rows against 64 single launches, two runs, each of
``SELECT_MUTATIONS`` failing a case; K12 (the grid move) bitwise the plain
move for shifts of 0, +-1, +-37, +-(n - 1), +-n and beyond, NaN and -0.0
layers, a level plane at height 0, 64 grids against single launches, a
graph replayed on other scalars, each of ``MOVE_MUTATIONS`` failing a
case; plus the small-config
streaming step on the card against the same step on the CPU, on the main
path and on the fused, aux and wire path; the fleet on the card bitwise
per-vehicle streaming; a warm step and a fleet tick under
``torch.cuda.set_sync_debug_mode("error")``; the fleet bench; the spatial
step over four shards on the card; the captured spatial step (one graph a
scan, or one per segment between the collectives) bitwise the eager one
over a moving sequence, the captured sharded detect bitwise the eager
one, and an empty segment's graph replayed as nothing.
"""

import dataclasses

import numpy as np
import pytest
import torch

from groundgrid_torch.config import GroundGridConfig
from groundgrid_torch.core.detect import make_tables
from groundgrid_torch.data.synthetic import detect_layers
from groundgrid_torch.ops import (binning, detect, launch_counts, lookup, march, move, raster,
                                  raster_stage, reset_launch_counts, select, spiral)

pytestmark = pytest.mark.gpu


def _path(steps, detect, raster=None):
    """The launch counts of ``steps`` single steps (or shards, or batched
    steps) on the main path: K1 (``raster`` if the aux count adds one), K2
    (ground and variance for classify; K6 reads the old ground itself), K3,
    K5, K6, K7, K9, K10, K11 and K12 x1 (the march stage's three launches,
    ``test_march_stage_is_three_launches``), K4 ``detect`` (the fused
    detect, ``steps`` or 0), K8 the other steps."""
    return {"raster": steps if raster is None else raster, "lookup": steps, "spiral": steps,
            "detect": detect, "bin": steps, "march_budget": steps, "march": steps,
            "detect_stage": steps - detect, "raster_columns": steps, "raster_finish": steps,
            "select": steps, "move": steps}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)


def _sorted_cells(rng, p, n2):
    return np.sort(rng.integers(0, n2 + 1, p)).astype(np.int32)


@pytest.mark.parametrize("n,p", [(5, 77), (31, 3000), (80, 16384), (364, 131072)])
def test_raster_kernel_matches_plain(cuda, n, p):
    rng = np.random.default_rng(n)
    n2 = n * n
    cell = torch.from_numpy(_sorted_cells(rng, p, n2)).to(cuda)
    cols = [torch.from_numpy(rng.standard_normal(p).astype(np.float32)).to(cuda)
            for _ in range(7)]
    cols[0] = (cols[0] > 0).float()
    ops = ["sum"] * 5 + ["min", "max"]
    before = raster.raster_reduce.launches
    got = raster.raster_reduce(cell, cols, ops, n2)
    assert raster.raster_reduce.launches == before + 1
    want = raster.raster_reduce_plain(cell, cols, ops, n2)
    torch.cuda.synchronize()
    for j, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), f"column {j}"


def _raster_case(kind, n, device):
    # the twin's distributions (a sibling test module: no JAX there either)
    from test_torch_raster_tiles import _cells

    n2 = n * n
    cell = _cells(kind, seed=n, n2=n2)
    rng = np.random.default_rng(n)
    p = cell.shape[0]
    cols = [torch.from_numpy(rng.standard_normal(p).astype(np.float32)).to(device)
            for _ in range(7)]
    cols[0] = (cols[0] > 0).float()
    cols[6] = cols[6].round()  # ties for the max
    return torch.from_numpy(cell).to(device), cols, ["sum"] * 5 + ["min", "max"], n2


@pytest.mark.parametrize("n", [5, 31, 364])
@pytest.mark.parametrize("kind", ["uniform", "one_cell", "overflow", "one_long_run", "long_runs",
                                  "gaps", "tile_edges", "single"])
def test_raster_kernel_on_tile_plan_distributions(cuda, kind, n):
    cell, cols, ops, n2 = _raster_case(kind, n, cuda)
    got = raster.raster_reduce(cell, cols, ops, n2)
    again = raster.raster_reduce(cell, cols, ops, n2)
    want = raster.raster_reduce_plain(cell, cols, ops, n2)
    torch.cuda.synchronize()
    for j, (g, a, w) in enumerate(zip(got, again, want)):
        assert torch.equal(g, w), f"column {j}"
        assert torch.equal(g, a), f"column {j}: two runs differ"


@pytest.mark.parametrize("n,p", [(5, 4000), (31, 3000), (364, 131072)])
def test_raster_kernel_survives_unsorted_ids(cuda, n, p):
    """Ids out of order (outside the contract, as a step without the
    sortedness check may pass) and ids outside [0, n2]: any values, but no
    CUDA error, and the kernel is right again on the sorted ids."""
    rng = np.random.default_rng(p)
    n2 = n * n
    ids = _sorted_cells(rng, p, n2)
    ids[rng.integers(0, p, p // 50)] = rng.integers(-3, 2 * n2, p // 50)
    cols = [torch.from_numpy(rng.standard_normal(p).astype(np.float32)).to(cuda)
            for _ in range(7)]
    ops = ["sum"] * 5 + ["min", "max"]
    for shuffled in (ids[rng.permutation(p)], ids[::-1].copy(), ids):
        got = raster.raster_reduce(torch.from_numpy(shuffled).to(cuda), cols, ops, n2)
        torch.cuda.synchronize()
        assert all(g.shape == (n2,) for g in got)
    cell = torch.from_numpy(np.sort(np.clip(ids, 0, n2))).to(cuda)
    for g, w in zip(raster.raster_reduce(cell, cols, ops, n2),
                    raster.raster_reduce_plain(cell, cols, ops, n2)):
        assert torch.equal(g, w)


def test_raster_kernel_on_column_views(cuda):
    """Ids and columns that start 4 bytes past an aligned address (the
    scalar staging path), and strided columns (the wrapper copies them)."""
    cell, cols, ops, n2 = _raster_case("long_runs", 31, cuda)
    wide = torch.stack(cols, 1)  # (P, 7): column j is a stride-7 view
    for views in ([c[1:] for c in cols], [w[1:] for w in wide.unbind(1)]):
        got = raster.raster_reduce(cell[1:], views, ops, n2)
        want = raster.raster_reduce_plain(cell[1:], views, ops, n2)
        torch.cuda.synchronize()
        for j, (g, w) in enumerate(zip(got, want)):
            assert torch.equal(g, w), f"column {j}"


@pytest.mark.parametrize("kind", ["sorted", "unsorted", "overflow", "empty"])
def test_lookup_kernel_matches_plain(cuda, kind):
    rng = np.random.default_rng(3)
    n2 = 80 * 80
    cell = {"sorted": _sorted_cells(rng, 16384, n2),
            "unsorted": rng.integers(0, n2 + 1, 37888).astype(np.int32),
            "overflow": np.full(4096, n2, np.int32),
            "empty": np.zeros(0, np.int32)}[kind]
    cell = torch.from_numpy(cell).to(cuda)
    words = rng.integers(0, 1 << 32, n2, dtype=np.uint64).astype(np.uint32).view(np.float32)
    tabs = [torch.from_numpy(words).to(cuda),
            torch.from_numpy(rng.standard_normal((80, 80)).astype(np.float32)).to(cuda)]
    for k in (1, 2):
        got = lookup.lookup(cell, tabs[:k], n2)
        want = lookup.lookup_plain(cell, tabs[:k], n2)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g.view(torch.int32), w.view(torch.int32))


@pytest.mark.parametrize("p", [0, 1, 3, 5, 8, 4 * 1001 + 3])
def test_lookup_kernel_any_count(cuda, p):
    """Any P (whole and partial warp groups of ids), unsorted ids with ids
    at n2 and beyond, one and two tables, and an id view that starts 4
    bytes past an aligned address: bitwise the plain version."""
    rng = np.random.default_rng(p)
    n2 = 31 * 31
    ids = rng.integers(-2, n2 + 3, p + 1).astype(np.int32)
    ids[::3] = n2
    words = rng.integers(0, 1 << 32, n2, dtype=np.uint64).astype(np.uint32).view(np.float32)
    tabs = [torch.from_numpy(words).to(cuda),
            torch.from_numpy(rng.standard_normal(n2).astype(np.float32)).to(cuda)]
    full = torch.from_numpy(ids).to(cuda)
    before = lookup.lookup.launches
    for cell in (full[:p], full[1:]):  # full[1:] starts 4 bytes past an aligned address
        for k in (1, 2):
            got = lookup.lookup(cell, tabs[:k], n2)
            want = lookup.lookup_plain(cell, tabs[:k], n2)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    assert lookup.lookup.launches == before + (4 if p else 0)  # nothing to read: no launch


def _base_z(device, value=0.37):
    """K3's seed as the kernel reads it: a 0-dim f32 tensor on the card."""
    return torch.tensor(value, dtype=torch.float32, device=device)


def _spiral_layers(n, device):
    rng = np.random.default_rng(n)
    ground = torch.from_numpy(rng.normal(0, 0.5, (n, n)).astype(np.float32)).to(device)
    conf = np.zeros((n, n), np.float32)
    mask = rng.random((n, n)) < 0.4
    conf[mask] = rng.uniform(0.0, 1.0, mask.sum())
    return ground, torch.from_numpy(conf).to(device)


@pytest.mark.parametrize("dimension,resolution", [
    (5.0, 0.5), (12.0, 0.5), (12.5, 0.5), (15.0, 0.5), (16.65, 0.37), (40.0, 0.5), (70.0, 0.5),
    (120.0, 0.33), (400.0, 0.33), (1207.0, 0.5),
])
def test_spiral_kernel_matches_plain(cuda, dimension, resolution):
    """n = 10 (two rings), 24, 25, 30 (below a warp), 45 (odd), 80, 140, 364,
    1212 (more visits than threads, a ring band above 48 KB) and 2414 (the
    largest band that fits, 11 visits per thread)."""
    cfg = GroundGridConfig(dimension=dimension, resolution=resolution)
    ground, conf = _spiral_layers(cfg.cell_count, cuda)
    z = _base_z(cuda)
    g_k, c_k = spiral.spiral_interpolation(cfg, ground.clone(), conf.clone(), z)
    g_p, c_p = spiral.spiral_interpolation_plain(cfg, ground.clone(), conf.clone(), z)
    torch.cuda.synchronize()
    assert torch.equal(c_k, c_p)
    torch.testing.assert_close(g_k, g_p, atol=2e-5, rtol=1e-5)
    with pytest.raises(ValueError):  # the kernel writes in place: no strided views
        spiral.spiral_interpolation(cfg, ground.t(), conf.t(), z)
    with pytest.raises(ValueError):  # the kernel reads base_z from device memory
        spiral.spiral_interpolation(cfg, ground.clone(), conf.clone(), 0.37)


def test_spiral_kernel_is_deterministic(cuda):
    cfg = GroundGridConfig()
    ground, conf = _spiral_layers(cfg.cell_count, cuda)
    runs = [spiral.spiral_interpolation(cfg, ground.clone(), conf.clone(), _base_z(cuda))
            for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])


@pytest.mark.parametrize("dimension,resolution", [(241.6, 0.1), (825.0, 0.33), (280.0, 0.1)])
def test_spiral_kernel_refuses_a_band_beyond_shared_memory(cuda, dimension, resolution):
    """n = 2416, 2500 and 2800: the ring band does not fit a block's shared memory,
    so the global-band kernel walks the grid (no fallback to the plain
    version), counted as a K3 launch: confidence bitwise, heights within
    atol 2e-5 / rtol 1e-5, two runs bitwise."""
    cfg = GroundGridConfig(dimension=dimension, resolution=resolution)
    assert spiral.spiral_variant(cfg.cell_count) == "global"
    ground, conf = _spiral_layers(cfg.cell_count, cuda)
    reset_launch_counts()
    runs = [spiral.spiral_interpolation(cfg, ground.clone(), conf.clone(), _base_z(cuda))
            for _ in range(2)]
    assert launch_counts()["spiral"] == 2 and spiral.spiral_interpolation.global_launches == 2
    g_p, c_p = spiral.spiral_interpolation_plain(cfg, ground.clone(), conf.clone(), 0.37)
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
    assert torch.equal(runs[0][1], c_p)
    torch.testing.assert_close(runs[0][0], g_p, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("size", [2, 3, 8])
@pytest.mark.parametrize("dimension,resolution", [
    (5.0, 0.5), (15.0, 0.5), (40.0, 0.5), (120.0, 0.33), (120.0, 0.1), (241.6, 0.1),
])
def test_spiral_bands_in_order_match_one_launch(cuda, dimension, resolution, size):
    """n = 10 (empty bands at S = 8), 30, 80, 364, 1200 and 2416 (the global
    band): K3's ring-range launches over the bands of ``ring_bands``, in
    order on the same layers, are bitwise one full launch, one launch per
    non-empty band; a middle band agrees with its plain version."""
    from groundgrid_torch.parallel.spiral_shard import band_ranges

    cfg = GroundGridConfig(dimension=dimension, resolution=resolution)
    ground, conf = _spiral_layers(cfg.cell_count, cuda)
    z = _base_z(cuda)
    full = spiral.spiral_interpolation(cfg, ground.clone(), conf.clone(), z)
    h, c = ground.clone(), conf.clone()
    ranges = band_ranges(cfg, size)
    reset_launch_counts()
    for k, (d0, d1) in enumerate(ranges):
        if k == 1:
            before = (h.clone(), c.clone())
        spiral.spiral_interpolation_rings(cfg, h, c, z, d0, d1, seed_center=k == 0)
    assert launch_counts()["spiral"] == sum(d1 >= d0 for d0, d1 in ranges)
    torch.cuda.synchronize()
    assert torch.equal(h.view(torch.int32), full[0].view(torch.int32))
    assert torch.equal(c.view(torch.int32), full[1].view(torch.int32))
    d0, d1 = ranges[1]
    g_k, c_k = spiral.spiral_interpolation_rings(cfg, before[0].clone(), before[1].clone(), z,
                                                 d0, d1)
    g_p, c_p = spiral.spiral_interpolation_rings_plain(cfg, before[0].clone(),
                                                       before[1].clone(), 0.37, d0, d1, False)
    assert torch.equal(c_k, c_p)
    torch.testing.assert_close(g_k, g_p, atol=2e-5, rtol=1e-5)


def test_spatial_step_on_card(cuda):
    """The spatial step over ``["cuda:0"] * 4`` at the small config: launch
    counts, banded == replicated bitwise, a warm step without a host read,
    labels within 0.1 % of the same step on ``["cpu"] * 4``."""
    from groundgrid_torch.data.synthetic import synthetic_sequence
    from groundgrid_torch.parallel import spatial
    from groundgrid_torch.pipeline import init_state, pad_scan

    cfg = GroundGridConfig(dimension=40.0, resolution=0.5, max_points=16384, ray_steps=40,
                           max_outlier_candidates=1024)
    scans = list(synthetic_sequence(3, seed=5, n_beams=16, n_azimuth=500))
    outs = {}
    for dev, mode in ((cuda, "replicated"), (cuda, "banded"), (torch.device("cpu"), "replicated")):
        on_card = dev.type == "cuda"
        mesh = [dev] * 4
        step = spatial.make_spatial_step(cfg, mesh, spiral_mode=mode)
        st = init_state(cfg, np.asarray(scans[0][2], np.float32), dev)
        g, c = spatial.split_rows(st.ground, mesh), spatial.split_rows(st.groundpatch, mesh)
        center = (st.center, st.center_lo)
        labels = []
        for k, (pts, lbl, T) in enumerate(scans):
            chunks = spatial.shard_scan(pad_scan(cfg, pts, lbl, T, dev), mesh)
            reset_launch_counts()
            if k and on_card:
                torch.cuda.set_sync_debug_mode("error")
            try:
                g, c, center, lab, _ = step(g, c, center, chunks)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            if on_card:
                assert launch_counts() == _path(4, detect=0)
            labels.append(torch.cat(lab).cpu())
        outs[(str(dev), mode)] = (torch.cat(g).cpu(), torch.cat(c).cpu(), labels)
    rep, band = outs[(str(cuda), "replicated")], outs[(str(cuda), "banded")]
    assert torch.equal(rep[0], band[0]) and torch.equal(rep[1], band[1])
    assert all(torch.equal(a, b) for a, b in zip(rep[2], band[2]))
    cpu = outs[("cpu", "replicated")]
    mism = sum(int((a != b).sum()) for a, b in zip(rep[2], cpu[2]))
    assert mism <= 0.001 * 3 * cfg.max_points


@pytest.mark.parametrize("dimension,resolution,scale", [
    (6.0, 0.5, 10.0), (22.0, 0.5, 1.0), (16.65, 0.37, 1.0), (40.0, 0.5, 1.0), (120.0, 0.33, 1.0),
    (63.5, 0.5, 1.0), (64.5, 0.5, 1.0), (60.0, 0.25, 1.0), (120.0, 0.1, 1.0),
])
def test_detect_kernel_matches_plain(cuda, dimension, resolution, scale):
    """n = 12 (points x10 so that cells pass the skip threshold), 44, 45, 80,
    364; 127 and 129 (interiors of the tile width -1 and +1: a one-column
    second tile, strips cut raggedly); 240 (the use3 disc's edge crosses a
    tile); 1200 (HIGHRES_CONFIG): ground and confidence bitwise, two runs
    bitwise."""
    cfg = GroundGridConfig(dimension=dimension, resolution=resolution)
    n = cfg.cell_count
    tables = make_tables(cfg, cuda)
    for seed, quiet in ((0, False), (1, False), (0, True)):
        layers = list(detect_layers(n, seed))
        layers[0] = layers[0] * np.float32(scale)
        if quiet:  # variance x0.01: cells take the main update
            layers[1] = layers[1] * np.float32(0.01)
        ts = [torch.from_numpy(a).to(cuda) for a in layers]
        before = detect.detect_fused.launches
        got = detect.detect_fused(cfg, tables, *ts)
        again = detect.detect_fused(cfg, tables, *ts)
        assert detect.detect_fused.launches == before + 2
        want = detect.detect_fused_plain(cfg, tables, *ts)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert torch.equal(got[0].view(torch.int32), again[0].view(torch.int32))
        assert torch.equal(got[1].view(torch.int32), again[1].view(torch.int32))
        assert (got[1].cpu().numpy() != layers[4]).any()


def test_detect_grids_cover_the_tile_edges():
    """The grids above cut K4's tiles as their docstring says (the plan only,
    no card needed)."""
    assert [len(b.cols) for b in detect.tile_plan(127).blocks[:1]] == [detect.TILE_W - 1]
    assert [len(b.cols) for b in detect.tile_plan(129).blocks[:2]] == [detect.TILE_W, 1]
    for n in (127, 129, 1200):
        plan = detect.tile_plan(n)
        assert (n - 4) % plan.rows != 0  # the last strip is ragged
    cfg = GroundGridConfig(dimension=60.0, resolution=0.25)
    use3 = make_tables(cfg, "cpu").use3.numpy()
    split = [b for b in detect.tile_plan(cfg.cell_count).blocks
             if use3[b.rows.start:b.rows.stop, b.cols.start:b.cols.stop].any()
             and not use3[b.rows.start:b.rows.stop, b.cols.start:b.cols.stop].all()]
    assert len({b.cols.start for b in split}) == 2  # the disc's edge in both tiles


def test_detect_kernel_passes_border_through(cuda):
    """Cells outside the interior [2, n-2)^2 copy ground and confidence
    through exactly, on grids of one and of several tiles and strips; the
    inputs stay as they were."""
    for dimension, resolution in ((6.0, 0.5), (64.5, 0.5), (120.0, 0.33)):
        cfg = GroundGridConfig(dimension=dimension, resolution=resolution)
        n = cfg.cell_count
        layers = list(detect_layers(n, 7))
        layers[0] = layers[0] * np.float32(10.0)
        layers[1] = layers[1] * np.float32(0.01)
        ts = [torch.from_numpy(a.copy()).to(cuda) for a in layers]
        g, c = detect.detect_fused(cfg, make_tables(cfg, cuda), *ts)
        torch.cuda.synchronize()
        border = np.ones((n, n), dtype=bool)
        border[2:n - 2, 2:n - 2] = False
        np.testing.assert_array_equal(g.cpu().numpy()[border], layers[3][border])
        np.testing.assert_array_equal(c.cpu().numpy()[border], layers[4][border])
        assert (c.cpu().numpy()[~border] != layers[4][~border]).any()
        for t, a in zip(ts, layers):
            np.testing.assert_array_equal(t.cpu().numpy(), a)


def test_plain_detect_on_card_matches_cpu(cuda):
    """The plain detect stage divides by constants on the card as on the CPU
    (a CUDA division by a host scalar would multiply by its reciprocal).
    Variance x0.01: cells take the main update, where the divisions are."""
    from groundgrid_torch.core import detect as detectlib

    cfg = GroundGridConfig(dimension=40.0, resolution=0.5)
    n = cfg.cell_count
    for seed in range(2):
        layers = list(detect_layers(n, seed))
        layers[1] = layers[1] * np.float32(0.01)
        got = {d: detectlib.detect_ground_patches(
            cfg, make_tables(cfg, d), *(torch.from_numpy(a).to(d) for a in layers))
            for d in ("cpu", cuda)}
        for a, b in zip(got["cpu"], got[cuda]):
            assert torch.equal(a, b.cpu())


def _stage_cases(cuda):
    """K8's cases: (name, config, tables, five layers on the card)."""
    from groundgrid_torch.data.synthetic import detect_seam_layers

    for dimension, resolution, scale in (
            (6.0, 0.5, 10.0), (22.0, 0.5, 1.0), (16.65, 0.37, 1.0), (40.0, 0.5, 1.0),
            (120.0, 0.33, 1.0), (63.5, 0.5, 1.0), (64.5, 0.5, 1.0), (120.0, 0.1, 1.0)):
        cfg = GroundGridConfig(dimension=dimension, resolution=resolution)
        n = cfg.cell_count
        tables = make_tables(cfg, cuda)
        for seed, quiet in ((0, False), (1, False), (0, True)):
            layers = list(detect_layers(n, seed))
            layers[0] = layers[0] * np.float32(scale)
            if quiet:  # variance x0.01: cells take the main update
                layers[1] = layers[1] * np.float32(0.01)
            yield (f"n={n} seed {seed}{' quiet' if quiet else ''}", cfg, tables,
                   [torch.from_numpy(a).to(cuda) for a in layers])
        if n >= 40:
            yield (f"n={n} seam", cfg, tables,
                   [torch.from_numpy(a).to(cuda) for a in detect_seam_layers(n, 1)])


def test_detect_stage_kernel_matches_plain(cuda):
    """K8 against the plain stage (``core/detect.py``) on the same CUDA
    tensors, n = 12 (points x10) to 1200, the seam layers (+-0.0, FLT_MAX,
    NaN, the ladder's ties) from n = 44: ground and confidence bitwise, NaN
    and -0.0 included; two runs bitwise; one launch a call."""
    from groundgrid_torch.core import detect as detectlib
    from groundgrid_torch.ops.detect_stage import detect_stage

    for name, cfg, tables, ts in _stage_cases(cuda):
        before = detect_stage.launches
        got = detect_stage(cfg, tables, *ts)
        again = detect_stage(cfg, tables, *ts)
        assert detect_stage.launches == before + 2
        want = detectlib.detect_ground_patches(cfg, tables, *ts)
        for g, a, w in zip(got, again, want):
            assert _bitwise(g, w), name
            assert _bitwise(g, a), name
        assert (got[1] != ts[4]).any(), name


@pytest.mark.parametrize("dimension,resolution,shards", [
    (40.0, 0.5, 2), (40.0, 0.5, 4), (120.0, 0.33, 4), (120.0, 0.1, 8)])
def test_detect_stage_halo_blocks_on_card(cuda, dimension, resolution, shards):
    """K8 with ``halo=2`` on the spatial step's row blocks: each bitwise
    ``detect_block``, together bitwise the full sweep."""
    from groundgrid_torch.core import detect as detectlib
    from groundgrid_torch.ops.detect_stage import detect_stage

    cfg = GroundGridConfig(dimension=dimension, resolution=resolution)
    n = cfg.cell_count
    tables = make_tables(cfg, cuda)
    layers = list(detect_layers(n, 3))
    layers[1] = layers[1] * np.float32(0.01)
    ts = [torch.from_numpy(a).to(cuda) for a in layers]
    full = detectlib.detect_ground_patches(cfg, tables, *ts)
    rows, blocks = n // shards, []
    for s in range(shards):
        at = slice(s * rows, (s + 1) * rows)
        halos = [torch.nn.functional.pad(t, (0, 0, 2, 2))[at.start:at.stop + 4] for t in ts[:3]]
        rt = detectlib.row_tables(tables, at)
        got = detect_stage(cfg, rt, *halos, ts[3][at], ts[4][at], halo=2)
        want = detectlib.detect_block(cfg, rt, *halos, ts[3][at], ts[4][at])
        assert all(_bitwise(g, w) for g, w in zip(got, want)), s
        blocks.append(got)
    for i in range(2):
        assert _bitwise(torch.cat([b[i] for b in blocks]), full[i])


def test_detect_stage_batch_matches_single_launches(cuda):
    """K8 on B = 3 grids: one launch, each grid bitwise its single launch and
    the batch bitwise the plain stage's batched sweep."""
    from groundgrid_torch.core import detect as detectlib
    from groundgrid_torch.ops.detect_stage import detect_stage

    cfg = GroundGridConfig(dimension=40.0, resolution=0.5)
    n = cfg.cell_count
    tables = make_tables(cfg, cuda)
    layers = [torch.from_numpy(np.stack(arrs)).to(cuda) for arrs in
              zip(*(detect_layers(n, seed) for seed in range(3)))]
    layers[1] = layers[1] * 0.01
    before = detect_stage.launches
    got = detect_stage(cfg, tables, *layers)
    assert detect_stage.launches == before + 1
    for g, w in zip(got, detectlib.detect_ground_patches(cfg, tables, *layers)):
        assert _bitwise(g, w)
    for v in range(3):
        single = detect_stage(cfg, tables, *(t[v] for t in layers))
        for g, w in zip(got, single):
            assert _bitwise(g[v], w)


def test_detect_stage_strips_across_the_use3_circle(cuda):
    """K8's strips (``ops/detect_stage.py tile_plan``, ``STRIP`` cells a
    thread) that hold both 3x3 and 5x5 interior cells, where a thread folds
    both windows from one row of registers: they exist at n = 80, 364 and
    1200 and the kernel is bitwise the plain stage on their cells, on warm
    layers and the seam layers."""
    from groundgrid_torch.core import detect as detectlib
    from groundgrid_torch.data.synthetic import detect_seam_layers
    from groundgrid_torch.ops.detect_stage import detect_stage, tile_plan

    for dimension, resolution in ((40.0, 0.5), (120.0, 0.33), (120.0, 0.1)):
        cfg = GroundGridConfig(dimension=dimension, resolution=resolution)
        n = cfg.cell_count
        tables = make_tables(cfg, cuda)
        use3, interior = tables.use3.cpu(), tables.interior.cpu()
        mixed = torch.zeros((n, n), dtype=torch.bool)
        for block in tile_plan(n, n, 0):
            for r, cols in block.strips:
                cells = slice(cols.start, cols.stop)
                inner = interior[r, cells]
                if bool((use3[r, cells] & inner).any() and (~use3[r, cells] & inner).any()):
                    mixed[r, cells] = True
        assert int(mixed.sum()) > 0, n
        for layers in (detect_layers(n, 0), detect_seam_layers(n, 1)):
            ts = [torch.from_numpy(a).to(cuda) for a in layers]
            got = detect_stage(cfg, tables, *ts)
            want = detectlib.detect_ground_patches(cfg, tables, *ts)
            for g, w in zip(got, want):
                assert _bitwise(g.cpu()[mixed], w.cpu()[mixed]), n
                assert _bitwise(g, w), n


def test_march_budget_reads_the_ground_on_seams(cuda):
    """K6 reading ``ground[cell]`` itself against K2's plain gather and the
    plain budget on the seams of ``march_scenes.fold_inputs`` (overflow ids
    on in-map points, -0.0 and NaN ground words, the word past a grid), one
    vehicle and a batch of three: budgets, keys and directions bitwise, two
    runs bitwise, each batch row bitwise its single launch."""
    import march_scenes

    cfg = GroundGridConfig(**march_scenes.EDGE)
    for seeds in ((0,), (1,), (2, 3, 4)):
        s, b, x, y, z, ground, ov = march_scenes.fold_inputs(cfg, seeds, cuda)
        want = march.march_budget_plain(cfg, s, b, x, y, z, ground)
        before = march.march_budget.launches
        got = march.march_budget(cfg, s, b, x, y, z, ground)
        again = march.march_budget(cfg, s, b, x, y, z, ground)
        assert march.march_budget.launches == before + 2
        assert _same_budgets(got, want) and _same_budgets(again, got), seeds
        assert bool((got[0][ov] > 0).any())
        for v, seed in enumerate(seeds if len(seeds) > 1 else ()):
            one = march.march_budget(cfg, *march_scenes.fold_inputs(cfg, (seed,), cuda)[:-1])
            assert _same_budgets(one, (got[0][v], got[1][v], got[2][:, v])), seed


def _mutants(source, mutations, tmp_path):
    """``{name: library path}`` of ``csrc/<source>`` built alone with the
    library's flags, unmutated ("none") and under each of ``mutations``
    (``{name: (old, new)}``, ``old`` found once), one nvcc a build, all
    started together."""
    import subprocess

    from groundgrid_torch.ops import _build

    text = (_build.CSRC / source).read_text()
    (tmp_path / "exactf32.cuh").write_text((_build.CSRC / "exactf32.cuh").read_text())
    jobs = {}
    for k, (name, (old, new)) in enumerate([("none", ("", ""))] + list(mutations.items())):
        assert name == "none" or text.count(old) == 1, name
        (tmp_path / f"m{k}.cu").write_text(text.replace(old, new))
        jobs[name] = (tmp_path / f"m{k}.so", subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(tmp_path / f"m{k}.so"),
             str(tmp_path / f"m{k}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    for name, (lib_path, proc) in jobs.items():
        out, _ = proc.communicate()
        assert proc.returncode == 0, (name, out)
    return {name: lib_path for name, (lib_path, _) in jobs.items()}


def _entry(lib_path, name):
    import ctypes

    from groundgrid_torch.ops import _build

    entry = getattr(ctypes.CDLL(str(lib_path)), name)
    entry.argtypes = _build._SIGNATURES[name]
    return entry


# mutations of detect_stage.cu that the cases above must catch
STAGE_MUTATIONS = {
    "process >": ("w.psum >= t[j].skip_thr", "w.psum > t[j].skip_thr"),
    "max_var >= 0": ("(max_var > 0.0f)", "(max_var >= 0.0f)"),
    "localmin <=": ("w.localmin < gj)", "w.localmin <= gj)"),
    "groundpatch >= 0.5": ("(cfj > 0.5f)", "(cfj >= 0.5f)"),
    "chain from 0": ("    w = Window{p, pv, pm, m};\n    return;\n",
                     "    w = Window{0.0f, 0.0f, 0.0f, __int_as_float(0x7f800000)};\n"),
    "columns reversed": ("const int i5 = j + dc;", "const int i5 = j + 4 - dc;"),
    "min drops NaN": ("  if (a != a) return a;\n  if (b != b) return b;\n", ""),
    "new_c unclamped": ("clamp_max(gg::div(w.psum, a.ocpcf), 1.0f)", "gg::div(w.psum, a.ocpcf)"),
    "strip shifted": ("const int i5 = j + dc;", "const int i5 = (j == 1 ? 0 : j) + dc;"),
    "NaN blocks by fminf": ("  if (nan_free) fold_strip<true>", "  if (true) fold_strip<true>"),
}


def test_mutated_detect_stage_kernels_fail(cuda, tmp_path):
    """Each mutation of ``STAGE_MUTATIONS`` (a tie flipped, a chain started
    at 0, a window row folded from its last column, the min losing NaN, a
    clamp missed, a strip's second cell folded from the first cell's
    registers, a block with a NaN min_gh folded by fminf alone), built
    alone with the library's flags, differs from the
    plain stage on at least one of ``test_detect_stage_kernel_matches_plain``'s
    cases; the source unmutated, built and called the same way, on none."""
    from groundgrid_torch.core import detect as detectlib
    from groundgrid_torch.ops.detect import _constants

    libs = _mutants("detect_stage.cu", STAGE_MUTATIONS, tmp_path)
    cases = list(_stage_cases(cuda))
    wants = [detectlib.detect_ground_patches(cfg, tables, *ts) for _, cfg, tables, ts in cases]
    for name, lib_path in libs.items():
        entry = _entry(lib_path, "gg_detect_stage")
        caught = []
        for (case, cfg, tables, ts), want in zip(cases, wants):
            out_g, out_c = torch.empty_like(ts[3]), torch.empty_like(ts[4])
            pccvt, out_tol, ocpcf = _constants(cfg)
            assert entry(*(t.data_ptr() for t in [*ts, tables.records]), cfg.cell_count,
                         cfg.cell_count, 0, 1, pccvt, out_tol, ocpcf, ocpcf * 2.0,
                         out_g.data_ptr(), out_c.data_ptr(),
                         torch.cuda.current_stream().cuda_stream) == 0
            if not (_bitwise(out_g, want[0]) and _bitwise(out_c, want[1])):
                caught.append(case)
        if name == "none":
            assert not caught, f"the unmutated source failed {caught}"
        else:
            assert caught, f"mutation {name!r} passed every case"


# mutations of march.cu's K6 that ``test_march_budget_reads_the_ground_on_seams``'s
# cases must catch
MARCH_MUTATIONS = {
    "ground read unguarded": ("(c >= 0 && c < n2) ? ground[(size_t)blockIdx.y * n2 + c] : 0.0f",
                              "ground[(size_t)blockIdx.y * n2 + c]"),
}


def test_mutated_march_budget_kernels_fail(cuda, tmp_path):
    """Each mutation of ``MARCH_MUTATIONS`` (K6 reading the word at the
    overflow id n^2, past its grid), built alone with the library's flags,
    differs from the plain route on a seam case; the source unmutated, on
    none."""
    import math

    import march_scenes
    from groundgrid_torch.core import scalars as scalarlib

    libs = _mutants("march.cu", MARCH_MUTATIONS, tmp_path)
    cfg = GroundGridConfig(**march_scenes.EDGE)
    cases = [march_scenes.fold_inputs(cfg, seeds, cuda) for seeds in ((0,), (2, 3, 4))]
    wants = [march.march_budget_plain(cfg, *case[:-1]) for case in cases]
    for name, lib_path in libs.items():
        entry = _entry(lib_path, "gg_march_budget")
        caught = 0
        for (s, b, x, y, z, ground, _), want in zip(cases, wants):
            base, stride = scalarlib.device_rows(s, x)
            out = (torch.empty_like(x), torch.empty(x.shape, dtype=torch.int64, device=cuda),
                   torch.empty((3, *x.shape), device=cuda),
                   torch.ones(x.shape, dtype=torch.bool, device=cuda))
            assert entry(*(t.data_ptr() for t in (x, y, z, b.cell, b.inmap, b.ignored)),
                         x.shape[-1], math.prod(x.shape[:-1]), ground.data_ptr(),
                         cfg.cell_count ** 2, base, stride, *(t.data_ptr() for t in out),
                         torch.cuda.current_stream().cuda_stream) == 0
            caught += not (_same_budgets(out, want) and _bitwise(out[3], want[3]))
        assert (caught == 0) == (name == "none"), (name, caught)


# mutations of march.cu's K7 that ``test_mutated_march_kernels_fail``'s case
# must catch
WALK_MUTATIONS = {
    "K7 ends one warp early": ("if (c >= kc || c >= a.n_marchable[row]) return;",
                               "if (c >= kc || c + 1 >= a.n_marchable[row]) return;"),
}


def test_mutated_march_kernels_fail(cuda, tmp_path):
    """Each mutation of ``WALK_MUTATIONS`` (K7 ending the warp of the last
    marchable candidate with the padding past K11's count), built alone
    with the library's flags, differs from the plain march on the
    clamp-edge scene with the budgets of the candidates that miss set to
    0, so that every marchable candidate hits, the last one too; the source
    unmutated, on none."""
    import march_scenes
    from groundgrid_torch.core import exactf32
    from groundgrid_torch.core import scalars as scalarlib

    libs = _mutants("march.cu", WALK_MUTATIONS, tmp_path)
    cfg = GroundGridConfig(**march_scenes.EDGE)
    sc = march_scenes.Scene(*(torch.from_numpy(a).to(cuda)
                              for a in march_scenes.edge_scene(cfg, 0)))
    s = scalarlib.view(sc.packed)
    b = binning.bin_points_plain(cfg, s, sc.x, sc.y, sc.rings, sc.valid)
    budget, key, dirs, pidx = _march_inputs(cfg, s, b, sc.x, sc.y, sc.z, sc.ground,
                                            march.march_budget_plain)
    hits = _march(march.march_plain, cfg, s, sc.ground, sc.conf, pidx, budget, dirs)
    budget = torch.where(hits, budget, torch.zeros_like(budget))  # only the hits march
    pidx, n_m = select.select_candidates_plain(budget, _selection_key(budget),
                                               min(cfg.max_outlier_candidates, budget.shape[-1]))
    want = _march(march.march_plain, cfg, s, sc.ground, sc.conf, pidx, budget, dirs)
    assert int(n_m) > 1 and bool(want[pidx[int(n_m) - 1]])  # the last marchable one hits
    base, stride = scalarlib.device_rows(s, budget)
    rh, rl, inv = exactf32.res_ds(cfg.resolution)
    for name, lib_path in libs.items():
        entry = _entry(lib_path, "gg_march")
        out = torch.zeros(budget.shape, dtype=torch.bool, device=cuda)
        assert entry(pidx.data_ptr(), pidx.shape[-1], n_m.data_ptr(), budget.data_ptr(),
                     dirs.data_ptr(), sc.ground.data_ptr(), sc.conf.data_ptr(),
                     budget.shape[-1], 1, cfg.cell_count, base, stride, float(rh), float(rl),
                     float(inv), float(np.float32(cfg.outlier_tolerance)),
                     float(np.float32(cfg.min_outlier_detection_ground_confidence)),
                     int(cfg.ray_steps), out.data_ptr(),
                     torch.cuda.current_stream().cuda_stream) == 0
        assert _bitwise(out, want) == (name == "none"), name


def _selection_key(budget):
    from groundgrid_torch.core import outliers

    return outliers.selection_key(budget)


def test_march_stage_is_three_launches(cuda):
    """Under ``torch.profiler`` the march stage as the step runs it
    (``detect_outliers`` with K6, K11 and K7) on a warm scan of the
    adversarial world is 3 device activities a call, named K6's, K11's and
    K7's: no fill of the outlier flags before K7 and no comparison after
    it. (The profiler now and then drops a record, never adds one.)"""
    from groundgrid_torch.core import grid as gridlib
    from groundgrid_torch.core import outliers, scalars
    from groundgrid_torch.pipeline import scan_scalars, to_device
    from groundgrid_torch.runtime.driver import StreamingDriver
    from groundgrid_torch.runtime.kernel_timing import profiled

    cfg = GroundGridConfig(**SMALL_SORTED, sorted_scans=True)
    recs = _adversarial_records(3)
    driver = StreamingDriver(cfg, cuda)
    for rec in recs[:2]:
        driver.process(rec)
    scan, _ = driver.make_scan(recs[2])
    packed, _, _ = scan_scalars(cfg, driver.state.center_np, driver.state.center_lo_np, scan)
    s = scalars.view(to_device(packed, cuda))
    ground, conf = gridlib.move(cfg, driver.state.ground, driver.state.groundpatch, s)
    b = binning.bin_points(cfg, s, scan.px, scan.py, scan.rings, scan.valid > 0)

    def stage():
        return outliers.detect_outliers(cfg, s, ground, conf, b, scan.px, scan.py, scan.pz,
                                        march.march_budget, select.select_candidates,
                                        march.march)

    stage()
    reps = 10
    with profiled() as prof:
        for _ in range(reps):
            stage()
    dev = torch.autograd.DeviceType.CUDA
    names = [e.name for e in prof.events() if e.device_type == dev and not e.is_user_annotation]
    assert 2.9 * reps <= len(names) <= 3 * reps, names
    kernels = ("march_budget_kernel", "select_kernel", "march_kernel")
    assert all(any(k in name for k in kernels) for name in names), names
    assert all(any(k in name for name in names) for k in kernels), names


def _select_budgets(rng, b, p, n_pos, ties=True):
    """(b, p) f32 budgets, ``n_pos`` positive a row at random slots (squared
    ray lengths of 0.2 to 20 m; with ``ties`` rounded to a few values, so
    the cap falls inside groups of equal budgets), and their selection keys."""
    from groundgrid_torch.core import outliers

    out = np.zeros((b, p), np.float32)
    for r in range(b):
        slots = rng.choice(p, n_pos if np.isscalar(n_pos) else n_pos[r], replace=False)
        v = rng.uniform(0.04, 400.0, slots.shape[0]).astype(np.float32)
        out[r, slots] = (np.round(v / 40.0) * 40.0 + 0.5).astype(np.float32) if ties else v
    budget = torch.from_numpy(out)
    return budget, outliers.selection_key(budget)


# (points, marchable, k_max): under the cap, at it and over it (the radix
# select), on the truncated key (up to 2^17 points) and the exact one
SELECT_CASES = [(1, 1, 1), (77, 20, 40), (77, 60, 40), (4097, 300, 700), (4097, 700, 700),
                (5000, 900, 700), (16385, 1000, 16385), (1 << 17, 726, 8192),
                (1 << 17, 8192, 8192), (1 << 17, 9000, 8192), ((1 << 17) + 640, 5000, 3000),
                (1 << 18, 2000, 8192), (1 << 18, 12000, 8192), (262144, 262144, 8192),
                # the storms (keys in shared memory) and a tail crossing from
                # one 4,096-point chunk into the next at 16 blocks a row
                (1 << 17, 20000, 8192), (1 << 18, 20000, 8192), (1 << 16, 500, 8192)]


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "tied"])
@pytest.mark.parametrize("p,n_pos,k", SELECT_CASES)
def test_select_kernel_matches_plain(cuda, p, n_pos, k, ties):
    """K11 bitwise its plain version (the candidate indices, not only their
    set, and the marchable count), two runs bitwise, one launch each."""
    budget, key = _select_budgets(np.random.default_rng(p + n_pos), 1, p, n_pos, ties)
    budget, key = budget[0].to(cuda), key[0].to(cuda)
    before = select.select_candidates.launches
    got = select.select_candidates(budget, key, k)
    again = select.select_candidates(budget, key, k)
    assert select.select_candidates.launches == before + 2
    want = select.select_candidates_plain(budget, key, k)
    torch.cuda.synchronize()
    for g, a, w in zip(got, again, want):
        assert _bitwise(g, w) and _bitwise(a, g)
    assert int(got[1]) == n_pos


@pytest.mark.parametrize("p", [1 << 17, 1 << 18])
def test_select_kernel_batch_matches_single_launches(cuda, p):
    """K11 on 64 rows in one launch (rows under, at and over the cap, both
    keys): every row bitwise its single launch, the batch bitwise the plain
    batched version."""
    b, k = 64, 8192
    rng = np.random.default_rng(p)
    counts = [int(v) for v in rng.choice([0, 700, 8192, 9000, 20000], b)]
    budget, key = _select_budgets(rng, b, p, counts)
    budget, key = budget.to(cuda), key.to(cuda)
    got = select.select_candidates(budget, key, k)
    want = select.select_candidates_plain(budget, key, k)
    assert all(_bitwise(g, w) for g, w in zip(got, want))
    assert got[1].tolist() == counts
    for v in range(b):
        one = select.select_candidates(budget[v], key[v], k)
        assert _bitwise(got[0][v], one[0]) and _bitwise(got[1][v], one[1]), v


def test_select_kernel_cluster_shapes(cuda):
    """K11 at B = 1, 2, 7 and 64 rows of 131,072 points (rows under, at and
    over the cap): each batch bitwise its plain version and each row its
    single launch, at the cluster shape the launch's rule takes for it
    (``select.cluster_size``); the rule takes 16 blocks for one row and
    fewer for 64, so the batches cover more than one shape."""
    p, k = 1 << 17, 8192
    shapes = {}
    for b in (1, 2, 7, 64):
        rng = np.random.default_rng(b)
        counts = [int(v) for v in rng.choice([0, 726, 8192, 9000, 20000], b)]
        budget, key = _select_budgets(rng, b, p, counts)
        budget, key = budget.to(cuda), key.to(cuda)
        got = select.select_candidates(budget, key, k)
        want = select.select_candidates_plain(budget, key, k)
        assert all(_bitwise(g, w) for g, w in zip(got, want)), b
        for v in range(b):
            one = select.select_candidates(budget[v], key[v], k)
            assert _bitwise(got[0][v], one[0]) and _bitwise(got[1][v], one[1]), (b, v)
        shapes[b] = select.cluster_size(p, b, cuda)
    assert shapes[1] == 16 and shapes[64] < 16, shapes
    assert all(shapes[a] >= shapes[b] for a, b in ((1, 2), (2, 7), (7, 64))), shapes


def test_select_tail_crosses_a_chunk(cuda):
    """The tail of 2^16 points with 500 marchable and k = 8,192 runs past
    the first chunk of the single row's shape (16 blocks of 4,096 points)
    into the second: bitwise the plain version."""
    p, n_pos, k = 1 << 16, 500, 8192
    size = select.cluster_size(p, 1, cuda)
    chunk = 32 * -(-(p // 32) // size)
    assert size == 16 and n_pos + chunk < k  # the tail's last point lies past chunk 0
    budget, key = _select_budgets(np.random.default_rng(16), 1, p, n_pos)
    budget, key = budget[0].to(cuda), key[0].to(cuda)
    got = select.select_candidates(budget, key, k)
    want = select.select_candidates_plain(budget, key, k)
    assert _bitwise(got[0], want[0]) and _bitwise(got[1], want[1])
    assert int(want[0][-1]) >= chunk


# mutations of select.cu that ``test_select_kernel_matches_plain``'s cases
# must catch
SELECT_MUTATIONS = {
    "k-th key off by one": ("unsigned int remaining = (unsigned int)k;",
                            "unsigned int remaining = (unsigned int)k + 1u;"),
    "unstable partition": ("nth_bit(mask, tr - before)",
                           "nth_bit(mask, __popc(mask) - 1u - (tr - before))"),
    "zero budgets marchable": ("return b > 0.0f;", "return b >= 0.0f;"),
    "tail off by one at a chunk boundary": ("if (b <= t) r = j;", "if (b < t) r = j;"),
    "storm reads a stale shared key": ("if (ch.keys != nullptr && i < ch.len) ch.keys[i] = v[j];",
                                       "if (ch.keys != nullptr && i < ch.len - kThreads) "
                                       "ch.keys[i] = v[j];"),
}


def test_mutated_select_kernels_fail(cuda, tmp_path):
    """Each mutation of ``SELECT_MUTATIONS`` (the radix select aiming at the
    (k+1)-th key, the points of a word taken in reverse, zero budgets
    counted as marchable, a point at the first of a chunk looked for in the
    chunk before, the last 512 keys of a chunk left as the shared memory
    held them), built alone with the library's flags, differs from the
    plain version on at least one case; the source unmutated, on none.
    Before each case a launch on a row of large keys fills the shared
    memory, so a key not copied is a stale one."""
    from groundgrid_torch.core import outliers

    libs = _mutants("select.cu", SELECT_MUTATIONS, tmp_path)
    cases = []
    for p, n_pos, k in SELECT_CASES[3:]:
        budget, key = _select_budgets(np.random.default_rng(p + n_pos), 1, p, n_pos)
        budget, key = budget[0].to(cuda), key[0].to(cuda)
        poison = torch.full((p,), 1000.5, device=cuda)
        cases.append((budget, key, k, select.select_candidates_plain(budget, key, k),
                      (poison, outliers.selection_key(poison))))
    stream = torch.cuda.current_stream().cuda_stream
    for name, lib_path in libs.items():
        entry = _entry(lib_path, "gg_select")
        caught = 0
        for budget, key, k, want, poison in cases:
            pidx = torch.empty(k, dtype=torch.int64, device=cuda)
            n_m = torch.empty((), dtype=torch.int64, device=cuda)
            for b, kk in (poison, (budget, key)):
                assert entry(b.data_ptr(), kk.data_ptr(), b.shape[0], 1, k, 0, pidx.data_ptr(),
                             n_m.data_ptr(), stream) == 0
            caught += not (_bitwise(pidx, want[0]) and _bitwise(n_m, want[1]))
        assert (caught == 0) == (name == "none"), (name, caught)


def _move_case(cfg, rng, shifts, device, flat=False):
    """One grid a shift of ``shifts``: random layers with NaN (quiet and
    with a payload) and -0.0 words, and the scan scalars of a move by the
    shift (clamped to [-n, n] by ``scalars.pack``) from a random centre onto
    a tilted base plane (with ``flat`` a level one at height 0: exposed
    ground -0.0). Returns (B, N, N) layers on ``device`` and the (B,
    ``SIZE``) packed scalars in NumPy."""
    from groundgrid_torch.core import scalars

    n = cfg.cell_count
    rows = []
    for k in shifts:
        g = rng.normal(-1.7, 0.4, (n, n)).astype(np.float32)
        c = rng.uniform(0.0, 1.0, (n, n)).astype(np.float32)
        g[0, :3] = np.nan
        g.view(np.int32)[n // 2, n // 3] = 0x7FC01234
        g[1, 1], c[2, n - 1], c[n - 1, 0] = -0.0, -0.0, np.nan
        tb = np.eye(4, dtype=np.float32)
        if not flat:
            tb[2, 0], tb[2, 1] = rng.normal(0, 0.02, 2)
            tb[2, 3] = rng.normal(-1.7, 0.2)
        else:
            tb[2, 3] = 0.0
        center = rng.normal(0, 40, 2).astype(np.float32)
        rows.append((g, c, scalars.pack(cfg, center, None, k, np.eye(4), np.eye(4), tb)))
    g, c, packed = (np.stack(a) for a in zip(*rows))
    return torch.from_numpy(g).to(device), torch.from_numpy(c).to(device), packed


def _scalars(packed, device):
    from groundgrid_torch.core import scalars

    return scalars.view(torch.from_numpy(packed).to(device))


def _move_shifts(n):
    return [(0, 0), (1, 0), (0, -1), (-1, 1), (37, -37), (-37, 5), (n - 1, 0), (0, 1 - n),
            (n, 2), (-n, -n), (n + 9, -3), (-500, 700)]


@pytest.mark.parametrize("flat", [False, True], ids=["tilted", "flat"])
@pytest.mark.parametrize("dimension,resolution", [(7.0, 1.0), (40.0, 0.5), (120.0, 0.33),
                                                  (400.0, 0.33)])
def test_move_kernel_matches_plain(cuda, dimension, resolution, flat):
    """K12 bitwise the plain move (NaN and -0.0 rolled bit for bit, the
    exposed cells' base plane, -0.0 on a level plane at height 0) for every
    shift of ``_move_shifts``; two runs bitwise; the inputs untouched."""
    cfg = GroundGridConfig(dimension=dimension, resolution=resolution)
    n = cfg.cell_count
    shifts = _move_shifts(n)
    g, c, packed = _move_case(cfg, np.random.default_rng(n), shifts, cuda, flat)
    for v, k in enumerate(shifts):
        s = _scalars(packed[v], cuda)
        g0, c0 = g[v].clone(), c[v].clone()
        before = move.move.launches
        got = move.move(cfg, g[v], c[v], s)
        again = move.move(cfg, g[v], c[v], s)
        assert move.move.launches == before + 2
        want = move.move_plain(cfg, g[v], c[v], s)
        torch.cuda.synchronize()
        assert _bitwise(g[v], g0) and _bitwise(c[v], c0), k
        for x, a, w in zip(got, again, want):
            assert _bitwise(x, w) and _bitwise(a, x), k


def test_move_kernel_batch_matches_single_launches(cuda):
    """K12 on 64 grids at 364^2 in one launch, each its own shift (a wipe
    among them), centre and plane: every grid bitwise its single launch,
    the batch bitwise the plain batched move."""
    cfg = GroundGridConfig()
    n = cfg.cell_count
    rng = np.random.default_rng(64)
    shifts = [tuple(int(v) for v in rng.integers(-4, 5, 2)) for _ in range(61)]
    shifts += [(0, 0), (n, -3), (-n - 7, 2)]
    g, c, packed = _move_case(cfg, rng, shifts, cuda)
    sb = _scalars(packed, cuda)
    got = move.move(cfg, g, c, sb)
    want = move.move_plain(cfg, g, c, sb)
    assert all(_bitwise(x, w) for x, w in zip(got, want))
    for v in range(64):
        one = move.move(cfg, g[v], c[v], _scalars(packed[v], cuda))
        assert _bitwise(got[0][v], one[0]) and _bitwise(got[1][v], one[1]), v


def test_move_kernel_reads_scalars_at_replay(cuda):
    """K12 captured in a CUDA graph on one move's scan scalars and replayed
    after others are copied in (a step, no shift, a wipe): bitwise the
    eager plain move of each (the kernel reads the shift, centre and plane
    when it runs)."""
    cfg = GroundGridConfig(dimension=40.0, resolution=0.5)
    n = cfg.cell_count
    shifts = [(2, -1), (0, 0), (-n, 4), (5, 5)]
    g, c, packed = _move_case(cfg, np.random.default_rng(5), shifts, cuda)
    ground, conf, buf = g[0].clone(), c[0].clone(), torch.from_numpy(packed[0]).to(cuda)
    from groundgrid_torch.core import scalars

    move.move(cfg, ground, conf, scalars.view(buf))  # build and warm
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = move.move(cfg, ground, conf, scalars.view(buf))
    for v in (1, 2, 3, 0):
        buf.copy_(torch.from_numpy(packed[v]).to(cuda))
        graph.replay()
        want = move.move_plain(cfg, ground, conf, _scalars(packed[v], cuda))
        torch.cuda.synchronize()
        assert _bitwise(out[0], want[0]) and _bitwise(out[1], want[1]), shifts[v]


# mutations of move.cu that ``test_move_kernel_matches_plain``'s cases must
# catch. Deleting exposed()'s ``(k >= n) | (k <= -n)`` alone changes
# nothing (for |k| >= n the axis test already holds on every index); the
# wipe is lost where the shift is reduced modulo n before the test, as a
# roll reduces it
MOVE_MUTATIONS = {
    "exposed edge off by one": ("return (k >= 0 ? idx < k : idx >= n + k)",
                                "return (k >= 0 ? idx <= k : idx >= n + k)"),
    "wipe dropped (shift mod n)": (
        "const int k0 = __float_as_int(sc[5]), k1 = __float_as_int(sc[6]);",
        "const int k0 = __float_as_int(sc[5]) % n, k1 = __float_as_int(sc[6]) % n;"),
    "z_base contracted to an FMA": (
        "gg::add(gg::add(gg::mul(b20, px), gg::mul(b21, py)), b23)",
        "gg::add(__fmaf_rn(b20, px, gg::mul(b21, py)), b23)"),
    "rolled backwards": ("const int s = idx - k;", "const int s = idx + k;"),
    "vector path takes the wrong run": ("const int qb = qa + 1 < nw ? qa + 1 : 0;",
                                        "const int qb = qa + 1 < nw ? qa + 1 : qa;"),
}


def test_mutated_move_kernels_fail(cuda, tmp_path):
    """Each mutation of ``MOVE_MUTATIONS`` (an exposed edge one cell off, the
    wipe lost to a shift reduced mod n, the base plane's product and sum
    contracted into an FMA, the roll backwards, the four cells that wrap
    past a row's end taken from its last word again instead of its first
    run; n = 364 takes the vector path), built alone with the
    library's flags, differs from the plain move on at least one case of
    ``_move_shifts``; the source unmutated, on none."""
    from groundgrid_torch.core import scalars

    libs = _mutants("move.cu", MOVE_MUTATIONS, tmp_path)
    cfg = GroundGridConfig(dimension=120.0, resolution=0.33)
    n = cfg.cell_count
    g, c, packed = _move_case(cfg, np.random.default_rng(1), _move_shifts(n), cuda)
    cases = []
    for v in range(g.shape[0]):
        s = _scalars(packed[v], cuda)
        cases.append((g[v], c[v], s, move.move_plain(cfg, g[v], c[v], s)))
    for name, lib_path in libs.items():
        entry = _entry(lib_path, "gg_move")
        caught = 0
        for gv, cv, s, want in cases:
            base, stride = scalars.device_rows(s, gv.flatten())
            out = torch.empty_like(gv), torch.empty_like(cv)
            assert entry(gv.data_ptr(), cv.data_ptr(), n, 1, base, stride,
                         float(np.float32(cfg.half_length)), float(np.float32(cfg.resolution)),
                         out[0].data_ptr(), out[1].data_ptr(),
                         torch.cuda.current_stream().cuda_stream) == 0
            caught += not (_bitwise(out[0], want[0]) and _bitwise(out[1], want[1]))
        assert (caught == 0) == (name == "none"), (name, caught)


def _raster_cases(device):
    """The raster stage's seam cases of ``raster_scenes``: ``(name, config,
    s, binning, z, outlier, order, shards)``; ``shards`` cuts the points
    into that many chunks, each read through its own stable sort."""
    import raster_scenes

    for name, seeds, sort, shards in (("seams-sorted", (0,), False, 1),
                                      ("seams-argsort", (1,), True, 1),
                                      ("batch-3", (3, 4, 5), True, 1),
                                      ("shards-4", (4,), True, 4), ("shards-8", (8,), True, 8)):
        cfg, s, b, z, outlier = raster_scenes.seam_inputs(seeds, device=device, sort=not sort)
        order = torch.argsort(b.cell, dim=-1, stable=True) if sort else None
        yield name, cfg, s, b, z, outlier, order, shards


def _raster_chunks(b, z, outlier, order, shards):
    """``(binning, z, outlier, order)`` of each shard's chunk of points."""
    from groundgrid_torch.core.rasterize import Binning

    if shards == 1:
        return [(b, z, outlier, order)]
    bounds = np.linspace(0, z.shape[-1], shards + 1).astype(int)
    out = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        chunk = Binning(*(t[..., lo:hi].contiguous() for t in b))
        out.append((chunk, z[..., lo:hi].contiguous(), outlier[..., lo:hi].contiguous(),
                    torch.argsort(chunk.cell, dim=-1, stable=True)))
    return out


def _raster_run(cfg, s, chunks, columns, finish, aux):
    """The raster stage over ``chunks`` by ``columns`` and ``finish`` (the
    kernels' wrappers or their plain versions), K1 between: each chunk's
    ids and columns, and the layers."""
    from groundgrid_torch.core.rasterize import COLUMN_OPS

    n2 = cfg.cell_count ** 2
    cols = [columns(cfg, cb, cz, co, s, order) for cb, cz, co, order in chunks]
    parts = [raster.raster_reduce(cell, c, COLUMN_OPS, n2) for cell, c in cols]
    return cols, finish(cfg, parts, s, aux)


def _same_raster(got, want):
    (cols_g, layers_g), (cols_w, layers_w) = got, want
    for (cell_g, c_g), (cell_w, c_w) in zip(cols_g, cols_w):
        if not (_bitwise(cell_g, cell_w) and all(_bitwise(a, b) for a, b in zip(c_g, c_w))):
            return "K9"
    for name, g, w in zip(layers_w._fields, layers_g, layers_w):
        if (g is None) != (w is None) or (g is not None and not _bitwise(g, w)):
            return f"K10 {name}"
    return None


def test_raster_stage_kernels_match_plain(cuda):
    """K9 and K10 on the seams of ``raster_scenes`` (sorted and through the
    sort's order, a batch of 3, 4 and 8 shards; all layers with the max,
    and the main path's three): bitwise their plain versions on the card,
    two runs bitwise."""
    reset_launch_counts()
    runs = 0
    for name, cfg, s, b, z, outlier, order, shards in _raster_cases(cuda):
        chunks = _raster_chunks(b, z, outlier, order, shards)
        for aux in (True, False):
            want = _raster_run(cfg, s, chunks, raster_stage.raster_columns_ordered_plain,
                              raster_stage.finish_layers_plain, aux)
            got = _raster_run(cfg, s, chunks, raster_stage.raster_columns_ordered,
                             raster_stage.finish_layers, aux)
            again = _raster_run(cfg, s, chunks, raster_stage.raster_columns_ordered,
                               raster_stage.finish_layers, aux)
            assert _same_raster(got, want) is None, (name, aux, _same_raster(got, want))
            assert _same_raster(again, got) is None, (name, "two runs")
            runs += 2
            shards_run = len(chunks)
    counts = launch_counts()
    assert counts["raster_finish"] == runs and counts["raster_columns"] >= runs
    assert shards_run == 8


def test_raster_finish_main_layers_read_no_z_sum(cuda):
    """K10 without the aux layers reads no z sum: NaN in column 2 of every
    shard leaves its three layers bitwise the plain version's on the clean
    columns (sorted, through the sort's order, a batch, 4 and 8 shards)."""
    from groundgrid_torch.core.rasterize import COLUMN_OPS, MAIN_LAYERS

    for name, cfg, s, b, z, outlier, order, shards in _raster_cases(cuda):
        chunks = _raster_chunks(b, z, outlier, order, shards)
        cols = [raster_stage.raster_columns_ordered(cfg, cb, cz, co, s, o)
                for cb, cz, co, o in chunks]
        parts = [raster.raster_reduce(cell, c, COLUMN_OPS, cfg.cell_count ** 2)
                 for cell, c in cols]
        poisoned = [[torch.full_like(c, float("nan")) if j == 2 else c for j, c in enumerate(p)]
                    for p in parts]
        got = raster_stage.finish_layers(cfg, poisoned, s)
        want = raster_stage.finish_layers_plain(cfg, parts, s)
        for layer in MAIN_LAYERS:
            assert _bitwise(getattr(got, layer), getattr(want, layer)), (name, layer)


def test_raster_stage_batch_matches_single_launches(cuda):
    """K9 and K10 on a batch of 64 seam scenes (each its own scan scalars),
    one launch each: every row bitwise its single launch, and the batch
    bitwise the plain batched versions."""
    import raster_scenes
    from groundgrid_torch.core import scalars
    from groundgrid_torch.core.rasterize import COLUMN_OPS, Binning

    seeds = tuple(range(100, 164))
    cfg, s, b, z, outlier = raster_scenes.seam_inputs(seeds, p=4096, device=cuda)
    order = torch.argsort(b.cell, dim=-1, stable=True)
    n2 = cfg.cell_count ** 2
    cell, cols = raster_stage.raster_columns_ordered(cfg, b, z, outlier, s, order)
    plain = raster_stage.raster_columns_ordered_plain(cfg, b, z, outlier, s, order)
    assert _bitwise(cell, plain[0]) and all(_bitwise(g, w) for g, w in zip(cols, plain[1]))
    part = raster.raster_reduce(cell, cols, COLUMN_OPS, n2)
    layers = raster_stage.finish_layers(cfg, [part], s, True)
    want = raster_stage.finish_layers_plain(cfg, [part], s, True)
    assert all(_bitwise(g, w) for g, w in zip(layers, want))
    full = s.ox._base  # the (B, SIZE) scan scalars
    assert full.shape == (len(seeds), scalars.SIZE)
    for v in range(len(seeds)):
        sv = scalars.view(full[v])
        bv = Binning(*(t[v] for t in b))
        c1, k1 = raster_stage.raster_columns_ordered(cfg, bv, z[v], outlier[v], sv, order[v])
        assert _bitwise(c1, cell[v]) and all(_bitwise(g[v], w) for g, w in zip(cols, k1)), v
        p1 = raster.raster_reduce(c1, k1, COLUMN_OPS, n2)
        l1 = raster_stage.finish_layers(cfg, [p1], sv, True)
        assert all(_bitwise(g[v], w) for g, w in zip(layers, l1)), v


def test_raster_stage_reads_scalars_at_replay(cuda):
    """K9 and K10 captured in one CUDA graph on scene A's scan scalars and
    replayed after scene B's are copied in: bitwise the eager calls on B."""
    import raster_scenes
    from groundgrid_torch.core import scalars
    from groundgrid_torch.core.rasterize import COLUMN_OPS

    scenes = [raster_scenes.seam_inputs((seed,), device=cuda) for seed in (20, 21)]
    cfg = scenes[0][0]
    n2 = cfg.cell_count ** 2
    packed = [sc[1].ox._base for sc in scenes]  # each scene's (SIZE,) scan scalars
    assert all(t.shape == (scalars.SIZE,) for t in packed)
    buf = packed[0].clone()
    static = [t.clone() for t in (*scenes[0][2], scenes[0][3], scenes[0][4])]

    def stage(s):
        from groundgrid_torch.core.rasterize import Binning

        b = Binning(*static[:6])
        order = torch.argsort(b.cell, stable=True)
        cell, cols = raster_stage.raster_columns_ordered(cfg, b, static[6], static[7], s, order)
        part = raster.raster_reduce(cell, cols, COLUMN_OPS, n2)
        return (cell, *cols, *raster_stage.finish_layers(cfg, [part], s, True))

    stage(scalars.view(buf))
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = stage(scalars.view(buf))
    for k in (1, 0):
        buf.copy_(packed[k])
        for dst, src in zip(static, (*scenes[k][2], scenes[k][3], scenes[k][4])):
            dst.copy_(src)
        graph.replay()
        want = stage(scalars.view(packed[k]))
        torch.cuda.synchronize()
        assert all(_bitwise(g, w) for g, w in zip(out, want)), k
    assert not _bitwise(out[-1], stage(scalars.view(packed[1]))[-1])  # the scenes differ


# mutations of raster_stage.cu that the seam cases must catch
RASTER_STAGE_MUTATIONS = {
    "plane shift contracted": ("gg::add(gg::mul(s[kB20], xc), gg::mul(s[kB21], yc))",
                               "__fmaf_rn(s[kB20], xc, gg::mul(s[kB21], yc))"),
    "shards folded in reverse": ("a.cols[sh][j][k];", "a.cols[shards - sh][j][k];"),
    "gi1 off the id": ("cell - gi0 * n, res", "cell - gi0 * n + 1, res"),
    "count > 0 gate >=": ("count > 0.0f ? gg::add(", "count >= 0.0f ? gg::add("),
    "min epsilon dropped": ("gg::sub(zmin, 1e-4f)", "zmin"),
    "sentinel test flipped": ("(zmin < 1e30f)", "(zmin > 1e30f)"),
    "max reset dropped": ("gg::clamp_min(zmax, kFltTiny)", "zmax"),
    "empty shards fold": ("has_w ? w[5] : kMinSent", "w[5]"),
    "outliers accepted": ("in & !a.ignored[k] & !a.outlier[k]", "in & !a.ignored[k]"),
    "order ignored": ("(size_t)a.order[row + i]", "(size_t)i"),
}


def test_mutated_raster_stage_kernels_fail(cuda, tmp_path):
    """Each mutation of ``RASTER_STAGE_MUTATIONS`` (the plane shift
    contracted into an FMA, the shards folded in reverse, a gate or a
    sentinel test flipped, the min epsilon or the max reset dropped, an
    empty shard's zeros folded, outliers accepted, the order ignored, the
    column index taken off the cell id wrongly), built alone with the
    library's flags, differs from the plain stage (all layers) on at least
    one seam case; the source unmutated, on none."""
    import ctypes
    import math

    from groundgrid_torch.core import scalars

    libs = _mutants("raster_stage.cu", RASTER_STAGE_MUTATIONS, tmp_path)
    cases = []
    for name, cfg, s, b, z, outlier, order, shards in _raster_cases(cuda):
        chunks = _raster_chunks(b, z, outlier, order, shards)
        want = _raster_run(cfg, s, chunks, raster_stage.raster_columns_ordered_plain,
                          raster_stage.finish_layers_plain, True)
        cases.append((name, cfg, s, chunks, want))
    stream = torch.cuda.current_stream().cuda_stream
    for mutant, lib_path in libs.items():
        columns_entry = _entry(lib_path, "gg_raster_columns")
        finish_entry = _entry(lib_path, "gg_raster_finish")

        def columns(cfg, cb, cz, co, s, order):
            base, stride = scalars.device_rows(s, cz)
            cell = torch.full(cz.shape, -7, dtype=torch.int32, device=cuda)
            cols = torch.full((7, *cz.shape), 3.5, device=cuda)
            assert columns_entry(
                None if order is None else order.data_ptr(),
                *(t.data_ptr() for t in (cb.cell, cb.inmap, cb.ignored, co, cz)),
                cz.shape[-1], math.prod(cz.shape[:-1]), cfg.cell_count, base, stride,
                float(np.float32(cfg.resolution)), cell.data_ptr(),
                cols.data_ptr(), stream) == 0
            return cell, list(cols.unbind(0))

        def finish(cfg, parts, s, aux):
            first = parts[0][0]
            base, stride = scalars.device_rows(s, first)
            out = torch.full((len(raster_stage.KERNEL_LAYERS), *first.shape[:-1],
                              cfg.cell_count, cfg.cell_count), 9.5, device=cuda)
            col_ptrs = (ctypes.c_void_p * (7 * len(parts)))(
                *[c.data_ptr() for part in parts for c in part])
            assert finish_entry(ctypes.addressof(col_ptrs), len(parts), cfg.cell_count,
                                math.prod(first.shape[:-1]), base, stride,
                                float(np.float32(cfg.resolution)), int(aux), out.data_ptr(),
                                stream) == 0
            layers = dict(zip(raster_stage.KERNEL_LAYERS, out.unbind(0)))
            return raster_stage.RasterLayers(**layers, mean_variance=layers["plane_dist"])

        caught = []
        for name, cfg, s, chunks, want in cases:
            got = _raster_run(cfg, s, chunks, columns, finish, True)
            if _same_raster(got, want) is not None:
                caught.append(name)
        if mutant == "none":
            assert not caught, f"the unmutated source failed {caught}"
        else:
            assert caught, f"mutation {mutant!r} passed every case"


@pytest.mark.parametrize("b,p,offset", [(1, 4097, 0), (1, 4096, 1), (3, 2050, 0), (4, 7, 0),
                                        (2, 1001, 3), (1, 1, 0)])
def test_binning_groups_cut_by_rows_and_alignment(cuda, b, p, offset):
    """K5's groups of points: rows that do not start on a group (p not a
    multiple of the vector width, in a batch), a tail, arrays offset from
    their alignment (the scalar path), tiny scans; bitwise the plain
    version, two runs bitwise."""
    from groundgrid_torch.core import scalars, transforms

    cfg = GroundGridConfig(**dict(SMALL_SORTED, max_points=max(p, 8)), max_ring=60)
    rng = np.random.default_rng(p + offset)
    pts = [_random_points(rng, cfg, p) for _ in range(b)]

    def on_card(a):  # ``offset`` elements into a fresh buffer
        flat = np.concatenate([np.zeros(offset, a.dtype), a.reshape(-1)])
        t = torch.from_numpy(flat).to(cuda)[offset:]
        return t.view(b, p) if b > 1 else t

    x, y, _, rings, valid = (on_card(np.stack(a)) for a in zip(*pts))
    rows = [scalars.pack(cfg, rng.normal(0, 0.2, 2).astype(np.float32), np.zeros(2, np.float32),
                         (0, 0), transforms.translation(*rng.normal(0, 0.5, 2), 1.7), np.eye(4),
                         np.eye(4)) for _ in range(b)]
    s = scalars.view(torch.from_numpy(np.stack(rows) if b > 1 else rows[0]).to(cuda))
    want = binning.bin_points_plain(cfg, s, x, y, rings, valid)
    got, again = (binning.bin_points(cfg, s, x, y, rings, valid) for _ in range(2))
    for f, g, a, w in zip(want._fields, got, again, want):
        assert _bitwise(g, w), f
        assert _bitwise(a, g), f


# a mutation of binning.cu's scalar path (a group cut by the row's end)
BINNING_MUTATIONS = {
    "tail drops its last point": ("for (long long k = lo; k < hi; ++k)",
                                  "for (long long k = lo; k < hi - 1; ++k)"),
}


def test_mutated_binning_kernels_fail(cuda, tmp_path):
    """The mutation of ``BINNING_MUTATIONS``, built alone with the library's
    flags, leaves a point of a 4097-point scan unwritten (outputs filled
    with a sentinel first); the source unmutated writes every point as the
    plain version."""
    import math

    from groundgrid_torch.core import exactf32, scalars, transforms
    from groundgrid_torch.core.rasterize import Binning

    libs = _mutants("binning.cu", BINNING_MUTATIONS, tmp_path)
    p = 4097
    cfg = GroundGridConfig(**dict(SMALL_SORTED, max_points=p), max_ring=60)
    rng = np.random.default_rng(5)
    x, y, _, rings, valid = (torch.from_numpy(a).to(cuda) for a in _random_points(rng, cfg, p))
    packed = scalars.pack(cfg, np.zeros(2, np.float32), np.zeros(2, np.float32), (0, 0),
                          transforms.translation(0.3, -0.2, 1.7), np.eye(4), np.eye(4))
    s = scalars.view(torch.from_numpy(packed).to(cuda))
    want = binning.bin_points_plain(cfg, s, x, y, rings, valid)
    base, stride = scalars.device_rows(s, x)
    rh, rl, inv = exactf32.res_ds(cfg.resolution)
    for name, lib_path in libs.items():
        out = Binning(*(torch.full_like(t, 1 if t.dtype == torch.bool else 77) for t in want))
        out = out._replace(inmap=torch.ones_like(want.inmap) ^ want.inmap)  # every flag wrong
        assert _entry(lib_path, "gg_bin")(
            x.data_ptr(), y.data_ptr(), rings.data_ptr(), valid.data_ptr(), p, 1, base, stride,
            cfg.cell_count, float(rh), float(rl), float(inv), int(cfg.max_ring),
            float(np.float32(cfg.min_dist_squared)), *(t.data_ptr() for t in out),
            torch.cuda.current_stream().cuda_stream) == 0
        same = all(_bitwise(g, w) for g, w in zip(out, want))
        assert same == (name == "none"), name
    assert math.prod(want.cell.shape) == p


def test_wrappers_reject_bad_input(cuda):
    cell = torch.zeros(8, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        lookup.lookup(cell, [torch.zeros(4, device=cuda)], 4)
    with pytest.raises(ValueError):
        raster.raster_reduce(cell.int(), [torch.zeros(8, device=cuda)], ["mean"], 4)
    cfg = GroundGridConfig(dimension=12.0, resolution=0.5)
    with pytest.raises(ValueError):
        spiral.spiral_interpolation(cfg, torch.zeros(3, 3, device=cuda),
                                    torch.zeros(3, 3, device=cuda), 0.0)


def test_small_step_on_card_matches_cpu(cuda):
    from groundgrid_torch.data.synthetic import synthetic_sequence
    from groundgrid_torch.runtime.driver import ScanRecord, StreamingDriver

    cfg = GroundGridConfig(dimension=40.0, resolution=0.5, max_points=16384, ray_steps=40,
                           max_outlier_candidates=1024, sorted_scans=True)
    scans = list(synthetic_sequence(3, seed=7, n_beams=24, n_azimuth=720, step_m=1.5))
    recs = [ScanRecord(index=i, timestamp=0.1 * i, points=p, labels=l, t_map_velo=T)
            for i, (p, l, T) in enumerate(scans)]
    cpu, gpu = StreamingDriver(cfg, device="cpu"), StreamingDriver(cfg, device=cuda)
    reset_launch_counts()
    total = mism = 0
    for rec in recs:
        a, b = cpu.process(rec), gpu.process(rec)
        total += a.labels.size
        mism += int((a.labels != b.labels).sum())
    assert launch_counts() == _path(3, detect=0)
    assert mism <= 0.001 * total
    assert gpu.step.fallbacks == 0
    np.testing.assert_array_equal(gpu.state.center.numpy(), cpu.state.center.numpy())
    plain = StreamingDriver(dataclasses.replace(cfg, use_pallas=False), device=cuda)
    reset_launch_counts()
    for rec in recs:
        plain.process(rec)
    assert not any(launch_counts().values())


def test_layers_path_step_on_card_matches_cpu(cuda):
    """Fused detect, aux layers and wire ingest: the card against the CPU."""
    from groundgrid_torch.data.synthetic import synthetic_sequence
    from groundgrid_torch.runtime.driver import ScanRecord, StreamingDriver

    cfg = GroundGridConfig(dimension=40.0, resolution=0.5, max_points=16384, ray_steps=40,
                           max_outlier_candidates=1024, sorted_scans=True, wire_format=True,
                           fused_detect=True)
    scans = list(synthetic_sequence(3, seed=7, n_beams=24, n_azimuth=720, step_m=1.5))
    recs = [ScanRecord(index=i, timestamp=0.1 * i, points=p, labels=l, t_map_velo=T)
            for i, (p, l, T) in enumerate(scans)]
    cpu = StreamingDriver(cfg, "cpu", with_aux=True)
    gpu = StreamingDriver(cfg, cuda, with_aux=True)
    reset_launch_counts()
    total = mism = 0
    for rec in recs:
        a, b = cpu.process(rec), gpu.process(rec)
        total += a.labels.size
        mism += int((a.labels != b.labels).sum())
        for name in ("points_raw", "min_ground_height", "max_ground_height"):
            np.testing.assert_array_equal(b.aux[name], a.aux[name], err_msg=name)
        np.testing.assert_array_equal(b.x, a.x)
    assert launch_counts() == _path(3, detect=3, raster=6)
    assert mism <= 0.001 * total
    assert gpu.step.fallbacks == 0


def test_unsorted_step_on_card_matches_cpu(cuda):
    """Unsorted mode: the device transform bitwise the CPU's (each product
    and sum its own rounded op on both), K1-K3 launched, labels as on the
    CPU; through the driver (shipped center) and ``pad_scan`` (center
    recurrence)."""
    from groundgrid_torch import pipeline
    from groundgrid_torch.data.synthetic import synthetic_sequence
    from groundgrid_torch.runtime.driver import ScanRecord, StreamingDriver

    cfg = GroundGridConfig(dimension=40.0, resolution=0.5, max_points=16384, ray_steps=40,
                           max_outlier_candidates=1024)
    assert not cfg.sorted_scans
    scans = list(synthetic_sequence(3, seed=7, n_beams=24, n_azimuth=720, step_m=1.5))
    recs = [ScanRecord(index=i, timestamp=0.1 * i, points=p, labels=l, t_map_velo=T)
            for i, (p, l, T) in enumerate(scans)]
    cpu, gpu = StreamingDriver(cfg, "cpu", with_aux=True), StreamingDriver(cfg, cuda,
                                                                           with_aux=True)
    reset_launch_counts()
    total = mism = 0
    for rec in recs:
        a, b = cpu.process(rec), gpu.process(rec)
        total += a.labels.size
        mism += int((a.labels != b.labels).sum())
        for k in "xyz":
            np.testing.assert_array_equal(getattr(b, k), getattr(a, k), err_msg=k)
        assert b.aux["points"].sum() == (b.labels == 99).sum()
    assert launch_counts() == _path(3, detect=0, raster=6)
    assert mism <= 0.001 * total
    assert gpu.step.fallbacks == 0
    np.testing.assert_array_equal(gpu.state.center.numpy(), cpu.state.center.numpy())

    # center-less scans (the host center recurrence) run on the eager step
    step_cpu, step_gpu = pipeline.make_step_fn(cfg), pipeline.make_step_fn(cfg)
    s_cpu = pipeline.init_state(cfg, scans[0][2], "cpu")
    s_gpu = pipeline.init_state(cfg, scans[0][2], cuda)
    for pts, labels, T in scans:
        s_cpu, o_cpu = step_cpu(s_cpu, pipeline.pad_scan(cfg, pts, labels, T, "cpu"))
        s_gpu, o_gpu = step_gpu(s_gpu, pipeline.pad_scan(cfg, pts, labels, T, cuda))
        np.testing.assert_array_equal(o_gpu.x.cpu().numpy(), o_cpu.x.numpy())
        np.testing.assert_array_equal(s_gpu.center.numpy(), s_cpu.center.numpy())
        np.testing.assert_array_equal(s_gpu.center_lo.numpy(), s_cpu.center_lo.numpy())
        assert (o_gpu.labels.cpu() != o_cpu.labels).float().mean() <= 0.001


@pytest.mark.parametrize("p_total", [1 << 17, 1 << 18])
def test_march_shedding_on_card_matches_cpu(cuda, p_total):
    """The occlusion march with more marchable candidates (800) than
    ``max_outlier_candidates`` (450), the cut inside a group of equal
    budgets: the outlier set on the card is bitwise the CPU's, on the
    truncated key (2^17 points) and on the exact-budget key (2^18)."""
    from groundgrid_torch.core import outliers, rasterize, scalars, transforms

    cfg = GroundGridConfig(dimension=40.0, resolution=0.5, max_points=p_total, ray_steps=40,
                           max_outlier_candidates=450)
    n = cfg.cell_count
    rng = np.random.default_rng(0)

    def ring(k, r0, r1, z):
        ang, r = rng.uniform(0, 2 * np.pi, k), rng.uniform(r0, r1, k)
        return np.stack([r * np.cos(ang), r * np.sin(ang), np.full(k, z)], 1)

    # 300 long rays, 300 identical ones, 200 short ones below a flat
    # confident terrain, 5000 points above it; shuffled over the buffer
    pts = np.concatenate([ring(300, 12.0, 17.0, -2.0), np.tile([[10.0, 3.0, -2.5]], (300, 1)),
                          ring(200, 5.0, 7.0, -1.0), ring(5000, 4.0, 18.0, 0.5)])
    slots = rng.permutation(p_total)[: pts.shape[0]]
    xyz = np.zeros((3, p_total), np.float32)
    xyz[:, slots] = pts.T
    valid = np.zeros(p_total, bool)
    valid[slots] = True
    center = lo = np.zeros(2, np.float32)
    packed = scalars.pack(cfg, center, lo, (0, 0), transforms.translation(0.0, 0.0, 1.7),
                          np.eye(4), np.eye(4))

    def run(dev):
        x, y, z = (torch.from_numpy(a).to(dev) for a in xyz)
        s = scalars.view(torch.from_numpy(packed).to(dev))
        ground = torch.zeros((n, n), dtype=torch.float32, device=dev)
        conf = torch.ones((n, n), dtype=torch.float32, device=dev)
        b = rasterize.bin_points(cfg, s, x, y,
                                 torch.zeros(p_total, dtype=torch.int32, device=dev),
                                 torch.from_numpy(valid).to(dev))
        got, marchable = outliers.detect_outliers(cfg, s, ground, conf, b, x, y, z,
                                                  march.march_budget, select.select_candidates,
                                                  march.march)
        return got.cpu().numpy(), marchable

    want, want_marchable = run("cpu")
    before = march.march.launches
    got, marchable = run(cuda)
    assert march.march.launches > before
    assert marchable == want_marchable == 800
    assert int(want.sum()) == 450
    np.testing.assert_array_equal(got, want)


def test_device_evaluator_on_card_matches_cpu(cuda):
    """The int32 ``index_add_`` table on the card: counts equal the CPU's."""
    from groundgrid_torch.eval.device import DeviceEvaluator

    rng = np.random.default_rng(4)
    evs = {d: DeviceEvaluator("00", d, drain_every=2) for d in ("cpu", cuda)}
    for _ in range(5):
        gt = rng.choice([0, 10, 40, 44, 48, 50, 70, 72, 252, 400], 131072).astype(np.int32)
        pred = rng.choice([0, 49, 99], 131072, p=[0.05, 0.8, 0.15]).astype(np.int32)
        for d, ev in evs.items():
            ev.add_cloud_device(torch.from_numpy(pred).to(d), torch.from_numpy(gt).to(d))
    a, b = evs["cpu"].to_host(), evs[cuda].to_host()
    for name in ("nonground_count", "true_positive", "false_positive", "total"):
        np.testing.assert_array_equal(getattr(b, name), getattr(a, name), err_msg=name)


@pytest.mark.parametrize("wire", [False, True], ids=["sorted", "wire"])
def test_native_loader_on_card_matches_prepare_scan(cuda, tmp_path, wire):
    """Loader scans on the card (pinned copies from fresh buffers) equal
    ``prepare_scan`` / ``prepare_scan_wire`` on the card."""
    from groundgrid_torch.data import native_loader as nl
    from groundgrid_torch.data.semantickitti import SemanticKITTI, write_sequence
    from groundgrid_torch.data.synthetic import synthetic_sequence
    from groundgrid_torch.pipeline import CenterTracker, prepare_scan, prepare_scan_wire

    if nl.load_library() is None:
        pytest.skip("native loader not built (no C++ toolchain?)")
    cfg = GroundGridConfig(dimension=40.0, resolution=0.5, max_points=16384, ray_steps=40,
                           max_outlier_candidates=1024, sorted_scans=True, wire_format=wire)
    write_sequence(str(tmp_path), 0, synthetic_sequence(6, seed=7, n_beams=24, n_azimuth=720))
    ds = SemanticKITTI(str(tmp_path), 0)
    kind = nl.WirePrefetchingLoader if wire else nl.SortedPrefetchingLoader
    loader = kind(ds, cfg, cuda)
    assert loader.native
    got = list(loader)  # all scans in flight at once: no buffer may be reused
    loader.close()
    prep = prepare_scan_wire if wire else prepare_scan
    tracker = None
    for rec_p in got:
        rec = ds.read_scan(rec_p.index)
        pos = np.asarray(rec.t_map_velo, np.float64)[:2, 3]
        tracker = tracker or CenterTracker(cfg, pos)
        want, order = prep(cfg, rec.points[:, :3], rec.labels, rec.t_map_velo,
                           tracker.update(pos), cuda)
        np.testing.assert_array_equal(rec_p.order, order)
        for f in ("qx", "qy", "qz", "rings") if wire else ("px", "py", "pz", "rings", "valid"):
            a, b = getattr(rec_p.scan, f), getattr(want, f)
            assert a.device == b.device and torch.equal(a, b), f


def _small_fleet_streams(n_vehicles, n_scans):
    from groundgrid_torch.data.synthetic import synthetic_sequence
    from groundgrid_torch.runtime.driver import ScanRecord

    return [[ScanRecord(index=k, timestamp=0.1 * k, points=p, labels=l, t_map_velo=T)
             for k, (p, l, T) in enumerate(synthetic_sequence(n_scans, seed=30 + v, n_beams=24,
                                                              n_azimuth=720, step_m=1.5))]
            for v in range(n_vehicles)]


@pytest.mark.parametrize("sorted_scans", [True, False])
def test_fleet_on_card_matches_streaming(cuda, sorted_scans):
    """The fleet on the card equals one StreamingDriver per vehicle on the
    card, bitwise; each tick launches K1, K2, K3, K5, K6 and K7 x1
    per vehicle (sorted), or once each for the whole batch (unsorted: one
    batched step, captured from the second tick on)."""
    from groundgrid_torch.runtime.driver import StreamingDriver
    from groundgrid_torch.runtime.fleet import FleetDriver

    cfg = GroundGridConfig(dimension=40.0, resolution=0.5, max_points=16384, ray_steps=40,
                           max_outlier_candidates=1024, sorted_scans=sorted_scans)
    streams = _small_fleet_streams(4, 3)
    fleet = FleetDriver(cfg, batch=4, device=cuda)
    ticks = []
    per = 4 if sorted_scans else 1
    for k in range(3):
        reset_launch_counts()
        ticks.append(fleet.process([s[k] for s in streams]))
        assert launch_counts() == _path(per, detect=0)
    assert fleet.step.steps[0].captured
    for v, stream in enumerate(streams):
        driver = StreamingDriver(cfg, device=cuda)
        for k, rec in enumerate(stream):
            res = driver.process(rec)
            np.testing.assert_array_equal(ticks[k].labels[v][:res.n_points], res.labels)
            np.testing.assert_array_equal(ticks[k].outlier[v][:res.n_points] > 0, res.outlier)
    assert ticks[-1].ground_points == int((ticks[-1].labels == 49).sum()) > 0
    assert fleet.step.fallbacks == 0


@pytest.mark.parametrize("sorted_scans,check", [(True, True), (True, False), (False, True)])
def test_warm_step_makes_no_sync(cuda, sorted_scans, check):
    """A warm step, and a fleet tick without its fetch, run under
    ``torch.cuda.set_sync_debug_mode("error")``: no device-to-host read."""
    from groundgrid_torch.runtime.driver import StreamingDriver
    from groundgrid_torch.runtime.fleet import FleetDriver

    cfg = GroundGridConfig(dimension=40.0, resolution=0.5, max_points=16384, ray_steps=40,
                           max_outlier_candidates=1024, sorted_scans=sorted_scans,
                           sorted_fallback_check=check)
    streams = _small_fleet_streams(2, 3)
    driver = StreamingDriver(cfg, device=cuda)
    fleet = FleetDriver(cfg, batch=2, device=cuda)
    for k in range(2):
        driver.process(streams[0][k])
        fleet.process([s[k] for s in streams])
    scan, _ = driver.make_scan(streams[0][2])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with pytest.raises(RuntimeError):
            int(driver.state.ground.sum())  # the mode is on
        driver.step(driver.state, scan)
        tick = fleet.dispatch([s[2] for s in streams])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert fleet.fetch(tick).ground_points > 0
    assert driver.step.fallbacks == fleet.step.fallbacks == 0


@pytest.mark.parametrize("dimension,resolution,b", [
    (12.0, 0.5, 1), (40.0, 0.5, 3), (120.0, 0.33, 4), (241.6, 0.1, 2)])
def test_batched_kernels_match_single_launches(cuda, dimension, resolution, b):
    """K1, K2, K3 and K4 on a batch of ``b`` grids (n = 24, 80, 364 and
    2416, the global-band K3, launched once a grid): each vehicle bitwise
    its single launch; K3 also against its plain batched walk (confidence
    bitwise, heights atol 2e-5 / rtol 1e-5)."""
    cfg = GroundGridConfig(dimension=dimension, resolution=resolution)
    n, n2 = cfg.cell_count, cfg.cell_count ** 2
    rng = np.random.default_rng(n + b)
    p = 4096
    cell = np.stack([_sorted_cells(rng, p, n2) for _ in range(b)])
    cell[-1] = n2  # a vehicle with every id in the overflow bin
    cell = torch.from_numpy(cell).to(cuda)
    cols = [torch.from_numpy(rng.normal(size=(b, p)).astype(np.float32)).to(cuda)
            for _ in range(3)]
    ops = ["sum", "min", "max"]
    tabs = [torch.from_numpy(rng.normal(size=(b, n, n)).astype(np.float32)).to(cuda)
            for _ in range(2)]
    ground, conf = _spiral_layers(n, cuda)
    ground = torch.stack([ground + 0.1 * v for v in range(b)])
    conf = torch.stack([conf.roll(v, 0) for v in range(b)])
    base_z = torch.from_numpy(rng.normal(0.2, 0.3, b).astype(np.float32)).to(cuda)
    reset_launch_counts()
    got_r = raster.raster_reduce(cell, cols, ops, n2)
    got_l = lookup.lookup(cell, tabs, n2)
    got_s = spiral.spiral_interpolation(cfg, ground.clone(), conf.clone(), base_z)
    counts = launch_counts()
    assert counts["raster"] == counts["lookup"] == 1
    assert counts["spiral"] == (1 if spiral.spiral_variant(n) == "band" else b)
    for v in range(b):
        for g, w in zip(got_r, raster.raster_reduce(cell[v], [c[v] for c in cols], ops, n2)):
            assert torch.equal(g[v].view(torch.int32), w.view(torch.int32))
        for g, w in zip(got_l, lookup.lookup(cell[v], [t[v] for t in tabs], n2)):
            assert torch.equal(g[v].view(torch.int32), w.view(torch.int32))
        single = spiral.spiral_interpolation(cfg, ground[v].clone(), conf[v].clone(), base_z[v])
        for g, w in zip(got_s, single):
            assert torch.equal(g[v].view(torch.int32), w.view(torch.int32))
    if n <= 364:
        g_p, c_p = spiral.spiral_interpolation_plain(cfg, ground.clone(), conf.clone(), base_z)
        assert torch.equal(got_s[1], c_p)
        torch.testing.assert_close(got_s[0], g_p, atol=2e-5, rtol=1e-5)
        tables = make_tables(cfg, cuda)
        layers = [torch.from_numpy(np.stack(arrs)).to(cuda) for arrs in
                  zip(*(detect_layers(n, seed) for seed in range(b)))]
        got_d = detect.detect_fused(cfg, tables, *layers)
        for g, w in zip(got_d, detect.detect_fused_plain(cfg, tables, *layers)):
            assert torch.equal(g, w)
        for v in range(b):
            single = detect.detect_fused(cfg, tables, *(t[v] for t in layers))
            for g, w in zip(got_d, single):
                assert torch.equal(g[v].view(torch.int32), w.view(torch.int32))


def test_run_benchmark_fleet_smoke(cuda):
    """``run_benchmark(batch > 1)`` end to end at a small size."""
    from groundgrid_torch.runtime.bench import run_benchmark

    r = run_benchmark(n_scans=4, batch=2, resolution=0.5, dimension=40.0, warmup=1,
                      n_beams=8, n_azimuth=128, max_points=4096, device=cuda)
    assert r["value"] > 0
    assert r["extra"]["batch"] == 2 and r["extra"]["fallbacks"] == 0


def test_spiral_reads_base_z_at_replay(cuda):
    """K3 captured in a CUDA graph seeds each replay's ``base_z``: the kernel
    reads it from device memory when it runs, not at the capture."""
    cfg = GroundGridConfig(dimension=40.0, resolution=0.5)
    m = cfg.center_cell
    ground, conf = _spiral_layers(cfg.cell_count, cuda)
    z = _base_z(cuda)
    g, c = ground.clone(), conf.clone()
    spiral.spiral_interpolation(cfg, ground.clone(), conf.clone(), z)  # build, attributes
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        spiral.spiral_interpolation(cfg, g, c, z)
    for value in (0.37, -1.25, 7.5):
        g.copy_(ground)
        c.copy_(conf)
        z.fill_(value)
        graph.replay()
        want = spiral.spiral_interpolation_plain(cfg, ground.clone(), conf.clone(), value)
        torch.cuda.synchronize()
        assert float(g[m, m]) == float(np.float32(value))
        assert torch.equal(c, want[1])
        torch.testing.assert_close(g, want[0], atol=2e-5, rtol=1e-5)


def _moving_records():
    """Three forward scans, a still pose, a step back and sideways, and a
    teleport: shifts of each sign, zero and beyond the grid."""
    from groundgrid_torch.data.synthetic import synthetic_sequence
    from groundgrid_torch.runtime.driver import ScanRecord

    scans = list(synthetic_sequence(3, seed=7, n_beams=24, n_azimuth=720, step_m=1.5))
    back = scans[0][2].copy()
    back[:2, 3] += (-2.2, 1.7)
    far = back.copy()
    far[:2, 3] += (300.0, -250.0)
    scans += [scans[2], (scans[0][0], scans[0][1], back), (scans[1][0], scans[1][1], far)]
    return [ScanRecord(index=i, timestamp=0.1 * i, points=p, labels=l, t_map_velo=T)
            for i, (p, l, T) in enumerate(scans)]


@pytest.mark.parametrize("mode", ["sorted", "unsorted", "wire-aux-fused"])
def test_captured_step_matches_eager_on_card(cuda, mode):
    """``make_step``'s captured step against ``make_step_fn``'s eager one on
    the card over a moving sequence: labels, outliers, the four state layers
    after every scan (and the 11 layers and x, y, z with aux) bitwise, the
    same launches per scan, every replay under the sync check."""
    from groundgrid_torch.pipeline import CapturedStep, make_step_fn
    from groundgrid_torch.runtime.driver import StreamingDriver

    change = {"sorted": dict(sorted_scans=True), "unsorted": dict(sorted_scans=False),
              "wire-aux-fused": dict(sorted_scans=True, wire_format=True, fused_detect=True)}
    with_aux = mode.endswith("fused")
    cfg = GroundGridConfig(dimension=40.0, resolution=0.5, max_points=16384, ray_steps=40,
                           max_outlier_candidates=1024, **change[mode])
    recs = _moving_records()
    runs = {}
    for name in ("captured", "eager"):
        driver = StreamingDriver(cfg, cuda, with_aux=with_aux)
        if name == "eager":
            driver.step = make_step_fn(cfg, with_aux)
        out, counts = [], []
        for k, rec in enumerate(recs):
            reset_launch_counts()
            torch.cuda.set_sync_debug_mode("error" if k else "default")
            try:
                tok = driver.dispatch(rec)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            counts.append(launch_counts())
            s = driver.state
            out.append((driver._finalize(tok), s.ground.cpu(), s.groundpatch.cpu(),
                        s.center.clone(), s.center_lo.clone()))
        runs[name] = out, counts, driver.step
    (got, got_counts, step), (want, want_counts, _) = runs["captured"], runs["eager"]
    assert isinstance(step, CapturedStep) and step.captured
    assert step.capture_seconds > 0 and step.pool_bytes > 0
    assert got_counts == want_counts
    assert got_counts[1] == _path(1, detect=int(with_aux), raster=1 + int(with_aux))
    for (a, *sa), (b, *sb) in zip(got, want):
        np.testing.assert_array_equal(a.labels, b.labels)
        np.testing.assert_array_equal(a.outlier, b.outlier)
        for x, y in zip(sa, sb):
            assert torch.equal(x.view(torch.int32), y.view(torch.int32))
        if with_aux:
            for name in b.aux:
                np.testing.assert_array_equal(a.aux[name], b.aux[name], err_msg=name)
            for c in "xyz":
                np.testing.assert_array_equal(getattr(a, c), getattr(b, c))
    assert step.fallbacks == 0


def test_captured_fleet_matches_eager_on_card(cuda):
    """The fleet's captured vehicle step (copies in, a replay, copies out per
    vehicle) against one eager streaming driver per vehicle, bitwise."""
    from groundgrid_torch.pipeline import make_step_fn
    from groundgrid_torch.runtime.driver import StreamingDriver
    from groundgrid_torch.runtime.fleet import FleetDriver

    cfg = GroundGridConfig(dimension=40.0, resolution=0.5, max_points=16384, ray_steps=40,
                           max_outlier_candidates=1024, sorted_scans=True)
    streams = _small_fleet_streams(4, 3)
    fleet = FleetDriver(cfg, batch=4, device=cuda)
    ticks = [fleet.process([s[k] for s in streams]) for k in range(3)]
    assert fleet.step.steps[0].captured
    for v, stream in enumerate(streams):
        driver = StreamingDriver(cfg, device=cuda)
        driver.step = make_step_fn(cfg)
        for k, rec in enumerate(stream):
            res = driver.process(rec)
            np.testing.assert_array_equal(ticks[k].labels[v][:res.n_points], res.labels)
            np.testing.assert_array_equal(ticks[k].outlier[v][:res.n_points] > 0, res.outlier)


def _spatial_run(step, records, mesh, cfg, device, sync_check=True):
    """The spatial step over ``records`` (sorted, host-tracked centers): per
    scan the gathered layers, labels, outliers and center pair (copies) and
    the launch counts; every call after the first under the sync check."""
    from groundgrid_torch.parallel import spatial
    from groundgrid_torch.pipeline import CenterTracker, init_state, prepare_scan

    T0 = np.asarray(records[0].t_map_velo, np.float64)
    tracker = CenterTracker(cfg, T0[:2, 3])
    st = init_state(cfg, T0.astype(np.float32), device)
    g, c = spatial.split_rows(st.ground, mesh), spatial.split_rows(st.groundpatch, mesh)
    center = (st.center, st.center_lo)
    out, counts = [], []
    for k, rec in enumerate(records):
        T = np.asarray(rec.t_map_velo, np.float64)
        scan, _ = prepare_scan(cfg, rec.points, rec.labels, T, tracker.update(T[:2, 3]), device)
        chunks = spatial.shard_scan(scan, mesh)
        reset_launch_counts()
        torch.cuda.set_sync_debug_mode("error" if sync_check and k else "default")
        try:
            g, c, center, labels, outlier = step(g, c, center, chunks)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        counts.append(launch_counts())
        out.append([torch.cat(x).cpu() for x in (g, c, labels, outlier)] + list(center))
    return out, counts


@pytest.mark.parametrize("collectives", ["inside", "between"])
@pytest.mark.parametrize("mode", ["replicated", "banded"])
def test_captured_spatial_step_matches_eager_on_card(cuda, mode, collectives):
    """The captured spatial step over ``["cuda:0"] * 4`` (one graph a scan,
    or one per segment between the collectives) against the eager one over
    a moving sequence: layers, labels, outliers and the center pair
    bitwise, the same launches per scan, every replay under the sync
    check."""
    from groundgrid_torch.parallel import spatial
    from groundgrid_torch.parallel.collectives import CapturedShards

    cfg = GroundGridConfig(dimension=40.0, resolution=0.5, max_points=16384, ray_steps=40,
                           max_outlier_candidates=1024, sorted_scans=True)
    mesh = [cuda] * 4
    recs = _moving_records()
    step = spatial.make_spatial_step(cfg, mesh, mode, with_scan_center=True)
    if collectives == "between":  # segmented, as a mesh across cards or ranks is
        step._shards = CapturedShards(step.mesh, "between")
    got, got_counts = _spatial_run(step, recs, mesh, cfg, cuda)
    want, want_counts = _spatial_run(spatial.SpatialStep(cfg, mesh, mode, with_scan_center=True),
                                     recs, mesh, cfg, cuda)
    assert isinstance(step, spatial.CapturedSpatialStep) and step.captured
    assert step.capture_seconds > 0 and step.pool_bytes > 0
    assert got_counts == want_counts
    assert got_counts[1] == _path(4, detect=0)
    for k, (a, b) in enumerate(zip(got, want)):
        for x, y in zip(a, b, strict=True):
            if x.dtype.is_floating_point:
                x, y = x.view(torch.int32), y.view(torch.int32)
            assert torch.equal(x, y), f"scan {k + 1}"
    assert step.fallbacks == 0


@pytest.mark.parametrize("collectives", ["inside", "between"])
def test_captured_sharded_detect_on_card(cuda, collectives):
    """The captured sharded detect over ``["cuda:0"] * 4``, three calls on new
    layers, bitwise the eager one."""
    from groundgrid_torch.parallel import spatial
    from groundgrid_torch.parallel.collectives import CapturedShards

    cfg = GroundGridConfig(dimension=40.0, resolution=0.5)
    mesh = [cuda] * 4
    eager = spatial.ShardedDetect(cfg, mesh)
    captured = spatial.make_sharded_detect(cfg, mesh)
    if collectives == "between":
        captured._shards = CapturedShards(captured.mesh, "between")
    for seed in range(3):
        layers = detect_layers(cfg.cell_count, seed)
        blocks = [spatial.split_rows(torch.from_numpy(a).to(cuda), mesh) for a in layers[:5]]
        want = eager(*blocks)
        got = captured(*blocks)
        for a, b in zip(got, want):
            assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert captured.captured


def test_empty_segment_replays(cuda):
    """A segment in which a card has no work (a band it does not own)
    captures an empty graph, quietly, and its replay does nothing."""
    import warnings

    from groundgrid_torch.capture import Graph

    graph = Graph(cuda)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "The CUDA Graph is empty")
        assert graph.capture(lambda: []) == []
    reset_launch_counts()
    graph.replay(None)
    torch.cuda.synchronize(cuda)
    assert not any(launch_counts().values())


SMALL_SORTED = dict(dimension=40.0, resolution=0.5, max_points=16384, ray_steps=40,
                    max_outlier_candidates=1024)


def _bitwise(a, b):
    if a.dtype.is_floating_point:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a.cpu(), b.cpu())


def _march_inputs(cfg, s, binning, x, y, z, ground, budget_fn):
    """The march's inputs as the step builds them: budgets, keys and
    directions (``budget_fn`` of the moved ``ground``), and the selected
    candidates (K11's plain version)."""
    budget, key, dirs, _ = budget_fn(cfg, s, binning, x, y, z, ground)
    pidx, _ = select.select_candidates_plain(budget, key,
                                             min(cfg.max_outlier_candidates, x.shape[-1]))
    return budget, key, dirs, pidx


def _march(fn, cfg, s, ground, conf, pidx, budget, dirs):
    """K7 (or its plain version, ``fn``) of ``pidx`` with K11's marchable
    counts, into fresh flags as K6 leaves them (all False)."""
    return fn(cfg, s, ground, conf, pidx, budget, dirs, (budget > 0).sum(-1),
              torch.zeros(budget.shape, dtype=torch.bool, device=budget.device))


def _same_budgets(got, want):
    """K6's outputs bitwise: budget and key everywhere, the directions
    where the budget is positive (the kernel writes nothing elsewhere)."""
    pos = want[0] > 0
    return (_bitwise(got[0], want[0]) and _bitwise(got[1], want[1])
            and _bitwise(got[2][:, pos], want[2][:, pos]))


def _check_fused(cfg, s, x, y, z, rings, valid, ground, conf):
    """K5, K6 and K7 against their plain versions on the card, bitwise, two
    runs bitwise (K7 on K6's own outputs); returns the plain binning and
    the kernel march's hits."""
    want_b = binning.bin_points_plain(cfg, s, x, y, rings, valid)
    got_b = binning.bin_points(cfg, s, x, y, rings, valid)
    again_b = binning.bin_points(cfg, s, x, y, rings, valid)
    for f, g, a, w in zip(want_b._fields, got_b, again_b, want_b):
        assert _bitwise(g, w), f"K5 {f}"
        assert _bitwise(a, g), f"K5 {f}: two runs"
    budget, key, dirs, pidx = _march_inputs(cfg, s, want_b, x, y, z, ground,
                                            march.march_budget_plain)
    for run in range(2):
        got = march.march_budget(cfg, s, want_b, x, y, z, ground)
        assert _same_budgets(got, (budget, key, dirs)), f"K6, run {run + 1}"
        assert got[3].dtype == torch.bool and not bool(got[3].any()), f"K6 flags, run {run + 1}"
    want_m = _march(march.march_plain, cfg, s, ground, conf, pidx, budget, dirs)
    got_m = _march(march.march, cfg, s, ground, conf, pidx, got[0], got[2])
    assert _bitwise(got_m, want_m), f"K7: {int((got_m != want_m).sum())} of {int(want_m.sum())}"
    again_m = _march(march.march, cfg, s, ground, conf, pidx, got[0], got[2])
    assert _bitwise(again_m, got_m), "K7: two runs"
    return want_b, got_m


@pytest.mark.parametrize("sorted_scans", [True, False])
def test_fused_kernels_match_plain_on_warm_scan(cuda, sorted_scans):
    """K5, K6 and K7 on the third scan of the adversarial world (where
    outliers fire) from the warm state of a driver on the card: bitwise their plain versions on the
    card, and K5's ids bitwise the host prep's (the CPU plain version)."""
    from groundgrid_torch.core import grid as gridlib
    from groundgrid_torch.core import scalars
    from groundgrid_torch.core import transforms as tf
    from groundgrid_torch.pipeline import scan_scalars, to_device
    from groundgrid_torch.runtime.driver import StreamingDriver

    cfg = GroundGridConfig(**SMALL_SORTED, sorted_scans=sorted_scans)
    recs = _adversarial_records(3)
    driver = StreamingDriver(cfg, cuda)
    for rec in recs[:2]:
        driver.process(rec)
    scan, _ = driver.make_scan(recs[2])
    packed, _, _ = scan_scalars(cfg, driver.state.center_np, driver.state.center_lo_np, scan)
    s = scalars.view(to_device(packed, cuda))
    x, y, z = scan.px, scan.py, scan.pz
    if not sorted_scans:
        x, y, z = tf.transform_points_soa(s.velo, x, y, z)
    ground, conf = gridlib.move(cfg, driver.state.ground, driver.state.groundpatch, s)
    reset_launch_counts()
    plain_b, hits = _check_fused(cfg, s, x, y, z, scan.rings, scan.valid > 0, ground, conf)
    counts = launch_counts()
    assert (counts["bin"], counts["march_budget"], counts["march"]) == (2, 2, 2)
    host = binning.bin_points_plain(cfg, scalars.view(torch.from_numpy(packed)), x.cpu(), y.cpu(),
                                    scan.rings.cpu(), scan.valid.cpu() > 0)
    assert _bitwise(host.cell, plain_b.cell)
    assert int(hits.sum()) > 0


def _adversarial_records(n):
    from groundgrid_torch.data.synthetic import adversarial_sequence
    from groundgrid_torch.runtime.driver import ScanRecord

    return [ScanRecord(index=k, timestamp=0.1 * k, points=p, labels=l, t_map_velo=T)
            for k, (p, l, T) in enumerate(
                adversarial_sequence(n, seed=3, n_beams=24, n_azimuth=600, step_m=1.5))]


def _random_points(rng, cfg, p):
    """(x, y, z, rings, valid) of ``p`` points: a third uniform over the
    grid and beyond it, a third on cell edges and +-1 ulp from them, the
    rest at -0.0 and below the sensor; the ds edges from ``binning_constants``."""
    from groundgrid_torch.core import scalars

    n, res = cfg.cell_count, np.float32(cfg.resolution)
    sh0 = scalars.binning_constants(cfg, np.zeros(2, np.float32), np.zeros(2, np.float32))[0]
    x = rng.uniform(-1.2, 1.2, p).astype(np.float32) * np.float32(cfg.half_length)
    y = rng.uniform(-1.2, 1.2, p).astype(np.float32) * np.float32(cfg.half_length)
    k = rng.integers(-2, n + 2, p).astype(np.float32)
    edge = (np.float32(sh0) - k * res).astype(np.float32)
    toward = np.where(rng.random(p) < 0.5, np.inf, -np.inf).astype(np.float32)
    edge = np.where(rng.random(p) < 0.5, edge, np.nextafter(edge, toward))
    third = p // 3
    x[third:2 * third] = edge[:third]
    y[third:2 * third] = edge[third:2 * third]
    x[2 * third:2 * third + 7] = -0.0
    y[2 * third:2 * third + 7] = -0.0
    z = rng.uniform(-3.0, 1.0, p).astype(np.float32)
    rings = rng.integers(0, 70, p).astype(np.int32)
    valid = rng.random(p) < 0.95
    return x, y, z, rings, valid


@pytest.mark.parametrize("p", [4097, 1 << 17, (1 << 17) + 640])
def test_fused_kernels_match_plain_on_random_points(cuda, p):
    """K5, K6 and K7 on random points (cell edges, +-1 ulp, -0.0, off the
    grid; both selection keys, split at 2^17 points) and random layers,
    bitwise their plain versions."""
    from groundgrid_torch.core import scalars, transforms

    cfg = GroundGridConfig(**dict(SMALL_SORTED, max_points=p, max_outlier_candidates=700),
                           max_ring=60, sorted_scans=True)
    n = cfg.cell_count
    rng = np.random.default_rng(p)
    x, y, z, rings, valid = (torch.from_numpy(a).to(cuda) for a in _random_points(rng, cfg, p))
    packed = scalars.pack(cfg, np.zeros(2, np.float32), np.zeros(2, np.float32), (0, 0),
                          transforms.translation(0.3, -0.2, 1.7), np.eye(4), np.eye(4))
    s = scalars.view(torch.from_numpy(packed).to(cuda))
    ground = torch.from_numpy(rng.normal(-1.0, 0.5, (n, n)).astype(np.float32)).to(cuda)
    conf = torch.from_numpy(rng.uniform(0.0, 1.0, (n, n)).astype(np.float32)).to(cuda)
    plain_b, hits = _check_fused(cfg, s, x, y, z, rings, valid, ground, conf)
    assert 0 < int(plain_b.inmap.sum()) < p and int(plain_b.ignored.sum()) > 0
    assert int(hits.sum()) > 0


def test_fused_kernels_batched_match_single_launches(cuda):
    """K5, K6 and K7 on a batch of 64 vehicles (random points and layers,
    each its own scan scalars) in one launch each: every row bitwise its
    single launch, and the batch bitwise the plain batched versions."""
    from groundgrid_torch.core import scalars, transforms

    b, p = 64, 2048
    cfg = GroundGridConfig(**dict(SMALL_SORTED, max_points=p, max_outlier_candidates=300),
                           max_ring=60)
    n = cfg.cell_count
    rng = np.random.default_rng(64)
    pts = [_random_points(rng, cfg, p) for _ in range(b)]
    x, y, z, rings, valid = (torch.from_numpy(np.stack(a)).to(cuda) for a in zip(*pts))
    packed = np.stack([scalars.pack(cfg, rng.normal(0, 0.2, 2).astype(np.float32),
                                    np.zeros(2, np.float32), (0, 0),
                                    transforms.translation(*rng.normal(0, 0.5, 2), 1.7),
                                    np.eye(4), np.eye(4)) for _ in range(b)])
    sb = scalars.view(torch.from_numpy(packed).to(cuda))
    ground = torch.from_numpy(rng.normal(-1.0, 0.5, (b, n, n)).astype(np.float32)).to(cuda)
    conf = torch.from_numpy(rng.uniform(0.0, 1.0, (b, n, n)).astype(np.float32)).to(cuda)
    reset_launch_counts()
    plain_b, hits = _check_fused(cfg, sb, x, y, z, rings, valid, ground, conf)
    counts = launch_counts()
    assert (counts["bin"], counts["march_budget"], counts["march"]) == (2, 2, 2)
    _check_rows(cfg, packed, plain_b, x, y, z, rings, valid, ground, conf, hits)
    assert int(hits.sum()) > 0


def _check_rows(cfg, packed, plain_b, x, y, z, rings, valid, ground, conf, hits):
    """Every row of the batched K5, K6 and K7 bitwise its vehicle's single
    launch."""
    from groundgrid_torch.core import scalars

    dev = x.device
    budget, key, dirs, pidx = _march_inputs(cfg, scalars.view(torch.from_numpy(
        packed).to(dev)), plain_b, x, y, z, ground, march.march_budget)
    for v in range(x.shape[0]):
        s = scalars.view(torch.from_numpy(packed[v]).to(dev))
        single = binning.bin_points(cfg, s, x[v], y[v], rings[v], valid[v])
        assert all(_bitwise(g[v], w) for g, w in zip(plain_b, single)), f"K5 vehicle {v}"
        bv = type(plain_b)(*(t[v] for t in plain_b))
        got = march.march_budget(cfg, s, bv, x[v], y[v], z[v], ground[v])
        assert _same_budgets(got, (budget[v], key[v], dirs[:, v])), f"K6 vehicle {v}"
        single_m = _march(march.march, cfg, s, ground[v], conf[v], pidx[v], budget[v],
                          dirs[:, v])
        assert _bitwise(single_m, hits[v]), f"K7 vehicle {v}"


EDGE_CASES = {"edge-0": (0, {}), "edge-1": (1, {}),
              # the cap below the marchable count: every candidate marches
              "all-marchable": (2, {"max_outlier_candidates": 1000}),
              "262144-points": (3, {"max_points": 1 << 18})}


@pytest.mark.parametrize("case", list(EDGE_CASES))
def test_fused_kernels_match_plain_on_edge_grid(cuda, case):
    """K5, K6 and K7 on the clamp-edge grid (``tests/march_scenes.py``: rays
    ending on rows and columns 1, 2, 3 and n - 2, block sums equal to
    ``min_conf``, cells at exactly 0.01), on a buffer where every candidate
    is marchable and at 262,144 points (the exact-budget key): bitwise
    their plain versions, two runs bitwise."""
    import march_scenes
    from groundgrid_torch.core import scalars

    seed, kw = EDGE_CASES[case]
    cfg = GroundGridConfig(**{**march_scenes.EDGE, **kw})
    sc = march_scenes.Scene(*(torch.from_numpy(a).to(cuda)
                              for a in march_scenes.edge_scene(cfg, seed)))
    s = scalars.view(sc.packed)
    plain_b, hits = _check_fused(cfg, s, sc.x, sc.y, sc.z, sc.rings, sc.valid, sc.ground,
                                 sc.conf)
    assert int(hits.sum()) > 0
    if case == "all-marchable":
        budget, _, _, pidx = _march_inputs(cfg, s, plain_b, sc.x, sc.y, sc.z, sc.ground,
                                           march.march_budget)
        assert bool((budget[pidx] > 0).all())


def test_fused_kernels_batched_edge_grids_match_single_launches(cuda):
    """K5, K6 and K7 on 64 clamp-edge grids in one launch each: every row
    bitwise its single launch, the batch bitwise the plain batched
    versions."""
    import march_scenes
    from groundgrid_torch.core import scalars

    cfg = GroundGridConfig(**dict(march_scenes.EDGE, max_points=1024, max_outlier_candidates=400))
    scenes = [march_scenes.edge_scene(cfg, 100 + v) for v in range(64)]
    sc = march_scenes.Scene(*(torch.from_numpy(np.stack(a)).to(cuda) for a in zip(*scenes)))
    packed = np.stack([scene.packed for scene in scenes])
    plain_b, hits = _check_fused(cfg, scalars.view(sc.packed), sc.x, sc.y, sc.z, sc.rings,
                                 sc.valid, sc.ground, sc.conf)
    _check_rows(cfg, packed, plain_b, *sc[:5], sc.ground, sc.conf, hits)
    assert int((hits.sum(-1) > 0).sum()) == 64


@pytest.mark.parametrize("eager", [False, True])
def test_card_step_never_builds_the_key_table(cuda, monkeypatch, eager):
    """The card's step (captured, or eager) reads the occlusion keys in K7
    alone: ``occlusion_key_table`` made to raise, it steps a moving
    adversarial sequence, one K7 launch a scan, and marks outliers."""
    from groundgrid_torch.core import outliers
    from groundgrid_torch.pipeline import make_step_fn
    from groundgrid_torch.runtime.driver import StreamingDriver

    def refuse(*args):
        raise AssertionError("the card's step built the occlusion key table")

    monkeypatch.setattr(outliers, "occlusion_key_table", refuse)
    cfg = GroundGridConfig(**SMALL_SORTED, sorted_scans=True)
    driver = StreamingDriver(cfg, cuda)
    if eager:
        driver.step = make_step_fn(cfg)
    recs = _adversarial_records(4)
    reset_launch_counts()
    fired = sum(int(driver.process(rec).outlier.sum()) for rec in recs)
    assert launch_counts()["march"] == len(recs)
    assert fired > 0


def test_fused_kernels_read_scalars_at_replay(cuda):
    """K5, K6 and K7 captured in one CUDA graph on scan A's scan scalars and
    replayed after scan B's are copied in: bitwise the eager calls on B
    (the kernels read the scalars when they run, not at the capture)."""
    from groundgrid_torch.core import outliers, scalars
    from groundgrid_torch.pipeline import scan_scalars, to_device
    from groundgrid_torch.runtime.driver import StreamingDriver

    cfg = GroundGridConfig(**SMALL_SORTED, sorted_scans=True)
    recs = _moving_records()
    driver = StreamingDriver(cfg, cuda)
    driver.process(recs[0])
    state = driver.state
    scans = [driver.make_scan(rec)[0] for rec in (recs[1], recs[5])]  # a step, a teleport
    packed = [scan_scalars(cfg, state.center_np, state.center_lo_np, sc)[0] for sc in scans]
    buf = to_device(packed[0], cuda)
    points = [tuple(t.clone() for t in (sc.px, sc.py, sc.pz, sc.rings, sc.valid)) for sc in scans]
    x, y, z, rings, valid = (t.clone() for t in points[0])
    ground, conf = state.ground.clone(), state.groundpatch.clone()

    def fused(s):
        b = binning.bin_points(cfg, s, x, y, rings, valid > 0)
        budget, _, dirs, pidx = _march_inputs(cfg, s, b, x, y, z, ground, march.march_budget)
        return b, budget, _march(march.march, cfg, s, ground, conf, pidx, budget, dirs)

    fused(scalars.view(buf))  # build and warm
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fused(scalars.view(buf))
    for k in (1, 0):
        buf.copy_(to_device(packed[k], cuda))
        for dst, src in zip((x, y, z, rings, valid), points[k]):
            dst.copy_(src)
        graph.replay()
        want = fused(scalars.view(to_device(packed[k], cuda)))
        torch.cuda.synchronize()
        assert all(_bitwise(g, w) for g, w in zip(out[0], want[0])), f"K5, scan {k}"
        assert _bitwise(out[1], want[1]), f"K6, scan {k}"
        assert _bitwise(out[2], want[2]), f"K7, scan {k}"
    assert outliers.IDX_BITS == 17


def test_fused_wrappers_reject_bad_input(cuda):
    """K5-K7 refuse scan scalars that are not views of a packed row on the
    points' device, and mismatched shapes or dtypes."""
    from groundgrid_torch.core import scalars, transforms

    cfg = GroundGridConfig(**SMALL_SORTED)
    packed = scalars.pack(cfg, np.zeros(2, np.float32), None, (0, 0),
                          transforms.translation(0.0, 0.0, 1.7), np.eye(4), np.eye(4))
    x = torch.zeros(64, device=cuda)
    rings, valid = torch.zeros(64, dtype=torch.int32, device=cuda), torch.ones(64, dtype=torch.bool,
                                                                              device=cuda)
    with pytest.raises(ValueError):  # scalars on the host
        binning.bin_points(cfg, scalars.view(torch.from_numpy(packed)), x, x, rings, valid)
    s = scalars.view(torch.from_numpy(packed).to(cuda))
    with pytest.raises(ValueError):  # a (B, P) batch against one row of scalars
        binning.bin_points(cfg, s, x[None], x[None], rings[None], valid[None])
    with pytest.raises(ValueError):
        binning.bin_points(cfg, s, x, x, rings.float(), valid)
    b = binning.bin_points(cfg, s, x, x, rings, valid)
    n = cfg.cell_count
    layer = torch.zeros((n, n), device=cuda)
    with pytest.raises(ValueError):
        march.march_budget(cfg, s, b, x, x, x[:32], layer)
    with pytest.raises(ValueError):  # the gathered old ground, not the moved grid
        march.march_budget(cfg, s, b, x, x, x, x)
    with pytest.raises(ValueError):  # a grid of another size
        march.march_budget(cfg, s, b, x, x, x, layer[:-1])
    pidx, dirs = torch.zeros(4, dtype=torch.int64, device=cuda), torch.zeros((3, 64), device=cuda)
    n_m = torch.zeros((), dtype=torch.int64, device=cuda)
    flags = torch.zeros(64, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):  # a layer of the wrong shape
        march.march(cfg, s, torch.zeros(7, device=cuda), layer, pidx, x, dirs, n_m, flags)
    with pytest.raises(ValueError):  # directions without the leading 3
        march.march(cfg, s, layer, layer, pidx, x, dirs[0], n_m, flags)
    with pytest.raises(ValueError):  # a count a row of another dtype
        march.march(cfg, s, layer, layer, pidx, x, dirs, n_m.int(), flags)
    with pytest.raises(ValueError):  # int32 flags, not K6's bool ones
        march.march(cfg, s, layer, layer, pidx, x, dirs, n_m, flags.int())
    tiny = GroundGridConfig(dimension=2.0, resolution=0.5)  # 4^2 cells: the block leaves the grid
    with pytest.raises(ValueError):
        march.march(tiny, s, layer[:4, :4], layer[:4, :4], pidx, x, dirs, n_m, flags)
