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
cells passed through); the occlusion march shedding candidates at the
cap, on both selection keys, bitwise the CPU's; plus the small-config
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
from groundgrid_torch.ops import detect, launch_counts, lookup, raster, reset_launch_counts, spiral

pytestmark = pytest.mark.gpu


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
                assert launch_counts() == {"raster": 4, "lookup": 12, "spiral": 4, "detect": 0}
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
    assert launch_counts() == {"raster": 3, "lookup": 9, "spiral": 3, "detect": 0}
    assert mism <= 0.001 * total
    assert gpu.step.fallbacks == 0
    np.testing.assert_array_equal(gpu.state.center.numpy(), cpu.state.center.numpy())
    plain = StreamingDriver(dataclasses.replace(cfg, use_pallas=False), device=cuda)
    reset_launch_counts()
    for rec in recs:
        plain.process(rec)
    assert launch_counts() == {"raster": 0, "lookup": 0, "spiral": 0, "detect": 0}


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
    assert launch_counts() == {"raster": 6, "lookup": 9, "spiral": 3, "detect": 3}
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
    assert launch_counts() == {"raster": 6, "lookup": 9, "spiral": 3, "detect": 0}
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
        (old_h,) = lookup.lookup(b.cell, [ground], n * n)
        got, marchable = outliers.detect_outliers(cfg, s, ground, conf, b, x, y, z, old_h,
                                                  lookup.lookup)
        return got.cpu().numpy(), marchable

    want, want_marchable = run("cpu")
    before = lookup.lookup.launches
    got, marchable = run(cuda)
    assert lookup.lookup.launches > before
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
    card, bitwise; each tick launches K1 x1, K2 x3 and K3 x1 per vehicle."""
    from groundgrid_torch.runtime.driver import StreamingDriver
    from groundgrid_torch.runtime.fleet import FleetDriver

    cfg = GroundGridConfig(dimension=40.0, resolution=0.5, max_points=16384, ray_steps=40,
                           max_outlier_candidates=1024, sorted_scans=sorted_scans)
    streams = _small_fleet_streams(4, 3)
    fleet = FleetDriver(cfg, batch=4, device=cuda)
    ticks = []
    for k in range(3):
        reset_launch_counts()
        ticks.append(fleet.process([s[k] for s in streams]))
        assert launch_counts() == {"raster": 4, "lookup": 12, "spiral": 4, "detect": 0}
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
    assert got_counts[1]["spiral"] == 1 and got_counts[1]["lookup"] == 3
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
    assert got_counts[1] == {"raster": 4, "lookup": 12, "spiral": 4, "detect": 0}
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
