"""GPU smoke test of the PyTorch port: builds and checks its CUDA kernels,
then drives the sorted-scan streaming path, the layer-publishing wire path,
the entry point, the unsorted default path, a 128-beam buffer and the golden
parity tooling on one card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero, printing no result):

1. Environment: torch and CUDA versions, the card's name and power limit,
   the kernels' build time (nvcc, from ``groundgrid_torch/csrc``).
2. Each kernel against its plain PyTorch version on the same CUDA tensors,
   at the main paths' shapes (364^2 grid, 131072-point buffer):
   K1 raster (7 columns of a prepared scan: counts, sums, min and max all
   bitwise, the plain version folding each run in the kernel's order; its
   run count and longest run, and for context ``torch.segment_reduce`` over
   the same runs), K2 lookup (sorted point cells with 1 and 2 tables, a
   uniform random lattice-sized vector and the march lattice of a warm scan,
   the ids ``detect_outliers`` hands it: bitwise), K3 spiral (a warm state:
   confidence bitwise, heights atol 2e-5 / rtol 1e-5; and its global-band
   variant at n = 2416 on random layers, the same bounds), K4 fused detect
   (the warm raster layers of a real scan at 364^2 and at 1200^2, from a
   ``HIGHRES_CONFIG`` fused-detect driver warmed on 4 scans, and random
   layers at n = 12 and 45, one seed with low variance so that the main
   update fires: ground and confidence bitwise, two runs bitwise; timed at
   both grid sizes). Per kernel: its device time
   (``torch.profiler``, the named kernel's own time per launch), the device
   time of everything one wrapper call launches, the wrapper's cost per
   call (CUDA events around back-to-back calls), the plain version's, the
   least time the card could take (the bytes this run's inputs need over
   3.35 TB/s or its f32 operations over 67 TFLOP/s: K2 reads only the
   distinct cells its ids name) and, for K2, one ``torch.index_select``
   over the stacked tables, timed in turns with the kernel (no one PyTorch
   call computes K1, K3 or K4).
3. ``StreamingDriver`` with the default sorted config over 32 consecutive
   synthetic scans: per-scan launch counts (K1 x1, K2 x3, K3 x1), no
   sortedness fallback, labels against the plain-version run on the card
   (>= 99.9 % agreement), a second kernel run bitwise equal to the first,
   ground-vs-truth recall/precision, ms/scan from CUDA events.
4. The layer-publishing wire path, ``StreamingDriver(GroundGridConfig(
   sorted_scans=True, wire_format=True, fused_detect=True), with_aux=True)``
   over the first 16 scans: per-scan launch counts (K1 x2, K2 x3, K3 x1,
   K4 x1), no fallback, labels against the plain-version run (>= 99.9 %)
   with the points, points_raw, min and max layers bitwise, all 11 layers
   finite, a second kernel run bitwise equal, a checkpoint after scan 8
   (``save_state`` / ``load_state`` / ``restore``) whose resumed scans 9-16
   are bitwise those of the uninterrupted run, ms/scan from CUDA events.
   Then the same path at ``HIGHRES_CONFIG`` (1200^2) over the first 4 scans,
   twice: launch counts per scan, 11 finite layers, the second run bitwise
   the first, ms/scan of each run.
5. The entry point, ``python -m groundgrid_torch``, called in-process
   (``runtime.cli.main``) at the default geometry over the 32 scans of phase
   3 written as a SemanticKITTI sequence: (a) ``evaluate``, NumPy prep; (b)
   with ``--native-loader``; (c) (b) with ``--pipeline-depth 2``; (d) (b)
   with ``--on-device-eval``; (e) ``--wire --native-loader``; (f) a
   checkpointed run to scan 15, then ``--resume`` over the sequence; (g)
   ``playback --native-loader --pipeline-depth 2`` with layer and HTML
   exports. The C++ loaders must be native; (a)-(d) and the resumed (f)
   print the same statistics block and metrics; (e) is within 0.1 pt of (a)
   on F1 and IoUg; per scan K1 x1 (x2 for (g)), K2 x3, K3 x1 and no
   sortedness fallback; (g) writes 11 layer PNGs per exported scan and the
   player. Prints ms/scan per variant (the payload's and CUDA events around
   the call) and the host prep p50 of NumPy against the native loader.
6. Unsorted mode at the config default, ``StreamingDriver(GroundGridConfig())``
   (364^2, 131072 points, raw scans transformed and stable-sorted on the
   device) over the 32 scans of phase 3: per-scan launch counts (K1 x1, K2
   x3, K3 x1), labels against the plain-version run over the first 8 scans
   (the plain K3 takes over a second a scan; >= 99.9 %) and against phase
   3's sorted labels over all 32 (>= 99.9 %, the JAX package's sorted-vs-
   default bar), a second kernel run bitwise, ms/scan from CUDA events, and
   the device stable sort's own device time on a scan's cell ids.
7. A 128-beam sensor's buffer, ``GroundGridConfig(max_points=262144,
   sorted_scans=True)`` over 8 scans of ``synthetic_sequence(n_beams=128,
   n_azimuth=2048)``: the march selects candidates by the exact-budget key
   above 2^17 points. Points per scan and marchable candidates against
   ``max_outlier_candidates``, launch counts, labels against the plain run
   (>= 99.9 %), a second kernel run bitwise, ms/scan.
8. Golden parity with the port on the card: ``python -m groundgrid_torch
   accuracy`` at ``tests/test_accuracy.py``'s size cut to 6 scans (32 beams x
   900, a 60 m grid at 0.5 m, 32768 points), sorted and unsorted, exits 0
   within 0.1 pt; the five
   boundary configs of the config fuzz pass their row bounds (< 0.1 pt,
   < 2e-3 label mismatch).

The line before the last is the kernels' JSON record (``ms`` is the device
time, ``library_ms`` null where no one PyTorch call computes the function;
K4 adds its ``*_highres`` times and bound at 1200^2; ``launches`` counts phase
3, ``launches_unsorted`` phase 6 and ``launches_topk`` phase 7);
the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

N_SCANS = 32
N_LAYER_SCANS = 16
N_HIGHRES_SCANS = 4
N_PLAIN_UNSORTED = 8  # the plain K3 takes over a second a scan
N_TOPK_SCANS = 8
TOPK_POINTS = 262144  # a 128-beam sensor at 2048 azimuths: ~240k points a scan
AGREE_MIN = 0.999
GROUND_TRUTH_IDS = (40, 72)  # synthetic road and terrain (SemanticKITTI ids)
WIRE_BUDGET_PT = 0.1  # the JAX CLI's ``accuracy`` budget (cli.py:539)
TIMING_KEYS = ("avg_ms", "scans_per_sec", "pipeline_depth")


def log(msg: str) -> None:
    print(msg, flush=True)


def kernel_times(fn, reps: int, name: str, plain=None, plain_reps: int = 0) -> dict:
    """``device_ms`` (the kernel ``name``'s own time on the card, by
    ``torch.profiler``), ``wrapper_device_ms`` (every device activity of one
    wrapper call: the kernel and any copy the wrapper makes), ``call_ms``
    (CUDA events around back-to-back wrapper calls) and ``plain_ms`` of
    ``plain()``, each per call."""
    from groundgrid_torch.runtime.kernel_timing import device_ms, event_ms

    # each over the calls the profiler kept (the launches of ``name``)
    out = {"device_ms": device_ms(fn, reps, name)[0],
           "wrapper_device_ms": device_ms(fn, reps, per=name)[0],
           "call_ms": event_ms(fn, reps)}
    if plain is not None:
        out["plain_ms"] = event_ms(plain, plain_reps)
    return out


def bound(n_bytes: float, n_flops: float) -> dict:
    from groundgrid_torch.runtime.kernel_timing import bound_ms

    ms, by = bound_ms(n_bytes, n_flops)
    return {"bound_ms": ms, "bound_by": by}


def phase_environment():
    from groundgrid_torch.ops import _build
    from groundgrid_torch.runtime.bench import gpu_name_and_power_limit

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs only on a GPU")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    log(gpu_name_and_power_limit())
    lib = _build.library()
    log(f"kernels built in {lib.build_seconds:.2f} s: {lib.path.name}")


def warm_driver(config, records, device, n_warm: int = 4):
    from groundgrid_torch.runtime.driver import StreamingDriver

    driver = StreamingDriver(config, device=device)
    for rec in records[:n_warm]:
        driver.process(rec)
    return driver


def prepared(config, driver, rec):
    """A prepared scan of ``rec``, its binning and accepted points (no march)."""
    from groundgrid_torch.core import rasterize as rasterlib

    scan, _ = driver.make_scan(rec)
    binning = rasterlib.bin_points(config, scan.center, scan.center_lo, scan.px, scan.py,
                                   scan.rings, scan.valid > 0, scan.t_map_velo[:3, 3])
    cell = binning.cell
    if not bool((cell[1:] >= cell[:-1]).all()):
        raise AssertionError("prepared scan is not cell-sorted on the device")
    return scan, binning, binning.inmap & ~binning.ignored


def check_raster(config, driver, rec):
    """K1 on the 7 columns of one prepared scan, against its plain version."""
    from groundgrid_torch.core import rasterize as rasterlib
    from groundgrid_torch.ops import raster
    from groundgrid_torch.runtime.kernel_timing import device_ms

    scan, binning, accept = prepared(config, driver, rec)
    cell = binning.cell
    cols, ops, _ = rasterlib.raster_columns(config, binning, scan.pz, scan.t_map_velo[:3, 3],
                                           accept, scan.center, scan.t_base_map)
    n2 = config.cell_count ** 2
    got = raster.raster_reduce(cell, cols, ops, n2)
    want = raster.raster_reduce_plain(cell, cols, ops, n2)
    # the plain version folds each run in the kernel's order: bitwise on all
    # columns, counts, sums (in point order) and extrema alike
    for j, (g, w, op) in enumerate(zip(got, want, ops)):
        if not torch.equal(g, w):
            raise AssertionError(f"K1 column {j} ({op}): {int((g != w).sum())} cells differ, "
                                 f"max {float((g - w).abs().max())}")
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    rec = {"max_abs_err": err, "library_ms": None}
    rec.update(kernel_times(lambda: raster.raster_reduce(cell, cols, ops, n2), 50,
                            "raster_reduce_kernel",
                            lambda: raster.raster_reduce_plain(cell, cols, ops, n2), 10))
    # reads every id once and each column at the points of real cells (the
    # padding at id n2 is dropped), writes one value per cell and column;
    # one sum, min or max per real point and column
    real = int((cell < n2).sum())
    rec.update(bound(cell.nbytes + 4 * len(cols) * real + 4 * len(cols) * n2,
                     len(cols) * real))
    # the runs K1 folds: their number and the longest, the serial chain
    lengths = torch.bincount(cell[:real].long(), minlength=n2)
    rec["runs"], rec["longest_run"] = int((lengths > 0).sum()), int(lengths.max())
    # context, no yardstick: torch.segment_reduce over the same runs (the 5
    # sum columns in one call, the min and the max column in one each) sums
    # in its own order and leaves empty cells at the reductions' identities,
    # so it does not compute K1's function: library_ms stays null
    sums = torch.stack(cols[:5], 1)[:real].contiguous()
    zmin, zmax = cols[5][:real].contiguous(), cols[6][:real].contiguous()

    def segment_reduce():
        return (torch.segment_reduce(sums, "sum", lengths=lengths, axis=0),
                torch.segment_reduce(zmin, "min", lengths=lengths),
                torch.segment_reduce(zmax, "max", lengths=lengths))

    rec["segment_reduce_ms"] = device_ms(segment_reduce, 50)[0]
    log(f"K1 raster_reduce: {cell.shape[0]} points ({real} in cells, {rec['runs']} runs, the "
        f"longest {rec['longest_run']}), {len(cols)} columns, n2={n2}: max_abs_err {err:.3g}, "
        f"device {rec['device_ms']:.4f} ms (wrapper {rec['wrapper_device_ms']:.4f} ms), call "
        f"{rec['call_ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, bound "
        f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}); torch.segment_reduce x3 over the "
        f"same runs {rec['segment_reduce_ms']:.4f} device ms (context)")
    return rec, cell


def march_lattice(config, driver, rec):
    """The flat cell ids the occlusion march hands K2 on scan ``rec`` from the
    driver's state (``core/outliers.py detect_outliers``), one lattice per
    chunk of candidates, as the step builds them."""
    from groundgrid_torch.core import grid as gridlib
    from groundgrid_torch.core import outliers as outlierlib
    from groundgrid_torch.core import rasterize as rasterlib
    from groundgrid_torch.ops import lookup

    n2 = config.cell_count ** 2
    scan, _ = driver.make_scan(rec)
    origin = np.asarray(scan.t_map_velo, np.float32)[:3, 3]
    moved = gridlib.move(config, driver.state, scan.t_base_map, scan.center, scan.center_lo)
    center, center_lo = moved.center_np, moved.center_lo_np
    binning = rasterlib.bin_points(config, center, center_lo, scan.px, scan.py, scan.rings,
                                   scan.valid > 0, origin)
    (old_h,) = lookup.lookup_plain(binning.cell, [moved.ground], n2)
    lattices = []

    def keep(cell, tables, n):
        lattices.append(cell.clone())
        return lookup.lookup_plain(cell, tables, n)

    outlierlib.detect_outliers(config, center, center_lo, moved.ground, moved.groundpatch,
                               binning, scan.px, scan.py, scan.pz, origin, old_h, keep)
    if not lattices:
        raise AssertionError("the march made no lookup on the warm scan")
    return lattices


def check_lookup_march(config, driver, rec):
    """K2 on the march lattice of a warm scan (its first chunk, the only one
    at the default geometry) over one table: bitwise, device ms and bound
    (reads the ids and the table at the distinct cells they name)."""
    from groundgrid_torch.ops import lookup

    n2 = config.cell_count ** 2
    ids = march_lattice(config, driver, rec)[0]
    table = driver.state.groundpatch
    got = lookup.lookup(ids, [table], n2)[0]
    if not torch.equal(got.view(torch.int32), lookup.lookup_plain(ids, [table], n2)[0]
                       .view(torch.int32)):
        raise AssertionError("K2 (march lattice) differs from the plain version")
    out = kernel_times(lambda: lookup.lookup(ids, [table], n2), 100, "lookup_kernel",
                       lambda: lookup.lookup_plain(ids, [table], n2), 20)
    out["ids"] = ids.shape[0]
    out["distinct_cells"] = int(torch.unique(ids[ids < n2]).numel())
    out.update(bound(ids.nbytes + 4 * out["distinct_cells"] + 4 * ids.shape[0], 0))
    return out


def check_lookup(config, driver, cell, rec_scan):
    """K2 on sorted point cells (1 and 2 tables), a uniform random
    lattice-sized vector and the march lattice of scan ``rec_scan``."""
    from groundgrid_torch.ops import lookup

    n2 = config.cell_count ** 2
    ground, conf = driver.state.ground, driver.state.groundpatch
    gen = torch.Generator().manual_seed(5)
    lattice = torch.randint(0, n2 + 1, ((config.ray_steps - 3) * config.max_outlier_candidates,),
                            generator=gen, dtype=torch.int32).to(cell.device)
    cases = [("sorted, 1 table", cell, [ground]), ("sorted, 2 tables", cell, [ground, conf]),
             ("unsorted lattice", lattice, [conf])]
    for name, c, tabs in cases:
        got = lookup.lookup(c, tabs, n2)
        want = lookup.lookup_plain(c, tabs, n2)
        for g, w in zip(got, want):
            if not torch.equal(g.view(torch.int32), w.view(torch.int32)):
                raise AssertionError(f"K2 ({name}) differs from the plain version")
    from groundgrid_torch.runtime.kernel_timing import device_ms

    # the yardstick: one index_select over the stacked tables with a zero
    # column at n2 (built outside the timed window; the port never calls it)
    padded = torch.zeros((2, n2 + 1), dtype=torch.float32, device=cell.device)
    padded[:, :n2] = torch.stack([ground.reshape(-1), conf.reshape(-1)])
    library = torch.index_select(padded, 1, cell)
    for g, w in zip(lookup.lookup(cell, [ground, conf], n2), library):
        if not torch.equal(g.view(torch.int32), w.view(torch.int32)):
            raise AssertionError("K2: index_select differs from the kernel")

    def two_tables():
        return lookup.lookup(cell, [ground, conf], n2)

    def yardstick():
        return torch.index_select(padded, 1, cell)

    # kernel and library in turns (kernel, library, library, kernel)
    rec = {"max_abs_err": 0.0}
    rec.update(kernel_times(two_tables, 100, "lookup_kernel",
                            lambda: lookup.lookup_plain(cell, [ground, conf], n2), 20))
    lib_runs = [device_ms(yardstick, 100)[0], device_ms(yardstick, 100)[0]]
    dev_runs = [rec["device_ms"], kernel_times(two_tables, 100, "lookup_kernel")["device_ms"]]
    rec["device_ms"] = sum(dev_runs) / 2
    rec["library_ms"] = sum(lib_runs) / 2
    # reads every id once and each table at the distinct real cells the ids
    # name (ids at n2 read nothing), writes one word per id and table
    touched = int(torch.unique(cell[cell < n2]).numel())
    rec.update(bound(cell.nbytes + 2 * 4 * touched + 2 * 4 * cell.shape[0], 0))
    lat = kernel_times(lambda: lookup.lookup(lattice, [conf], n2), 100, "lookup_kernel",
                       lambda: lookup.lookup_plain(lattice, [conf], n2), 20)
    lat_touched = int(torch.unique(lattice[lattice < n2]).numel())
    lat.update(bound(lattice.nbytes + 4 * lat_touched + 4 * lattice.shape[0], 0))
    march = check_lookup_march(config, driver, rec_scan)
    rec["lattice"], rec["march"] = lat, march
    log(f"K2 lookup: bitwise on all cases; 2 tables x {cell.shape[0]} sorted points "
        f"({touched} distinct cells): device {dev_runs[0]:.4f} / {dev_runs[1]:.4f} ms, "
        f"index_select {lib_runs[0]:.4f} / {lib_runs[1]:.4f} ms (in turns), call "
        f"{rec['call_ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.5f} "
        f"ms; 1 table x {lattice.shape[0]} uniform random ({lat_touched} distinct cells): "
        f"device {lat['device_ms']:.4f} ms, call {lat['call_ms']:.4f} ms, plain "
        f"{lat['plain_ms']:.4f} ms, bound {lat['bound_ms']:.5f} ms; 1 table x {march['ids']} "
        f"ids of the march lattice ({march['distinct_cells']} distinct cells): device "
        f"{march['device_ms']:.4f} ms, call {march['call_ms']:.4f} ms, plain "
        f"{march['plain_ms']:.4f} ms, bound {march['bound_ms']:.5f} ms")
    return rec


def check_spiral(config, driver, rec):
    """K3 on a warm 364^2 state, against its plain version."""
    from groundgrid_torch.ops import spiral

    base_z = float(np.asarray(driver.make_scan(rec)[0].t_map_base)[2, 3])
    ground, conf = driver.state.ground, driver.state.groundpatch
    # both versions work in place: each gets its own copy of the warm layers
    g_k, c_k = spiral.spiral_interpolation(config, ground.clone(), conf.clone(), base_z)
    g_p, c_p = spiral.spiral_interpolation_plain(config, ground.clone(), conf.clone(), base_z)
    if not torch.equal(c_k, c_p):
        raise AssertionError(f"K3 confidence differs in {int((c_k != c_p).sum())} cells")
    if not torch.allclose(g_k, g_p, atol=2e-5, rtol=1e-5):
        raise AssertionError(f"K3 heights beyond atol 2e-5 / rtol 1e-5: "
                             f"max {float((g_k - g_p).abs().max())}")
    if not bool(torch.isfinite(g_k).all()):
        raise AssertionError("K3 heights not finite")
    err = float((g_k - g_p).abs().max())
    # the walk's work does not depend on the values: time repeated sweeps
    h, c = ground.clone(), conf.clone()
    rec = {"max_abs_err": err, "library_ms": None}
    rec.update(kernel_times(lambda: spiral.spiral_interpolation(config, h, c, base_z), 20,
                            "spiral_kernel",
                            lambda: spiral.spiral_interpolation_plain(config, h, c, base_z), 2))
    # reads both layers on rings 0..m (the walk's stencils reach ring m) and
    # writes them on rings 0..m-1, each cell once; ~55 f32 operations per
    # visit (8 products and 16 sums of the stencil, 3 divisions, 2 decays,
    # the scan)
    n, m = config.cell_count, config.center_cell
    visits = (m - 1) * (4 * m + 2) + 1
    rec.update(bound(2 * 4 * ((2 * m + 1) ** 2 + (2 * m - 1) ** 2), 55 * visits))
    log(f"K3 spiral_interpolation: {n}^2, {m - 1} rings: confidence bitwise, height "
        f"max_abs_err {err:.3g}, device {rec['device_ms']:.4f} ms, call {rec['call_ms']:.4f} "
        f"ms, plain {rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
        f"({rec['bound_by']})")
    return rec


def check_spiral_global(device, dimension=241.6, resolution=0.1, seed=0):
    """K3's global-band variant at n = 2416, the smallest grid the ring band
    does not fit, on random layers from ``seed``, against its plain version."""
    from groundgrid_torch.config import GroundGridConfig
    from groundgrid_torch.ops import spiral

    cfg = GroundGridConfig(dimension=dimension, resolution=resolution)
    n, m = cfg.cell_count, cfg.center_cell
    if spiral.spiral_variant(n) != "global":
        raise AssertionError(f"n={n} takes the band kernel")
    rng = np.random.default_rng(seed)
    conf = np.where(rng.random((n, n)) < 0.4, rng.uniform(0.0, 1.0, (n, n)), 0.0)
    ground = torch.from_numpy(rng.normal(0, 0.5, (n, n)).astype(np.float32)).to(device)
    conf = torch.from_numpy(conf.astype(np.float32)).to(device)
    g_k, c_k = spiral.spiral_interpolation(cfg, ground.clone(), conf.clone(), 0.37)
    g_p, c_p = ground.clone(), conf.clone()
    # the plain walk takes seconds here: the comparison's own call is timed
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    spiral.spiral_interpolation_plain(cfg, g_p, c_p, 0.37)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    if not torch.equal(c_k, c_p):
        raise AssertionError(f"K3 global confidence differs in {int((c_k != c_p).sum())} cells")
    if not torch.allclose(g_k, g_p, atol=2e-5, rtol=1e-5):
        raise AssertionError(f"K3 global heights beyond atol 2e-5 / rtol 1e-5: "
                             f"max {float((g_k - g_p).abs().max())}")
    err = float((g_k - g_p).abs().max())
    h, c = ground.clone(), conf.clone()
    rec = {"max_abs_err": err, "library_ms": None, "n": n}
    rec.update(kernel_times(lambda: spiral.spiral_interpolation(cfg, h, c, 0.37), 5,
                            "spiral_global_kernel"))
    rec["plain_ms"] = plain_ms
    visits = (m - 1) * (4 * m + 2) + 1
    rec.update(bound(2 * 4 * ((2 * m + 1) ** 2 + (2 * m - 1) ** 2), 55 * visits))
    log(f"K3 spiral_interpolation (global band): {n}^2, {m - 1} rings: confidence bitwise, "
        f"height max_abs_err {err:.3g}, device {rec['device_ms']:.4f} ms, call "
        f"{rec['call_ms']:.4f} ms, plain {plain_ms:.1f} ms (one call), bound "
        f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})")
    return rec


def warm_detect_layers(config, driver, rec):
    """The detect stage's inputs on scan ``rec`` from the driver's warm state:
    the raster layers (K1) and the moved ground and confidence."""
    from groundgrid_torch.core import grid as gridlib
    from groundgrid_torch.core import rasterize as rasterlib
    from groundgrid_torch.ops import raster

    scan, binning, accept = prepared(config, driver, rec)
    layers = rasterlib.rasterize_sorted(config, binning, scan.pz, scan.t_map_velo[:3, 3],
                                        accept, scan.center, scan.t_base_map,
                                        raster.raster_reduce)
    moved = gridlib.move(config, driver.state, scan.t_base_map, scan.center, scan.center_lo)
    return (layers.points, layers.variance, layers.min_ground_height, moved.ground,
            moved.groundpatch)


def detect_times(config, tabs, args, plain_reps=20):
    """K4's times on one case and its bound: reads 5 layers, 3 float tables
    and use3 once, writes 2 layers; per interior cell 6 operations per
    window cell (2 products, 3 sums, a min) over its 3x3 or 5x5 window, ~25
    for the branch ladder."""
    from groundgrid_torch.ops import detect

    rec = kernel_times(lambda: detect.detect_fused(config, tabs, *args), 100, "detect_kernel",
                       lambda: detect.detect_fused_plain(config, tabs, *args), plain_reps)
    n = config.cell_count
    ins = list(args) + [tabs.var_thr_sq, tabs.skip_thr, tabs.min_expected_s, tabs.use3]
    use3 = tabs.use3[2:n - 2, 2:n - 2]
    n3 = int(use3.sum())
    flops = 6 * (9 * n3 + 25 * (use3.numel() - n3)) + 25 * use3.numel()
    rec.update(bound(sum(t.nbytes for t in ins) + 2 * 4 * n * n, flops))
    return rec


def check_detect(config, driver, rec, records):
    """K4 on the warm raster layers of one real scan at 364^2 and at 1200^2
    (``HIGHRES_CONFIG``, a fused-detect driver warmed on ``records[:4]``) and
    on random layers at n = 12 and 45, against its plain version: bitwise,
    and two runs bitwise. Timed at both grid sizes."""
    from groundgrid_torch.config import HIGHRES_CONFIG, GroundGridConfig
    from groundgrid_torch.core import detect as detectlib
    from groundgrid_torch.data.synthetic import detect_layers
    from groundgrid_torch.ops import detect

    device = driver.device
    high = dataclasses.replace(HIGHRES_CONFIG, sorted_scans=True, fused_detect=True)
    high_driver = warm_driver(high, records, device)
    cases = [("364^2 warm scan", config, detectlib.make_tables(config, device),
              warm_detect_layers(config, driver, rec)),
             ("1200^2 warm scan", high, detectlib.make_tables(high, device),
              warm_detect_layers(high, high_driver, rec))]
    # n = 12 (points x10: the default density passes no skip threshold) and
    # 45; seed 3 with variance x0.01, where cells take the main update
    for dim, res, scale in ((6.0, 0.5, 10.0), (16.65, 0.37, 1.0)):
        cfg = GroundGridConfig(dimension=dim, resolution=res)
        tabs = detectlib.make_tables(cfg, device)
        for seed in range(4):
            arrs = list(detect_layers(cfg.cell_count, seed))
            arrs[0] = arrs[0] * np.float32(scale)
            if seed == 3:
                arrs[1] = arrs[1] * np.float32(0.01)
            cases.append((f"n={cfg.cell_count} seed {seed}", cfg, tabs,
                          tuple(torch.from_numpy(a).to(device) for a in arrs)))
    err, changed = 0.0, []
    for name, cfg, tabs, args in cases:
        got = detect.detect_fused(cfg, tabs, *args)
        again = detect.detect_fused(cfg, tabs, *args)
        want = detect.detect_fused_plain(cfg, tabs, *args)
        for g, a, w, what in zip(got, again, want, ("ground", "confidence")):
            if not torch.equal(g, w):
                raise AssertionError(f"K4 ({name}) {what} differs in {int((g != w).sum())} "
                                     f"cells, max {float((g - w).abs().max())}")
            if not torch.equal(g.view(torch.int32), a.view(torch.int32)):
                raise AssertionError(f"K4 ({name}) {what}: two runs not bitwise equal")
            err = max(err, float((g - w).abs().max()))
        changed.append(int((got[1] != args[4]).sum()))
        if not changed[-1]:
            raise AssertionError(f"K4 ({name}): the sweep changed no cell")
    out = {"max_abs_err": err, "library_ms": None}
    out.update(detect_times(*cases[0][1:]))
    high_times = detect_times(*cases[1][1:], plain_reps=5)
    for key in ("device_ms", "wrapper_device_ms", "call_ms", "plain_ms", "bound_ms"):
        out[key + "_highres"] = high_times[key]
    for i, suffix in ((0, ""), (1, "_highres")):
        n = cases[i][1].cell_count
        log(f"K4 detect_fused {n}^2 warm scan ({changed[i]} cells updated): device "
            f"{out['device_ms' + suffix]:.4f} ms (wrapper {out['wrapper_device_ms' + suffix]:.4f} "
            f"ms), call {out['call_ms' + suffix]:.4f} ms, plain {out['plain_ms' + suffix]:.4f} "
            f"ms, bound {out['bound_ms' + suffix]:.4f} ms ({out['bound_by']})")
    log("K4 detect_fused: bitwise and two runs bitwise at 364^2, 1200^2, n=12 and n=45 "
        "(4 seeds each)")
    return out


def run_sequence(config, records, device, with_aux=False, driver=None, per_scan=None):
    """Results (input order) of ``driver`` (a fresh one by default) over
    ``records``, with the CUDA-event and host-clock ms/scan of the run;
    ``per_scan(driver)`` runs after each scan."""
    from groundgrid_torch.runtime.driver import StreamingDriver

    if driver is None:
        driver = StreamingDriver(config, device, with_aux=with_aux)
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    results = []
    for rec in records:
        results.append(driver.process(rec))
        if per_scan is not None:
            per_scan(driver)
    end.record()
    end.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1000.0 / len(records)
    event_ms = start.elapsed_time(end) / len(records)
    return results, driver, event_ms, wall_ms


def path_counts():
    """The launch counts since the last reset, with K3's split by variant:
    ``spiral_band`` (``spiral.cu``) and ``spiral_global``."""
    from groundgrid_torch.ops import launch_counts, spiral

    counts = launch_counts()
    spiral_global = spiral.spiral_interpolation.global_launches
    return dict(counts, spiral_band=counts["spiral"] - spiral_global,
                spiral_global=spiral_global)


def check_launches(counts, want, driver, name):
    log(f"{name} over {want['spiral']} scans: launches {counts} (want {want}), "
        f"fallbacks {driver.step.fallbacks}")
    if {k: counts[k] for k in want} != want:
        raise AssertionError(f"{name}: launch counts {counts} != {want}")
    if driver.step.fallbacks != 0:
        raise AssertionError(f"{name}: {driver.step.fallbacks} sortedness fallbacks")


def check_labels(results, records):
    for res, rec in zip(results, records):
        lbl = res.labels
        if lbl.shape != (rec.points.shape[0],) or not np.isin(lbl, (0, 49, 99)).all():
            raise AssertionError("labels of the wrong shape or values")


def agreement(a, b, name):
    total = sum(len(r.labels) for r in a)
    mism = sum(int((x.labels != y.labels).sum()) for x, y in zip(a, b))
    if 1 - mism / total < AGREE_MIN:
        raise AssertionError(f"{name}: label agreement below {AGREE_MIN:.1%}")
    return mism, total


def phase_sequence(config, records, device):
    from groundgrid_torch.ops import reset_launch_counts

    reset_launch_counts()
    results, driver, event_ms, wall_ms = run_sequence(config, records, device)
    counts = path_counts()
    n = len(records)
    check_launches(counts, {"raster": n, "lookup": 3 * n, "spiral": n, "detect": 0}, driver,
                   "main path")
    log(f"main path: {event_ms:.3f} ms/scan (CUDA events, host prep included), "
        f"{1000.0 / event_ms:.2f} scans/s; host clock {wall_ms:.3f} ms/scan")

    check_labels(results, records)
    for t in (driver.state.ground, driver.state.groundpatch):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError("grid layers not finite")

    plain_cfg = dataclasses.replace(config, use_pallas=False)
    plain, _, plain_ms, _ = run_sequence(plain_cfg, records, device)
    mism, total = agreement(results, plain, "main path")
    log(f"labels vs plain versions on the card: {mism} of {total} points differ "
        f"({1 - mism / total:.6%} agree; plain path {plain_ms:.3f} ms/scan)")

    again, driver2, _, _ = run_sequence(config, records, device)
    labels = [r.labels for r in results]
    if not all(np.array_equal(a.labels, b) for a, b in zip(again, labels)):
        raise AssertionError("second kernel run: labels not bitwise equal")
    for a, b in ((driver.state.ground, driver2.state.ground),
                 (driver.state.groundpatch, driver2.state.groundpatch)):
        if not torch.equal(a, b):
            raise AssertionError("second kernel run: grid layers not bitwise equal")
    log("determinism: second kernel run bitwise equal (labels and layers)")

    truth = np.concatenate([np.isin(r.labels, GROUND_TRUTH_IDS) for r in records[4:]])
    pred = np.concatenate(labels[4:])
    scored = pred != 0
    tp = int((truth & (pred == 49) & scored).sum())
    recall = tp / max(int((truth & scored).sum()), 1)
    precision = tp / max(int((pred == 49).sum()), 1)
    log(f"ground vs synthetic truth (warm scans): recall {recall:.4f} precision {precision:.4f}")
    if recall < 0.9 or precision < 0.8:
        raise AssertionError("ground recall/precision below 0.9/0.8")
    return counts, results


def phase_layers(config, records, device):
    """Phase 4: the layer-publishing wire path with the fused detect stencil."""
    from groundgrid_torch.ops import launch_counts, reset_launch_counts
    from groundgrid_torch.runtime.checkpoint import load_state, save_state
    from groundgrid_torch.runtime.driver import StreamingDriver

    n, half = len(records), len(records) // 2
    reset_launch_counts()
    results, driver, event_ms, wall_ms = run_sequence(config, records, device, with_aux=True)
    counts = launch_counts()
    check_launches(counts, {"raster": 2 * n, "lookup": 3 * n, "spiral": n, "detect": n},
                   driver, "layers path")
    log(f"layers path: {event_ms:.3f} ms/scan (CUDA events, host prep included), "
        f"{1000.0 / event_ms:.2f} scans/s; host clock {wall_ms:.3f} ms/scan")
    check_labels(results, records)
    cells = config.cell_count
    for res in results:
        if len(res.aux) != 11:
            raise AssertionError(f"{len(res.aux)} aux layers, want 11")
        for name, a in res.aux.items():
            if a.shape != (cells, cells) or not np.isfinite(a).all():
                raise AssertionError(f"aux layer {name}: shape {a.shape} or not finite")
        if res.aux["points"].sum() != (res.labels == 99).sum():
            raise AssertionError("aux points layer is not the non-ground count")

    plain, _, plain_ms, _ = run_sequence(dataclasses.replace(config, use_pallas=False),
                                         records, device, with_aux=True)
    mism, total = agreement(results, plain, "layers path")
    for a, b in zip(results, plain):
        for name in ("points", "points_raw", "min_ground_height", "max_ground_height"):
            if not np.array_equal(a.aux[name], b.aux[name]):
                raise AssertionError(f"layers path: aux {name} differs from the plain run")
    log(f"layers path vs plain versions on the card: {mism} of {total} points differ "
        f"({1 - mism / total:.6%} agree; points, points_raw, min and max layers bitwise; "
        f"plain path {plain_ms:.3f} ms/scan)")

    def same(a, b):
        return (np.array_equal(a.labels, b.labels)
                and all(np.array_equal(a.aux[k], b.aux[k]) for k in a.aux))

    # a second kernel run, checkpointed after scan ``half`` and resumed
    first, second, _, _ = run_sequence(config, records[:half], device, with_aux=True)
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/state.npz"
        save_state(path, second.state, half, config, center64=second.center64)
        state, nxt, extra = load_state(path, config, device)
    rest, _, _, _ = run_sequence(config, records[half:], device, with_aux=True,
                                 driver=second)
    if not all(same(a, b) for a, b in zip(first + rest, results)):
        raise AssertionError("second kernel run: labels or layers not bitwise equal")
    resumed = StreamingDriver(config, device, with_aux=True)
    resumed.restore(state, extra["center64"])
    again, _, _, _ = run_sequence(config, records[nxt:], device, driver=resumed)
    if not all(same(a, b) for a, b in zip(again, results[nxt:])):
        raise AssertionError(f"resume after scan {nxt}: not bitwise the uninterrupted run")
    log(f"determinism: second kernel run bitwise equal (labels and 11 layers); "
        f"checkpoint after scan {nxt} resumed bitwise over scans {nxt + 1}-{n}")
    return counts


def phase_layers_highres(config, records, device):
    """Phase 4 at 1200^2: the layer-publishing wire path at ``HIGHRES_CONFIG``
    over ``records``, twice; launch counts per scan (K4 x1), 11 finite layers,
    the second run bitwise the first."""
    from groundgrid_torch.ops import launch_counts, reset_launch_counts

    n = len(records)
    reset_launch_counts()
    results, driver, event_ms, wall_ms = run_sequence(config, records, device, with_aux=True)
    counts = launch_counts()
    check_launches(counts, {"raster": 2 * n, "lookup": 3 * n, "spiral": n, "detect": n},
                   driver, f"layers path at {config.cell_count}^2")
    check_labels(results, records)
    cells = config.cell_count
    for res in results:
        if len(res.aux) != 11 or any(a.shape != (cells, cells) or not np.isfinite(a).all()
                                     for a in res.aux.values()):
            raise AssertionError(f"layers path at {cells}^2: aux layers wrong or not finite")
    again, _, again_ms, _ = run_sequence(config, records, device, with_aux=True)
    for a, b in zip(results, again):
        if not (np.array_equal(a.labels, b.labels)
                and all(np.array_equal(a.aux[k], b.aux[k]) for k in a.aux)):
            raise AssertionError(f"layers path at {cells}^2: second run not bitwise equal")
    log(f"layers path at {cells}^2 over {n} scans: {event_ms:.3f} / {again_ms:.3f} ms/scan "
        f"(CUDA events, two runs, host prep included); host clock {wall_ms:.3f} ms/scan; "
        f"second run bitwise equal (labels and 11 layers)")
    return counts


class StepRecorder:
    """Keeps every step the CLI's drivers build, to read their fallbacks."""

    def __init__(self):
        from groundgrid_torch.runtime import driver

        self.steps = []
        self._module, self._make = driver, driver.make_step

    def __enter__(self):
        def make_step(*args, **kwargs):
            self.steps.append(self._make(*args, **kwargs))
            return self.steps[-1]

        self._module.make_step = make_step
        return self

    def __exit__(self, *exc):
        self._module.make_step = self._make

    @property
    def fallbacks(self) -> int:
        return sum(s.fallbacks for s in self.steps)


def run_cli(argv, n_scans, device, raster_per_scan=1):
    """``cli.main(argv)`` with its launch counts checked; returns its output
    lines (an ``evaluate``'s without the JSON payload), the payload and the
    CUDA-event ms/scan."""
    from groundgrid_torch.ops import launch_counts, reset_launch_counts
    from groundgrid_torch.runtime import cli

    out, err = io.StringIO(), io.StringIO()
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with StepRecorder() as steps, contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(err):
        reset_launch_counts()
        start.record()
        rc = cli.main(argv)
        end.record()
        end.synchronize()
        counts = launch_counts()
    sys.stderr.write(err.getvalue())
    if rc != 0:
        raise AssertionError(f"{' '.join(argv[:1])}: exit code {rc}")
    if "is not native" in err.getvalue():
        raise AssertionError("the C++ loader did not build: scans were prepared in NumPy")
    want = {"raster": raster_per_scan * n_scans, "lookup": 3 * n_scans, "spiral": n_scans,
            "detect": 0}
    if counts != want or steps.fallbacks:
        raise AssertionError(f"{' '.join(argv)}: launches {counts} (want {want}), "
                             f"{steps.fallbacks} sortedness fallbacks")
    lines = out.getvalue().strip().splitlines()
    ms = start.elapsed_time(end) / n_scans
    if argv[0] != "evaluate":
        return lines, None, ms
    return lines[:-1], json.loads(lines[-1]), ms


def host_prep_ms(root, config, device, n):
    """Per-scan host prep as the consumer sees it: NumPy (read + ``make_scan``)
    against a wait on the native loader, with the step run between waits."""
    from groundgrid_torch.data.native_loader import SortedPrefetchingLoader
    from groundgrid_torch.data.semantickitti import SemanticKITTI
    from groundgrid_torch.runtime.driver import StreamingDriver

    ds = SemanticKITTI(root, "00")
    numpy_ms, native_ms = [], []
    driver = StreamingDriver(config, device)
    for k in range(n):
        t0 = time.perf_counter()
        rec = ds.read_scan(k)
        driver.make_scan(rec)
        torch.cuda.synchronize(device)
        numpy_ms.append((time.perf_counter() - t0) * 1000.0)
        driver.process(rec)
    loader = SortedPrefetchingLoader(ds, config, device)
    if not loader.native:
        raise AssertionError("SortedPrefetchingLoader is not native")
    driver, it = StreamingDriver(config, device), iter(loader)
    for _ in range(n):
        t0 = time.perf_counter()
        rec = next(it)
        torch.cuda.synchronize(device)
        native_ms.append((time.perf_counter() - t0) * 1000.0)
        driver.process(rec)
    loader.close()
    return numpy_ms, native_ms


def phase_entry_point(config, records, device):
    """Phase 5: ``python -m groundgrid_torch`` evaluate and playback."""
    from groundgrid_torch.data.native_loader import WirePrefetchingLoader
    from groundgrid_torch.data.semantickitti import SemanticKITTI, write_sequence

    n = len(records)
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        write_sequence(root, 0, [(r.points, r.labels, r.t_map_velo) for r in records])
        ds = SemanticKITTI(root, "00")
        size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root) for f in fs)
        log(f"entry point: {n} scans written as a SemanticKITTI sequence "
            f"({size / 2**20:.1f} MiB) in {time.perf_counter() - t0:.1f} s")
        wire_cfg = dataclasses.replace(config, wire_format=True)
        wire_loader = WirePrefetchingLoader(ds, wire_cfg, device)
        if not wire_loader.native:
            raise AssertionError("WirePrefetchingLoader is not native")
        wire_loader.close()

        common = ["--sequence", "00", "--device", str(device), "--dimension",
                  repr(config.dimension), "--resolution", repr(config.resolution),
                  "--max-points", str(config.max_points)]
        base = ["evaluate", "--directory", root] + common
        native = ["--native-loader"]
        variants = {"a": base, "b": base + native, "c": base + native + ["--pipeline-depth", "2"],
                    "d": base + native + ["--on-device-eval"], "e": base + ["--wire"] + native}
        runs = {k: run_cli(argv, n, device) for k, argv in variants.items()}

        ckpt = os.path.join(root, "state.npz")
        half = n // 2
        end_s = repr(float(ds.times[half - 1]))
        first = run_cli(base + ["--checkpoint", ckpt, "--checkpoint-every", str(half // 2),
                                "--end", end_s], half, device)
        runs["f"] = run_cli(base + ["--checkpoint", ckpt, "--resume"], n - half, device)

        layers, html = os.path.join(root, "layers"), os.path.join(root, "player.html")
        play = ["playback", "--directory", root] + common + [
            "--native-loader", "--pipeline-depth", "2", "--export-layers", layers,
            "--export-every", "8", "--export-html", html]
        play_lines, _, play_ms = run_cli(play, n, device, raster_per_scan=2)

        metrics = {k: {key: v for key, v in p.items() if key not in TIMING_KEYS}
                   for k, (_, p, _) in runs.items()}
        for k in "bcdf":
            if runs[k][0] != runs["a"][0] or metrics[k] != metrics["a"]:
                raise AssertionError(f"variant ({k}): statistics or metrics differ from (a)")
        if first[1]["scans"] != half or runs["f"][1]["scans"] != n:
            raise AssertionError("checkpointed run: wrong scan counts")
        for key in ("f1", "ioug"):
            delta = abs(metrics["e"][key] - metrics["a"][key]) * 100.0
            if delta > WIRE_BUDGET_PT:
                raise AssertionError(f"wire (e): {key} {delta:.3f} pt from (a)")
        exported = sorted(os.listdir(layers))
        if len(exported) != 11 * len(range(0, n, 8)):
            raise AssertionError(f"playback: {len(exported)} layer PNGs")
        if not os.path.getsize(html) or not any("-frame player" in s for s in play_lines):
            raise AssertionError("playback: no HTML player written")
        if sum(s.startswith("scan ") for s in play_lines) != n:
            raise AssertionError("playback: not one line per scan")
        numpy_ms, native_ms = host_prep_ms(root, config, device, n)

    log(f"entry point: (a)-(d) and resumed (f) bitwise (statistics block and metrics: "
        f"F1 {metrics['a']['f1']:.6f}, IoUg {metrics['a']['ioug']:.6f}); wire (e) "
        f"F1 {metrics['e']['f1']:.6f}, IoUg {metrics['e']['ioug']:.6f}; launches per scan "
        f"K1 x1 (x2 playback), K2 x3, K3 x1; 0 fallbacks; loaders native; "
        f"{len(exported)} layer PNGs and the player written")
    names = {"a": "evaluate, NumPy prep", "b": "--native-loader",
             "c": "--native-loader --pipeline-depth 2", "d": "--native-loader --on-device-eval",
             "e": "--wire --native-loader", "f": "--resume (second half)"}
    for k, (_, p, ms) in runs.items():
        log(f"entry point ({k}) {names[k]}: payload avg_ms {p['avg_ms']:.3f} "
            f"({p['scans_per_sec']:.2f} scans/s, depth {p['pipeline_depth']}); "
            f"CUDA events around the call {ms:.3f} ms/scan")
    log(f"entry point (g) playback --native-loader --pipeline-depth 2 with exports: "
        f"CUDA events around the call {play_ms:.3f} ms/scan")
    log(f"host prep per scan: NumPy p50 {np.percentile(numpy_ms, 50):.3f} ms "
        f"(p90 {np.percentile(numpy_ms, 90):.3f}); native loader wait p50 "
        f"{np.percentile(native_ms, 50):.3f} ms (p90 {np.percentile(native_ms, 90):.3f})")


def phase_unsorted(records, sorted_results, device):
    """Phase 6: the unsorted default path against its plain run, phase 3's
    sorted labels and a second kernel run; the device sort's own time."""
    from groundgrid_torch.config import GroundGridConfig
    from groundgrid_torch.core import rasterize as rasterlib
    from groundgrid_torch.core import transforms as tf
    from groundgrid_torch.ops import reset_launch_counts
    from groundgrid_torch.pipeline import pad_scan
    from groundgrid_torch.runtime.kernel_timing import device_ms

    config = GroundGridConfig()
    if config.sorted_scans:
        raise AssertionError("the config default is not unsorted mode")
    n = len(records)
    reset_launch_counts()
    results, driver, event_ms, wall_ms = run_sequence(config, records, device)
    counts = path_counts()
    check_launches(counts, {"raster": n, "lookup": 3 * n, "spiral": n, "detect": 0}, driver,
                   "unsorted path")
    check_labels(results, records)
    for t in (driver.state.ground, driver.state.groundpatch):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError("unsorted path: grid layers not finite")
    log(f"unsorted path: {event_ms:.3f} ms/scan (CUDA events, host prep included), "
        f"{1000.0 / event_ms:.2f} scans/s; host clock {wall_ms:.3f} ms/scan")

    cut = records[:N_PLAIN_UNSORTED]
    plain, _, plain_ms, _ = run_sequence(dataclasses.replace(config, use_pallas=False), cut,
                                         device)
    mism, total = agreement(results[:N_PLAIN_UNSORTED], plain, "unsorted path vs plain")
    smism, stotal = agreement(results, sorted_results, "unsorted vs sorted path")
    log(f"unsorted path vs plain versions on the card (first {len(cut)} scans): {mism} of "
        f"{total} points differ ({1 - mism / total:.6%} agree; plain {plain_ms:.3f} ms/scan); "
        f"vs phase 3's sorted labels: {smism} of {stotal} differ "
        f"({1 - smism / stotal:.6%} agree)")

    again, driver2, again_ms, _ = run_sequence(config, records, device)
    if not all(np.array_equal(a.labels, b.labels) for a, b in zip(results, again)):
        raise AssertionError("unsorted path, second kernel run: labels not bitwise equal")
    for a, b in ((driver.state.ground, driver2.state.ground),
                 (driver.state.groundpatch, driver2.state.groundpatch)):
        if not torch.equal(a, b):
            raise AssertionError("unsorted path, second kernel run: layers not bitwise equal")

    # the stable sort of one scan's cell ids, as the step runs it
    rec = records[4]
    scan = pad_scan(config, rec.points, rec.labels, rec.t_map_velo, device)
    x, y, _ = tf.transform_points_soa(scan.t_map_velo, scan.px, scan.py, scan.pz)
    center = np.asarray(scan.t_map_velo, np.float32)[:2, 3]
    cell = rasterlib.bin_points(config, center, None, x, y, scan.rings, scan.valid > 0,
                                scan.t_map_velo[:3, 3]).cell
    sort_ms, activities = device_ms(lambda: torch.argsort(cell, stable=True), 50)
    log(f"unsorted path: second kernel run bitwise ({again_ms:.3f} ms/scan); device stable "
        f"sort of {cell.shape[0]} cell ids {sort_ms:.4f} device ms ({activities // 50} device "
        f"activities a sort)")
    return counts, {"ms_per_scan": event_ms, "again_ms_per_scan": again_ms,
                    "plain_ms_per_scan": plain_ms, "sort_device_ms": sort_ms}


def phase_topk(device):
    """Phase 7: a 128-beam sensor's 262,144-point buffer (sorted mode), where
    the march selects candidates by the exact-budget key."""
    from groundgrid_torch.config import GroundGridConfig
    from groundgrid_torch.core.outliers import IDX_BITS
    from groundgrid_torch.data.semantickitti import ScanRecord
    from groundgrid_torch.data.synthetic import synthetic_sequence
    from groundgrid_torch.ops import reset_launch_counts

    config = GroundGridConfig(max_points=TOPK_POINTS, sorted_scans=True)
    if config.max_points <= 1 << IDX_BITS:
        raise AssertionError("phase 7's buffer does not take the exact-budget key")
    t0 = time.perf_counter()
    records = [ScanRecord(index=k, timestamp=0.1 * k, points=p, labels=l, t_map_velo=T)
               for k, (p, l, T) in enumerate(synthetic_sequence(
                   N_TOPK_SCANS, seed=0, n_beams=128, n_azimuth=2048, step_m=1.2))]
    points = [r.points.shape[0] for r in records]
    if max(points) > config.max_points or min(points) <= 1 << IDX_BITS:
        raise AssertionError(f"128-beam scans of {min(points)}-{max(points)} points")
    render_s = time.perf_counter() - t0
    n = len(records)
    candidates = []
    reset_launch_counts()
    results, driver, event_ms, wall_ms = run_sequence(
        config, records, device, per_scan=lambda d: candidates.append(d.step.marchable))
    counts = path_counts()
    check_launches(counts, {"raster": n, "lookup": 3 * n, "spiral": n, "detect": 0}, driver,
                   "128-beam path")
    check_labels(results, records)
    plain, _, plain_ms, _ = run_sequence(dataclasses.replace(config, use_pallas=False),
                                         records, device)
    mism, total = agreement(results, plain, "128-beam path vs plain")
    again, _, again_ms, _ = run_sequence(config, records, device)
    if not all(np.array_equal(a.labels, b.labels) for a, b in zip(results, again)):
        raise AssertionError("128-beam path, second kernel run: labels not bitwise equal")
    log(f"128-beam path ({n} scans rendered in {render_s:.1f} s): {min(points)}-{max(points)} "
        f"points a scan in a {config.max_points}-point buffer; marchable candidates a scan: "
        f"{candidates} against max_outlier_candidates {config.max_outlier_candidates}; "
        f"{event_ms:.3f} / {again_ms:.3f} ms/scan (CUDA events, two runs, bitwise); host clock "
        f"{wall_ms:.3f} ms/scan; vs plain versions {mism} of {total} points differ "
        f"({1 - mism / total:.6%} agree; plain {plain_ms:.3f} ms/scan)")
    return counts, {"ms_per_scan": event_ms, "again_ms_per_scan": again_ms,
                    "plain_ms_per_scan": plain_ms, "points": points, "candidates": candidates}


def phase_golden(device):
    """Phase 8: the accuracy subcommand (sorted and unsorted) and the fuzz's
    boundary rows, with the port on the card."""
    from groundgrid_torch.eval import fuzz
    from groundgrid_torch.runtime import cli

    t0 = time.perf_counter()
    # tests/test_accuracy.py's geometry and scans, cut to 6 (~23k points each)
    cut = ["accuracy", "--device", str(device), "--scans", "6", "--seed", "23", "--beams", "32",
           "--azimuth", "900", "--step", "2.0", "--dimension", "60", "--resolution", "0.5",
           "--max-points", "32768"]
    for mode in ("--sorted", "--no-sorted"):
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.main(cut + [mode])
        payload = json.loads(out.getvalue().strip().splitlines()[-1])
        log(f"accuracy {mode} (6 scans, 60 m at 0.5 m): exit {rc}, max |delta| "
            f"{payload['max_abs_delta_pt']:.4f} pt, label mismatch "
            f"{payload['label_mismatch_rate']:.3e}, backend {payload['workload']['backend']}")
        if rc != 0:
            raise AssertionError(f"accuracy {mode}: exit code {rc}")
    for name, cfg, seed in fuzz.campaign(0):
        r = fuzz.fuzz_one(cfg, seed=seed, device=device)
        log(f"fuzz boundary row '{name}': max |delta| {r['max_abs_delta_pt']:.4f} pt, "
            f"label mismatch {r['label_mismatch_rate']:.3e}")
        if not fuzz.row_ok(r, wire=False):
            raise AssertionError(f"fuzz boundary row '{name}' beyond its bounds")
    log(f"golden parity on the card: passed in {time.perf_counter() - t0:.1f} s")

def main() -> int:
    phase_environment()
    from groundgrid_torch.config import HIGHRES_CONFIG, GroundGridConfig
    from groundgrid_torch.runtime.bench import synthetic_records

    device = torch.device("cuda", 0)
    config = GroundGridConfig(sorted_scans=True)
    t0 = time.perf_counter()
    records = synthetic_records(config, N_SCANS)
    log(f"{N_SCANS} synthetic HDL-64E scans rendered in {time.perf_counter() - t0:.1f} s, "
        f"{records[0].points.shape[0]} points in the first")

    driver = warm_driver(config, records, device)
    k1, cell = check_raster(config, driver, records[4])
    k2 = check_lookup(config, driver, cell, records[4])
    k3 = check_spiral(config, driver, records[4])
    k3g = check_spiral_global(device)
    k4 = check_detect(config, driver, records[4], records)
    torch.cuda.synchronize()

    counts, sorted_results = phase_sequence(config, records, device)
    layer_config = dataclasses.replace(config, wire_format=True, fused_detect=True)
    layer_counts = phase_layers(layer_config, records[:N_LAYER_SCANS], device)
    high_config = dataclasses.replace(HIGHRES_CONFIG, sorted_scans=True, wire_format=True,
                                      fused_detect=True)
    phase_layers_highres(high_config, records[:N_HIGHRES_SCANS], device)
    phase_entry_point(config, records, device)
    unsorted_counts, _ = phase_unsorted(records, sorted_results, device)
    topk_counts, _ = phase_topk(device)
    phase_golden(device)
    kernels = []
    # launches: each kernel's count in the path it serves (K4: phase 4; K3's
    # global-band variant serves grids above 2415 cells a side, none of them)
    for name, route_file, replaces, key, res, launches in (
        ("raster_reduce", "raster.cu", "groundgrid_tpu/ops/pallas_raster.py:229", "raster", k1,
         counts),
        ("lookup", "lookup.cu", "groundgrid_tpu/ops/pallas_lookup.py:95", "lookup", k2, counts),
        ("spiral_interpolation", "spiral.cu", "groundgrid_tpu/ops/pallas_spiral.py:662",
         "spiral_band", k3, counts),
        ("spiral_interpolation_global", "spiral_global.cu",
         "groundgrid_tpu/ops/pallas_spiral.py:662", "spiral_global", k3g, counts),
        ("detect_ground_patches_fused", "detect.cu", "groundgrid_tpu/ops/pallas_detect.py:157",
         "detect", k4, layer_counts),
    ):
        kernels.append({
            "name": name, "route": "cuda", "source": f"groundgrid_torch/csrc/{route_file}",
            "replaces": replaces, "launches": launches[key],
            "launches_unsorted": unsorted_counts[key], "launches_topk": topk_counts[key],
            "max_abs_err": res["max_abs_err"],
            "ms": res["device_ms"], "device_ms": res["device_ms"],
            "wrapper_device_ms": res["wrapper_device_ms"], "call_ms": res["call_ms"],
            "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"], "library_ms": res["library_ms"],
            **{k: v for k, v in res.items() if k.endswith("_highres")},
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
