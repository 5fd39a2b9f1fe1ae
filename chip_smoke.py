"""GPU smoke test of the PyTorch port: builds and checks its CUDA kernels,
then drives the sorted-scan streaming path, the layer-publishing wire path,
the entry point, the unsorted default path, a 128-beam buffer, the golden
parity tooling, a 64-vehicle fleet and one grid split over shards, on one
card, and holds the captured step (one CUDA graph a scan, ``make_step``)
to the eager one.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero, printing no result):

1. Environment: torch and CUDA versions, the card's name and power limit,
   the kernels' build time (nvcc, one process per source under
   ``groundgrid_torch/csrc``, all started together).
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
   both grid sizes). K3's ring ranges (``spiral_interpolation_rings``) at
   364^2 and 1200^2 (warm states, ``HIGHRES_CONFIG`` for the latter) and at
   n = 2416 (the global band, random layers): the bands of S = 2 and 8 in
   order bitwise one full launch, one band against its plain version (the
   bounds above), device ms per band launch; the full launch at 1200^2
   timed alone. Per kernel: its device time
   (``torch.profiler``, the named kernel's own time per launch), the device
   time of everything one wrapper call launches, the wrapper's cost per
   call (CUDA events around back-to-back calls), the plain version's, the
   least time the card could take (the bytes this run's inputs need over
   3.35 TB/s or its f32 operations over 67 TFLOP/s: K2 reads only the
   distinct cells its ids name) and, for K2, one ``torch.index_select``
   over the stacked tables, timed in turns with the kernel (no one PyTorch
   call computes K1, K3 or K4).
3. ``StreamingDriver`` with the default sorted config over 32 consecutive
   synthetic scans: per-scan launch counts (K1 x1, K2 x3, K3 x1; a replay
   of the captured step adds the launches its capture recorded), no
   sortedness fallback, every step after the first (every replay) under
   ``torch.cuda.set_sync_debug_mode("error")`` (no device-to-host read),
   labels and outliers bitwise those of the host-read step (the counted
   march and the host sortedness check, as the step ran before it stopped
   reading the host; on the eager step, as it reads the host), labels
   against the plain-version run on the card (>= 99.9 % agreement), a second kernel run bitwise equal to the first,
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
   x3, K3 x1), the sync check and the host-read step as in phase 3, labels
   against the plain-version run over the first 8 scans
   (the plain K3 takes over a second a scan; >= 99.9 %) and against phase
   3's sorted labels over all 32 (>= 99.9 %, the JAX package's sorted-vs-
   default bar), a second kernel run bitwise, ms/scan from CUDA events, and
   the device stable sort's own device time on a scan's cell ids.
7. A 128-beam sensor's buffer, ``GroundGridConfig(max_points=262144,
   sorted_scans=True)`` over 8 scans of ``synthetic_sequence(n_beams=128,
   n_azimuth=2048)``: the march selects candidates by the exact-budget key
   above 2^17 points. Points per scan and marchable candidates against
   ``max_outlier_candidates``, launch counts, the sync check and the
   host-read step as in phase 3, labels against the plain run (>= 99.9 %),
   a second kernel run bitwise, ms/scan.
8. Golden parity with the port on the card: ``python -m groundgrid_torch
   accuracy`` at ``tests/test_accuracy.py``'s size cut to 6 scans (32 beams x
   900, a 60 m grid at 0.5 m, 32768 points), sorted and unsorted, exits 0
   within 0.1 pt; the five
   boundary configs of the config fuzz pass their row bounds (< 0.1 pt,
   < 2e-3 label mismatch).
9. BASELINE.json config 5, the fleet: ``FleetDriver(GroundGridConfig(
   sorted_scans=True), batch=64, device)`` for 4 ticks, vehicle v on phase
   3's records from record v mod 32 (backward for v >= 32): per tick K1 x64,
   K2 x192, K3 x64, the step of ticks 2-4 under the sync check (host prep
   and the tick's one fetch outside), the summary equal to the fetched
   labels' counts; every vehicle's labels and outliers (the fleet's one
   captured vehicle step) bitwise those of an eager ``StreamingDriver``
   over its stream; a 2-vehicle, 2-tick plain-version
   fleet (>= 99.9 %); tick 1 again with the summary all_reduced through a
   1-rank NCCL group (``parallel/multihost.py``): the local sum, bitwise
   labels; ``bench --batch 64``. Prints ms per tick and scans/s (CUDA
   events around the tick, host prep and fetch included) and the bench's
   metric line.
10. The spatial step (``parallel/spatial.py``), one grid split row-wise
   over an in-process mesh on the one card, sorted scans with their
   centers, both spiral modes: (a) ``HIGHRES_CONFIG`` (1200^2) over
   ``["cuda:0"] * 8``, (b) the default 364^2 over ``["cuda:0"] * 4``, each
   over the first 8 scans. The eager ``SpatialStep``: launches per scan K1
   x S, K2 x 3S, K3 x S, steps 2-8 under the sync check, banded ==
   replicated bitwise (labels, outliers, ground, groundpatch), a second run
   of each bitwise the first, against the single-grid ``Step`` over the
   same scans labels >= 99.95 %, ground atol 2e-4 / rtol 1e-4, groundpatch
   1e-5 / 1e-5 (the JAX spatial test's bounds). The captured step
   (``make_spatial_step``, one CUDA graph a scan) bitwise the eager one
   (ground, groundpatch, labels, outliers, the center pair, every scan),
   a second captured run bitwise, launches per scan as eager, every replay
   under the sync check; its capture seconds and graph pool bytes. Then ms
   per scan by CUDA events in turns (eager, captured, captured, eager),
   replays only (scans 3-8; the first two are the eager call and the
   first replay, the capture between them), and the captured single-grid
   step. With two cards or more (``phase_spatial_cards``): one shard a
   card on 2 and 4 cards, the in-process mesh (eager, and captured with
   its collectives between per-card graphs) and NCCL ranks (``GroupMesh``:
   eager and captured, the NCCL calls between per-rank graphs), each
   bitwise the same shards on one card, ms per scan in turns; with one
   card it logs that it did not run.
   ``python3 chip_smoke.py --spatial`` runs phases 1 and 10 alone.
11. The captured step (``pipeline.CapturedStep``) against the eager
   ``make_step_fn`` step, bitwise: phase 3's path over its 32 scans in four
   runs in turns (eager, captured, captured, eager; labels, outliers and
   the four state layers after every scan; two captured runs bitwise;
   every replay under the sync check), phase 4's path (labels, 11 layers,
   x/y/z; a checkpoint after scan 8 resumed on a new captured step),
   phase 6's unsorted path (and its final state), phase 7's 128-beam path
   (and its marchable counts); phase 9 holds the fleet to eager drivers.
   Then in turns (eager, captured, captured, eager), by CUDA events: phase
   3's ms per scan, the streaming bench's device ms per scan
   (``bench.device_ms_per_step``), the device busy share of 8 warm steps
   (``bench.profile_steps``), ``bench --batch 64``
   (``bench.run_fleet_benchmark``); sorted against unsorted ms per scan on
   the captured step (sorted, unsorted, unsorted, sorted). Each captured
   path prints its capture time and graph pool bytes.

The line before the last is the kernels' JSON record (``ms`` is the device
time, ``library_ms`` null where no one PyTorch call computes the function;
K4 adds its ``*_highres`` times and bound at 1200^2; ``launches`` counts phase
3, ``launches_unsorted`` phase 6, ``launches_topk`` phase 7 and
``launches_fleet`` phase 9's 4 ticks, ``launches_spatial`` the captured run
of each mode in phase 10 (the first scan eager, the rest replays); K3 adds
``*_highres`` full-launch times at 1200^2 and ``band_*_364`` / ``_1200`` /
``_2416`` ring-range results);
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
FLEET_BATCH = 64  # BASELINE.json config 5: 64 scans a step
FLEET_TICKS = 4
N_SPATIAL_SCANS = 8  # the first two untimed in the turns: an eager call, a capture
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


def scan_scalars(config, driver, scan):
    """The scan scalars of ``scan`` against the driver's state, on its device,
    as the step ships them (``core/scalars.py``)."""
    from groundgrid_torch.core import scalars as scalarlib
    from groundgrid_torch.pipeline import scan_scalars as host_scalars
    from groundgrid_torch.pipeline import to_device

    packed, _, _ = host_scalars(config, driver.state.center_np, driver.state.center_lo_np, scan)
    return scalarlib.view(to_device(packed, driver.device))


def prepared(config, driver, rec):
    """A prepared scan of ``rec``, its scan scalars, binning and accepted
    points (no march)."""
    from groundgrid_torch.core import rasterize as rasterlib

    scan, _ = driver.make_scan(rec)
    s = scan_scalars(config, driver, scan)
    binning = rasterlib.bin_points(config, s, scan.px, scan.py, scan.rings, scan.valid > 0)
    cell = binning.cell
    if not bool((cell[1:] >= cell[:-1]).all()):
        raise AssertionError("prepared scan is not cell-sorted on the device")
    return scan, s, binning, binning.inmap & ~binning.ignored


def check_raster(config, driver, rec):
    """K1 on the 7 columns of one prepared scan, against its plain version."""
    from groundgrid_torch.core import rasterize as rasterlib
    from groundgrid_torch.ops import raster
    from groundgrid_torch.runtime.kernel_timing import device_ms

    scan, s, binning, accept = prepared(config, driver, rec)
    cell = binning.cell
    cols, ops = rasterlib.raster_columns(config, binning, scan.pz, accept, s)
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
    driver's state, one lattice per chunk of candidates, as the step builds
    them: an eager step on a copy of the state, its K2 calls recorded (the
    march's are the ones not over the scan's points)."""
    from groundgrid_torch.core.grid import GridState
    from groundgrid_torch.ops import lookup
    from groundgrid_torch.pipeline import make_step_fn

    scan, _ = driver.make_scan(rec)
    step = make_step_fn(config)
    calls = []

    def keep(cell, tables, n):
        calls.append(cell.clone())
        return lookup.lookup_plain(cell, tables, n)

    step._lookup = keep
    state = driver.state
    step(GridState(state.ground.clone(), state.groundpatch.clone(), state.center.clone(),
                   state.center_lo.clone()), scan)
    lattices = [cell for cell in calls if cell.shape[0] != config.max_points]
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

    base_z = scan_scalars(config, driver, driver.make_scan(rec)[0]).base_z  # on the card
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
    base_z = torch.tensor(0.37, dtype=torch.float32, device=device)
    g_k, c_k = spiral.spiral_interpolation(cfg, ground.clone(), conf.clone(), base_z)
    g_p, c_p = ground.clone(), conf.clone()
    # the plain walk takes seconds here: the comparison's own call is timed
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    spiral.spiral_interpolation_plain(cfg, g_p, c_p, base_z)
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
    rec.update(kernel_times(lambda: spiral.spiral_interpolation(cfg, h, c, base_z), 5,
                            "spiral_global_kernel"))
    rec["plain_ms"] = plain_ms
    visits = (m - 1) * (4 * m + 2) + 1
    rec.update(bound(2 * 4 * ((2 * m + 1) ** 2 + (2 * m - 1) ** 2), 55 * visits))
    log(f"K3 spiral_interpolation (global band): {n}^2, {m - 1} rings: confidence bitwise, "
        f"height max_abs_err {err:.3g}, device {rec['device_ms']:.4f} ms, call "
        f"{rec['call_ms']:.4f} ms, plain {plain_ms:.1f} ms (one call), bound "
        f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})")
    return rec


def ring_cells(d0: int, d1: int) -> int:
    """Cells on rings d0 .. d1 (ring 0, the center, is one cell)."""
    return sum(8 * d if d else 1 for d in range(d0, d1 + 1))


def check_spiral_bands(cfg, ground, conf, base_z, name, time_full=False):
    """K3's ring ranges on ``(ground, conf)``: the bands of S = 2 and 8 run in
    order, bitwise one full launch; one band of S = 8 (the second) against
    its plain version on the same inputs (heights atol 2e-5 / rtol 1e-5,
    confidence bitwise); the device ms per band launch of S = 8 and, with
    ``time_full``, the full launch's times. Random or warm layers alike."""
    from groundgrid_torch.ops import spiral
    from groundgrid_torch.parallel.spiral_shard import band_ranges
    from groundgrid_torch.runtime.kernel_timing import device_ms

    n, m = cfg.cell_count, cfg.center_cell
    kname = "spiral_kernel" if spiral.spiral_variant(n) == "band" else "spiral_global_kernel"
    full = spiral.spiral_interpolation(cfg, ground.clone(), conf.clone(), base_z)
    out = {"n": n}
    for size in (2, 8):
        h, c = ground.clone(), conf.clone()
        for k, (d0, d1) in enumerate(band_ranges(cfg, size)):
            spiral.spiral_interpolation_rings(cfg, h, c, base_z, d0, d1, seed_center=k == 0)
        for got, want, what in ((h, full[0], "heights"), (c, full[1], "confidence")):
            if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                raise AssertionError(f"K3 {name}: the {size} bands in order differ from one "
                                     f"launch in {what} ({int((got != want).sum())} cells)")
    ranges = band_ranges(cfg, 8)
    h, c = ground.clone(), conf.clone()
    spiral.spiral_interpolation_rings(cfg, h, c, base_z, *ranges[0], seed_center=True)
    d0, d1 = ranges[1]
    g_k, c_k = spiral.spiral_interpolation_rings(cfg, h.clone(), c.clone(), base_z, d0, d1)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    g_p, c_p = spiral.spiral_interpolation_rings_plain(cfg, h.clone(), c.clone(), base_z, d0, d1,
                                                       False)
    end.record()
    end.synchronize()
    if not torch.equal(c_k, c_p):
        raise AssertionError(f"K3 {name} band {d0}-{d1}: confidence differs in "
                             f"{int((c_k != c_p).sum())} cells")
    if not torch.allclose(g_k, g_p, atol=2e-5, rtol=1e-5):
        raise AssertionError(f"K3 {name} band {d0}-{d1}: heights beyond atol 2e-5 / rtol 1e-5: "
                             f"max {float((g_k - g_p).abs().max())}")
    out["band_max_abs_err"] = float((g_k - g_p).abs().max())
    out["band_plain_ms"] = start.elapsed_time(end)
    out["band_rings"] = [d0, d1]

    def bands():
        for k, (e0, e1) in enumerate(ranges):
            spiral.spiral_interpolation_rings(cfg, h, c, base_z, e0, e1, seed_center=k == 0)

    reps = 20 if n <= 1200 else 2
    out["bands_device_ms"] = device_ms(bands, reps, kname, per_call=len(ranges))[0]
    out["band_device_ms"] = out["bands_device_ms"] / len(ranges)  # per band launch
    visits = (d1 - d0 + 1) * 2 + 8 * sum(range(d0, d1 + 1))
    out.update({"band_" + k: v for k, v in bound(
        2 * 4 * (ring_cells(d0 - 1, d1 + 1) + ring_cells(d0, d1)), 55 * visits).items()})
    if time_full:
        out.update(kernel_times(lambda: spiral.spiral_interpolation(cfg, h, c, base_z), 20,
                                kname))
        visits = (m - 1) * (4 * m + 2) + 1
        out.update(bound(2 * 4 * ((2 * m + 1) ** 2 + (2 * m - 1) ** 2), 55 * visits))
    log(f"K3 ring ranges at {name} ({n}^2): the bands of S = 2 and 8 in order bitwise one "
        f"launch; band {d0}-{d1} vs plain: confidence bitwise, heights max_abs_err "
        f"{out['band_max_abs_err']:.3g}, plain {out['band_plain_ms']:.1f} ms (one call); "
        f"device {out['band_device_ms']:.4f} ms a band launch of S = 8 "
        f"({out['bands_device_ms']:.4f} ms for all 8), band bound {out['band_bound_ms']:.5f} ms"
        + (f"; full launch device {out['device_ms']:.4f} ms, call {out['call_ms']:.4f} ms, "
           f"bound {out['bound_ms']:.4f} ms" if time_full else ""))
    return out


def check_spiral_ranges(config, driver, rec, high_driver, device):
    """Phase 2's ring-range checks: K3 at 364^2 (the warm state of ``driver``),
    at 1200^2 (``high_driver``, warm at ``HIGHRES_CONFIG``; the full launch
    timed alone) and the global-band variant at n = 2416 (random layers)."""
    from groundgrid_torch.config import GroundGridConfig

    base_z = scan_scalars(config, driver, driver.make_scan(rec)[0]).base_z
    out = {"364": check_spiral_bands(config, driver.state.ground, driver.state.groundpatch,
                                     base_z, "364^2 warm")}
    high = high_driver.config
    out["1200"] = check_spiral_bands(high, high_driver.state.ground,
                                     high_driver.state.groundpatch, base_z, "1200^2 warm",
                                     time_full=True)
    cfg = GroundGridConfig(dimension=241.6, resolution=0.1)
    rng = np.random.default_rng(1)
    n = cfg.cell_count
    conf = np.where(rng.random((n, n)) < 0.4, rng.uniform(0.0, 1.0, (n, n)), 0.0)
    out["2416"] = check_spiral_bands(
        cfg, torch.from_numpy(rng.normal(0, 0.5, (n, n)).astype(np.float32)).to(device),
        torch.from_numpy(conf.astype(np.float32)).to(device),
        torch.tensor(0.37, dtype=torch.float32, device=device), "n = 2416 (global band)")
    return out


def warm_detect_layers(config, driver, rec):
    """The detect stage's inputs on scan ``rec`` from the driver's warm state:
    the raster layers (K1) and the moved ground and confidence."""
    from groundgrid_torch.core import grid as gridlib
    from groundgrid_torch.core import rasterize as rasterlib
    from groundgrid_torch.ops import raster

    scan, s, binning, accept = prepared(config, driver, rec)
    layers = rasterlib.rasterize_sorted(config, binning, scan.pz, accept, s,
                                        raster.raster_reduce)
    ground, groundpatch = gridlib.move(config, driver.state.ground, driver.state.groundpatch, s)
    return layers.points, layers.variance, layers.min_ground_height, ground, groundpatch


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


class SyncChecked:
    """A step run under ``torch.cuda.set_sync_debug_mode("error")``: any
    device-to-host read inside it raises. Host prep and the fetch stay
    outside; the step's attributes (``fallbacks``) read through."""

    def __init__(self, step):
        self.step = step

    def __call__(self, *args):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return self.step(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    def __getattr__(self, name):
        return getattr(self.step, name)


@contextlib.contextmanager
def counted_march():
    """The march as it was before it stopped reading the host: it reads the
    marchable count and marches only min(count, cap) candidates."""
    from groundgrid_torch.core import outliers

    fixed = outliers.detect_outliers

    def counted(config, *args):
        _, marchable = fixed(config, *args)
        n_act = min(int(marchable), config.max_outlier_candidates)
        return fixed(dataclasses.replace(config, max_outlier_candidates=n_act), *args)

    outliers.detect_outliers = counted
    try:
        yield
    finally:
        outliers.detect_outliers = fixed


def same_as_host_read_step(config, records, device, results, name):
    """``results`` bitwise (labels and outlier flags) those of the step as it
    was before it stopped reading the host: the counted march, and the
    sortedness check as a Python ``bool``. ``run_sequence`` has held the
    step to 0 fallbacks, so that check found every scan sorted and left the
    raster's inputs as they came: the reference trusts the host's order
    (``sorted_fallback_check=False``)."""
    ref_config = dataclasses.replace(config, sorted_fallback_check=False)
    with counted_march():  # it reads the host: the eager step
        ref, _, _, _ = run_sequence(ref_config, records, device, eager=True)
    for a, b in zip(results, ref):
        if not (np.array_equal(a.labels, b.labels) and np.array_equal(a.outlier, b.outlier)):
            raise AssertionError(f"{name}: not bitwise the host-read step (counted march, "
                                 f"host sortedness check)")
    log(f"{name}: labels and outliers bitwise those of the host-read step (counted march, "
        f"host sortedness check) over {len(records)} scans")


def run_sequence(config, records, device, with_aux=False, driver=None, per_scan=None,
                 sync_check=False, eager=False):
    """Results (input order) of ``driver`` (a fresh one by default, on the
    captured step, or with ``eager`` on ``make_step_fn``'s) over
    ``records``, with the CUDA-event and host-clock ms/scan of the run;
    ``per_scan(driver)`` runs after each scan. With ``sync_check`` every
    step after the first (on the captured step: every replay) runs under
    :class:`SyncChecked`."""
    from groundgrid_torch.pipeline import make_step_fn
    from groundgrid_torch.runtime.driver import StreamingDriver

    if driver is None:
        driver = StreamingDriver(config, device, with_aux=with_aux)
        if eager:
            driver.step = make_step_fn(config, with_aux)
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    results = []
    for i, rec in enumerate(records):
        if sync_check and i == 1:
            driver.step = SyncChecked(driver.step)
        results.append(driver.process(rec))
        if per_scan is not None:
            per_scan(driver)
    end.record()
    end.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1000.0 / len(records)
    event_ms = start.elapsed_time(end) / len(records)
    return results, driver, event_ms, wall_ms


def log_capture(name, driver):
    """The capture time and the graph pool's bytes of ``driver``'s step."""
    step = driver.step
    if not step.captured:
        raise AssertionError(f"{name}: the driver's step was not captured")
    log(f"{name}: captured step, capture {step.capture_seconds:.3f} s, graph pool "
        f"{step.pool_bytes} bytes ({step.pool_bytes / 2 ** 20:.1f} MiB)")
    return {"capture_s": step.capture_seconds, "pool_bytes": step.pool_bytes}


def state_record(driver):
    """Copies of the driver's four state layers (the captured step's are
    overwritten in place)."""
    s = driver.state
    return s.ground.clone(), s.groundpatch.clone(), s.center.clone(), s.center_lo.clone()


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
    results, driver, event_ms, wall_ms = run_sequence(config, records, device, sync_check=True)
    counts = path_counts()
    n = len(records)
    check_launches(counts, {"raster": n, "lookup": 3 * n, "spiral": n, "detect": 0}, driver,
                   "main path")
    log(f"main path: {event_ms:.3f} ms/scan (CUDA events, host prep included), "
        f"{1000.0 / event_ms:.2f} scans/s; host clock {wall_ms:.3f} ms/scan; steps 2-{n} under "
        f"the sync check")
    log_capture("main path", driver)
    same_as_host_read_step(config, records, device, results, "main path")

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
    log_capture("layers path", driver)
    return counts, results


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
    from groundgrid_torch.core import scalars as scalarlib
    from groundgrid_torch.core import transforms as tf
    from groundgrid_torch.ops import reset_launch_counts
    from groundgrid_torch.pipeline import pad_scan, to_device
    from groundgrid_torch.runtime.kernel_timing import device_ms

    config = GroundGridConfig()
    if config.sorted_scans:
        raise AssertionError("the config default is not unsorted mode")
    n = len(records)
    reset_launch_counts()
    results, driver, event_ms, wall_ms = run_sequence(config, records, device, sync_check=True)
    counts = path_counts()
    check_launches(counts, {"raster": n, "lookup": 3 * n, "spiral": n, "detect": 0}, driver,
                   "unsorted path")
    check_labels(results, records)
    for t in (driver.state.ground, driver.state.groundpatch):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError("unsorted path: grid layers not finite")
    log(f"unsorted path: {event_ms:.3f} ms/scan (CUDA events, host prep included), "
        f"{1000.0 / event_ms:.2f} scans/s; host clock {wall_ms:.3f} ms/scan; steps 2-{n} under "
        f"the sync check")
    same_as_host_read_step(config, records, device, results, "unsorted path")

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
    s = scalarlib.view(to_device(scalarlib.pack(config, center, None, (0, 0), scan.t_map_velo,
                                                scan.t_map_base, scan.t_base_map), device))
    cell = rasterlib.bin_points(config, s, x, y, scan.rings, scan.valid > 0).cell
    sort_ms, activities = device_ms(lambda: torch.argsort(cell, stable=True), 50)
    log(f"unsorted path: second kernel run bitwise ({again_ms:.3f} ms/scan); device stable "
        f"sort of {cell.shape[0]} cell ids {sort_ms:.4f} device ms ({activities // 50} device "
        f"activities a sort)")
    log_capture("unsorted path", driver)
    return counts, {"ms_per_scan": event_ms, "again_ms_per_scan": again_ms,
                    "plain_ms_per_scan": plain_ms, "sort_device_ms": sort_ms,
                    "results": results, "state": state_record(driver)}


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
        config, records, device, per_scan=lambda d: candidates.append(d.step.marchable),
        sync_check=True)
    counts = path_counts()
    check_launches(counts, {"raster": n, "lookup": 3 * n, "spiral": n, "detect": 0}, driver,
                   "128-beam path")
    check_labels(results, records)
    same_as_host_read_step(config, records, device, results, "128-beam path")
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
    log_capture("128-beam path", driver)
    return counts, {"ms_per_scan": event_ms, "again_ms_per_scan": again_ms,
                    "plain_ms_per_scan": plain_ms, "points": points, "candidates": candidates,
                    "results": results, "config": config, "records": records}


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


def fleet_streams(records, n_vehicles, n_ticks):
    """Vehicle v drives phase 3's records from record ``v mod n``, forward
    for the first n vehicles and backward after: no two share a stream."""
    n = len(records)
    step = [1 if v < n else -1 for v in range(n_vehicles)]
    return [[records[(v + step[v] * k) % n] for k in range(n_ticks)] for v in range(n_vehicles)]


def check_summary(tick, name):
    counts = (int((tick.labels == 49).sum()), int((tick.labels == 99).sum()),
              int(tick.outlier.sum()))
    summary = (tick.ground_points, tick.nonground_points, tick.outliers)
    if summary != counts:
        raise AssertionError(f"{name}: fleet summary {summary} != the labels' counts {counts}")
    return counts


def phase_fleet(config, records, device):
    """Phase 9: BASELINE config 5, a fleet of FLEET_BATCH vehicles."""
    import torch.distributed as dist

    from groundgrid_torch.ops import reset_launch_counts
    from groundgrid_torch.parallel.multihost import init_multihost
    from groundgrid_torch.runtime import cli
    from groundgrid_torch.runtime.fleet import FleetDriver

    b = FLEET_BATCH
    streams = fleet_streams(records, b, FLEET_TICKS)
    fleet = FleetDriver(config, batch=b, device=device)
    ticks, tick_ms, total = [], [], {}
    want = {"raster": b, "lookup": 3 * b, "spiral": b, "detect": 0, "spiral_band": b,
            "spiral_global": 0}
    for k in range(FLEET_TICKS):
        if k == 1:  # ticks 2+: the step under the sync check, prep and fetch outside
            fleet.step = SyncChecked(fleet.step)
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        reset_launch_counts()
        start.record()
        tok = fleet.dispatch([s[k] for s in streams])
        counts = path_counts()
        ticks.append(fleet.fetch(tok))  # the tick's one blocking read
        end.record()
        end.synchronize()
        tick_ms.append(start.elapsed_time(end))
        if counts != want:
            raise AssertionError(f"fleet tick {k + 1}: launches {counts} (want {want})")
        total = {key: total.get(key, 0) + v for key, v in counts.items()}
        check_summary(ticks[-1], f"fleet tick {k + 1}")
    if fleet.step.fallbacks:
        raise AssertionError(f"fleet: {fleet.step.fallbacks} sortedness fallbacks")
    log(f"fleet of {b}, {FLEET_TICKS} ticks: launches per tick {want}; ticks 2-{FLEET_TICKS} "
        f"stepped under the sync check; ms per tick (CUDA events, host prep and fetch "
        f"included) {', '.join(f'{t:.1f}' for t in tick_ms)}, "
        f"{1000.0 * b * len(tick_ms) / sum(tick_ms):.2f} scans/s")

    # the reference: one eager StreamingDriver per vehicle (the fleet runs
    # one captured step: phase 11's fleet check)
    stream_ms = []
    for v, stream in enumerate(streams):
        results, _, ms, _ = run_sequence(config, stream, device, eager=True)
        stream_ms.append(ms)
        for k, res in enumerate(results):
            n = res.n_points
            if not (np.array_equal(ticks[k].labels[v][:n], res.labels)
                    and np.array_equal(ticks[k].outlier[v][:n] > 0, res.outlier)):
                raise AssertionError(f"fleet vehicle {v} tick {k + 1}: not bitwise streaming")
    captured = fleet.step.steps[0]
    log(f"fleet: labels and outliers of all {b} vehicles (one captured step: capture "
        f"{captured.capture_seconds:.3f} s, pool {captured.pool_bytes} bytes) bitwise {b} eager "
        f"StreamingDrivers over the same streams ({np.mean(stream_ms):.3f} ms/scan streaming, "
        f"CUDA events)")

    plain = FleetDriver(dataclasses.replace(config, use_pallas=False), batch=2, device=device)
    reset_launch_counts()
    plain_ticks = list(plain.run([s[:2] for s in streams[:2]]))
    if any(path_counts()[key] for key in ("raster", "lookup", "spiral", "detect")):
        raise AssertionError("plain-version fleet launched a kernel")
    total_pts = mism = 0
    for k, pt in enumerate(plain_ticks):
        for v in range(2):
            n = pt.n_points[v]
            total_pts += n
            mism += int((pt.labels[v][:n] != ticks[k].labels[v][:n]).sum())
    if 1 - mism / total_pts < AGREE_MIN:
        raise AssertionError(f"fleet vs plain: {mism} of {total_pts} labels differ")
    log(f"fleet vs a 2-vehicle, 2-tick plain-version fleet: {mism} of {total_pts} labels "
        f"differ ({1 - mism / total_pts:.6%} agree)")

    # the summary's all_reduce through a 1-rank NCCL group: tick 1 again
    with tempfile.TemporaryDirectory() as tmp:
        if init_multihost(f"file://{tmp}/store", 1, 0, device=device):
            raise AssertionError("a 1-rank group reports several processes")
        try:
            if dist.get_backend() != "nccl":
                raise AssertionError(f"backend {dist.get_backend()} on the card, want nccl")
            grouped = FleetDriver(config, batch=b, device=device).process(
                [s[0] for s in streams])
        finally:
            dist.destroy_process_group()
    local = check_summary(grouped, "fleet through NCCL")
    if local != check_summary(ticks[0], "fleet tick 1") or not np.array_equal(
            grouped.labels, ticks[0].labels):
        raise AssertionError("fleet through a 1-rank NCCL group differs from tick 1")
    log(f"fleet summary all_reduced through a 1-rank NCCL group: {local} (ground, non-ground, "
        f"outliers), the local sum and tick 1's")

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(["bench", "--batch", str(b), "--scans", str(2 * b), "--device",
                       str(device)])
    sys.stderr.write(err.getvalue())
    line = out.getvalue().strip().splitlines()[-1]
    payload = json.loads(line)
    extra = payload["extra"]
    if rc != 0 or extra["batch"] != b or extra["fallbacks"] or not payload["value"] > 0:
        raise AssertionError(f"bench --batch {b}: exit {rc}, {line}")
    log(f"bench --batch {b}: {line}")
    return total, {"ms_per_tick": tick_ms, "stream_ms_per_scan": float(np.mean(stream_ms)),
                   "bench": payload}

def spatial_scans(config, records, device):
    """``records`` prepared for the sorted step (host-tracked centers), on
    ``device``, with the state to start from."""
    from groundgrid_torch.pipeline import CenterTracker, init_state, prepare_scan

    T0 = np.asarray(records[0].t_map_velo, np.float64)
    tracker = CenterTracker(config, T0[:2, 3])
    scans = []
    for rec in records:
        T = np.asarray(rec.t_map_velo, np.float64)
        scan, _ = prepare_scan(config, rec.points, rec.labels, T, tracker.update(T[:2, 3]),
                               device)
        scans.append(scan)
    return scans, init_state(config, T0.astype(np.float32), device)


def spatial_start(state, scans, mesh):
    """The row blocks, center pair and scan chunks of ``state`` and ``scans``
    on ``mesh``."""
    from groundgrid_torch.parallel import spatial

    return (spatial.split_rows(state.ground, mesh), spatial.split_rows(state.groundpatch, mesh),
            (state.center, state.center_lo), [spatial.shard_scan(scan, mesh) for scan in scans])


def run_spatial(step, state, scans, mesh, sync_check=True):
    """The spatial step over ``scans`` from ``state``: per scan a copy of the
    local shards' (ground, groundpatch, labels, outlier) gathered by shard,
    and the center pair; per scan the launch counts (``path_counts``); and
    the CUDA-event ms per scan (scans prepared beforehand). Steps after the
    first (on a captured step: the replays) run under the sync check."""
    from groundgrid_torch.ops import reset_launch_counts

    g, c, center, chunks = spatial_start(state, scans, mesh)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    results, counts = [], []
    for k, chunk in enumerate(chunks):
        run = SyncChecked(step) if sync_check and k else step
        reset_launch_counts()
        g, c, center, labels, outlier = run(g, c, center, chunk)
        counts.append(path_counts())
        results.append(tuple(torch.cat([b.to(g[0].device) for b in x])
                             for x in (g, c, labels, outlier)) + tuple(t.clone() for t in center))
    end.record()
    end.synchronize()
    return results, counts, start.elapsed_time(end) / len(scans)


def time_spatial(step, state, scans, mesh, warm=2):
    """CUDA-event ms per scan of ``step`` over ``scans[warm:]``, after
    ``warm`` untimed scans (a captured step's eager call and first replay,
    with the capture between them): replays only. Across cards the end
    event waits for every card's stream."""
    g, c, center, chunks = spatial_start(state, scans, mesh)
    for chunk in chunks[:warm]:
        g, c, center, _, _ = step(g, c, center, chunk)
    devices = list(dict.fromkeys(b.device for b in g))
    for dev in devices:
        torch.cuda.synchronize(dev)
    main = torch.cuda.current_stream(devices[0])
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record(main)
    for chunk in chunks[warm:]:
        g, c, center, _, _ = step(g, c, center, chunk)
    for dev in devices[1:]:
        main.wait_stream(torch.cuda.current_stream(dev))
    end.record(main)
    end.synchronize()
    return start.elapsed_time(end) / (len(scans) - warm)


def time_single(config, state, scans, warm=2):
    """:func:`time_spatial` for the captured single-grid step (``make_step``)."""
    from groundgrid_torch.pipeline import make_step

    step = make_step(config)
    state = dataclasses.replace(state, ground=state.ground.clone(),
                                groundpatch=state.groundpatch.clone())
    for scan in scans[:warm]:
        state, _ = step(state, scan)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for scan in scans[warm:]:
        state, _ = step(state, scan)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (len(scans) - warm)


def same_spatial(got, want, name):
    """Per scan every gathered layer, label, outlier flag and the center pair
    bitwise."""
    if len(got) != len(want):
        raise AssertionError(f"{name}: {len(got)} scans against {len(want)}")
    for k, (a, b) in enumerate(zip(got, want)):
        for field, x, y in zip(("ground", "groundpatch", "labels", "outlier", "center",
                                "center_lo"), a, b):
            if not bitwise(x, y):
                raise AssertionError(f"{name} scan {k + 1}: {field} not bitwise")


def spatial_turns(config, state, scans, mesh, make, kinds):
    """ms per scan of each kind in ``kinds`` (a name -> ``make(name)`` step),
    in turns: each kind, then each again in reverse."""
    order = list(kinds) + list(reversed(kinds))
    out = {kind: [] for kind in kinds}
    for kind in order:
        out[kind].append(time_spatial(make(kind), state, scans, mesh))
    return out


def phase_spatial(config, records, device, n_shards):
    """Phase 10: the spatial step on ``["cuda:0"] * n_shards`` over ``records``
    in both spiral modes, eager (``SpatialStep``) against the single-grid
    step and itself, captured (``make_spatial_step``: one CUDA graph a
    scan) bitwise eager; then ms per scan in turns."""
    from groundgrid_torch.parallel import spatial
    from groundgrid_torch.pipeline import make_step_fn

    n, name = len(records), f"spatial {config.cell_count}^2 over {n_shards} shards"
    scans, state0 = spatial_scans(config, records, device)
    # the eager single-grid step, the reference of the eager spatial step
    single = make_step_fn(config)
    state = dataclasses.replace(state0, ground=state0.ground.clone(),
                                groundpatch=state0.groundpatch.clone())
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    ref = []
    for scan in scans:
        state, out = single(state, scan)
        ref.append((state.ground.clone(), state.groundpatch.clone(), out.labels, out.outlier))
    end.record()
    end.synchronize()
    single_ms = start.elapsed_time(end) / n
    mesh = [device] * n_shards
    per_scan = {"raster": n_shards, "lookup": 3 * n_shards, "spiral": n_shards, "detect": 0,
                "spiral_band": n_shards, "spiral_global": 0}
    runs, ms, total, capture = {}, {}, {}, {}
    for mode in ("replicated", "banded"):
        eager = spatial.SpatialStep(config, mesh, spiral_mode=mode, with_scan_center=True)
        runs[mode], counts, ms[mode] = run_spatial(eager, state0, scans, mesh)
        if counts != [per_scan] * n:
            raise AssertionError(f"{name} ({mode}): launches per scan {counts} (want {per_scan})")
        if eager.fallbacks:
            raise AssertionError(f"{name} ({mode}): {eager.fallbacks} sortedness fallbacks")
        again, _, ms[mode + "_again"] = run_spatial(eager, state0, scans, mesh)
        same_spatial(again, runs[mode], f"{name} ({mode}), second eager run")
        step = spatial.make_spatial_step(config, mesh, spiral_mode=mode, with_scan_center=True)
        if not isinstance(step, spatial.CapturedSpatialStep) or step.collectives != "inside":
            raise AssertionError(f"{name}: make_spatial_step gave {step!r}")
        got, counts_c, ms[mode + "_captured"] = run_spatial(step, state0, scans, mesh)
        if not step.captured:
            raise AssertionError(f"{name} ({mode}): the spatial step was not captured")
        if counts_c != counts:
            raise AssertionError(f"{name} ({mode}): captured launches per scan {counts_c}, "
                                 f"eager {counts}")
        same_spatial(got, runs[mode], f"{name} ({mode}), captured vs eager")
        for c in counts_c:
            total = {key: total.get(key, 0) + v for key, v in c.items()}
        again, _, _ = run_spatial(step, state0, scans, mesh)
        same_spatial(again, got, f"{name} ({mode}), second captured run")
        if step.fallbacks:
            raise AssertionError(f"{name} ({mode}): {step.fallbacks} sortedness fallbacks")
        capture[mode] = {"capture_s": step.capture_seconds, "pool_bytes": step.pool_bytes}
        log(f"{name} ({mode}): captured step bitwise eager (ground, groundpatch, labels, "
            f"outliers, center pair; {n} scans, a second captured run too), launches per "
            f"scan as eager, replays under the sync check; capture {step.capture_seconds:.3f} "
            f"s, graph pool {step.pool_bytes} bytes ({step.pool_bytes / 2 ** 20:.1f} MiB)")
    points = 0
    worst = [0.0, 0.0]
    for k, (r, b, s) in enumerate(zip(runs["replicated"], runs["banded"], ref)):
        if not all(torch.equal(x, y) for x, y in zip(r, b)):
            raise AssertionError(f"{name} scan {k + 1}: banded differs from replicated")
        for j, (atol, rtol) in enumerate(((2e-4, 1e-4), (1e-5, 1e-5))):
            if not bool(torch.isfinite(r[j]).all()) or not torch.allclose(r[j], s[j], atol=atol,
                                                                           rtol=rtol):
                raise AssertionError(f"{name} scan {k + 1}: layer {j} beyond atol {atol} / rtol "
                                     f"{rtol} of the single-grid step: max "
                                     f"{float((r[j] - s[j]).abs().max())}")
            worst[j] = max(worst[j], float((r[j] - s[j]).abs().max()))
        points += int((s[2] > 0).sum())
        if not np.isin(r[2].cpu().numpy(), (0, 49, 99)).all():
            raise AssertionError(f"{name}: labels outside 0 / 49 / 99")
    mism = sum(int((r[2] != s[2]).sum()) for r, s in zip(runs["replicated"], ref))
    rate = 1 - mism / (n * config.max_points)
    if rate < 0.9995:
        raise AssertionError(f"{name}: {mism} labels differ from the single-grid step")
    log(f"{name}, {n} scans: launches per scan K1 x{n_shards}, K2 x{3 * n_shards}, K3 "
        f"x{n_shards} in both spiral modes; steps 2-{n} under the sync check; banded == "
        f"replicated bitwise (labels, outliers, ground, groundpatch); second runs bitwise; vs "
        f"the single-grid step {mism} of {n * config.max_points} labels differ ({points} "
        f"labelled points), ground max {worst[0]:.3g}, groundpatch max {worst[1]:.3g}; ms per "
        f"scan (CUDA events, scans prepared beforehand, the first scans included): replicated "
        f"{ms['replicated']:.3f} / {ms['replicated_again']:.3f}, banded {ms['banded']:.3f} / "
        f"{ms['banded_again']:.3f}, single-grid eager {single_ms:.3f}")

    # ms per scan in turns, replays only (the first two scans untimed)
    turns = {}
    for mode in ("replicated", "banded"):
        def make(kind, mode=mode):
            if kind == "eager":
                return spatial.SpatialStep(config, mesh, mode, with_scan_center=True)
            return spatial.make_spatial_step(config, mesh, mode, with_scan_center=True)
        turns[mode] = spatial_turns(config, state0, scans, mesh, make, ("eager", "captured"))
    turns["single_captured"] = [time_single(config, state0, scans)]
    log(f"{name}: ms per scan in turns over scans 3-{n} (CUDA events; eager, captured, "
        f"captured, eager): " + "; ".join(
            f"{mode} eager {t['eager'][0]:.3f} / {t['eager'][1]:.3f}, captured "
            f"{t['captured'][0]:.3f} / {t['captured'][1]:.3f}"
            for mode, t in turns.items() if mode != "single_captured")
        + f"; the captured single-grid step {turns['single_captured'][0]:.3f}")
    return total, dict(ms, single=single_ms, label_mismatch=mism, ground_max=worst[0],
                       groundpatch_max=worst[1], capture=capture, turns=turns)


def save_records(path, records):
    """``records``' points, labels and poses in one ``.npz``, for the ranks."""
    arrays = {}
    for k, rec in enumerate(records):
        arrays.update({f"points{k}": rec.points, f"labels{k}": rec.labels,
                       f"pose{k}": rec.t_map_velo})
    np.savez(path, n=len(records), **arrays)


def load_records(path):
    from groundgrid_torch.runtime.driver import ScanRecord

    with np.load(path) as f:
        return [ScanRecord(index=k, timestamp=0.1 * k, points=f[f"points{k}"],
                           labels=f[f"labels{k}"], t_map_velo=f[f"pose{k}"])
                for k in range(int(f["n"]))]


SPATIAL_CONFIGS = {"1200": 8, "364": 4}  # phase 10's configurations and shards on one card


def spatial_config(label):
    from groundgrid_torch.config import HIGHRES_CONFIG, GroundGridConfig

    base = HIGHRES_CONFIG if label == "1200" else GroundGridConfig()
    return dataclasses.replace(base, sorted_scans=True)


def spatial_rank(rank, world, store, records_path, out_dir, kinds, device):
    """One NCCL rank of the multi-card phase, on ``device``: each spiral
    mode's step of each kind in ``kinds`` (``eager``, or ``captured``, its
    collectives between the graphs) at both configurations,
    its outputs (:func:`run_spatial`) and ms per scan in turns, saved to
    ``out_dir/rank{rank}.npz``."""
    import torch.distributed as dist

    from groundgrid_torch.parallel import spatial
    from groundgrid_torch.parallel.multihost import init_multihost

    device = torch.device(device)
    init_multihost(store, world, rank, device=device)
    try:
        records = load_records(records_path)
        mesh = spatial.GroupMesh(device)
        out = {}
        for label in SPATIAL_CONFIGS:
            config = spatial_config(label)
            scans, state0 = spatial_scans(config, records, device)
            for mode in ("replicated", "banded"):
                def make(kind, mode=mode, config=config):
                    if kind == "eager":
                        return spatial.SpatialStep(config, mesh, mode, with_scan_center=True)
                    return spatial.make_spatial_step(config, mesh, mode, with_scan_center=True)
                for kind in kinds:
                    results, counts, _ = run_spatial(make(kind), state0, scans, mesh)
                    for k, res in enumerate(results):
                        for field, t in zip(("ground", "groundpatch", "labels", "outlier",
                                             "center", "center_lo"), res):
                            out[f"{label}_{mode}_{kind}_{k}_{field}"] = t.cpu().numpy()
                    out[f"{label}_{mode}_{kind}_counts"] = np.array(
                        [[c[key] for key in ("raster", "lookup", "spiral")] for c in counts])
                for kind, times in spatial_turns(config, state0, scans, mesh, make,
                                                 kinds).items():
                    out[f"{label}_{mode}_{kind}_ms"] = np.array(times)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def spawn_ranks(devices, records_path, kinds, timeout_s):
    """NCCL ranks of :func:`spatial_rank`, rank r on ``devices[r]``; their
    saved outputs, or the failure as a string (every process stopped either
    way)."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    world = len(devices)
    with tempfile.TemporaryDirectory() as tmp:
        store = f"file://{tmp}/store"
        procs = [ctx.Process(target=spatial_rank,
                             args=(rank, world, store, records_path, tmp, kinds, str(dev)))
                 for rank, dev in enumerate(devices)]
        for p in procs:
            p.start()
        deadline = time.perf_counter() + timeout_s
        try:
            for p in procs:
                p.join(max(1.0, deadline - time.perf_counter()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        codes = [p.exitcode for p in procs]
        if codes != [0] * world:
            return f"exit codes {codes} (a rank over {timeout_s} s is killed)"
        return [dict(np.load(os.path.join(tmp, f"rank{r}.npz"))) for r in range(world)]


def check_ranks(ranks, want, want_counts, kind, label, mode, world, name):
    """Each rank's outputs bitwise the shard rank of the one-card mesh
    ``want`` (:func:`run_spatial` results), and its launches per scan those
    of one card over the ranks."""
    per_rank = [[c[key] // world for key in ("raster", "lookup", "spiral")] for c in want_counts]
    for r, got in enumerate(ranks):
        if got[f"{label}_{mode}_{kind}_counts"].tolist() != per_rank:
            raise AssertionError(f"{name}: rank {r} launches per scan "
                                 f"{got[f'{label}_{mode}_{kind}_counts'].tolist()}, want "
                                 f"{per_rank}")
        for k, res in enumerate(want):
            for field, t in zip(("ground", "groundpatch", "labels", "outlier", "center",
                                 "center_lo"), res):
                a = t.cpu().numpy()
                if field not in ("center", "center_lo"):
                    part = a.shape[0] // world
                    a = a[r * part:(r + 1) * part]
                b = got[f"{label}_{mode}_{kind}_{k}_{field}"]
                if a.dtype == np.float32:
                    a, b = a.view(np.int32), b.view(np.int32)
                if not np.array_equal(a, b):
                    raise AssertionError(f"{name}: rank {r} scan {k + 1} {field} not bitwise "
                                         f"one card")


def phase_spatial_cards(records, devices=None):
    """Phase 10 across cards (with two cards or more): at both phase-10
    configurations and spiral modes, one shard a card on 2 and 4 cards:
    the in-process mesh across the cards (eager, and captured with its
    collectives between the graphs) and NCCL ranks (``GroupMesh``, one a
    card: eager and captured, the NCCL calls between the graphs), bitwise
    the same shards on one card
    (``["cuda:0"] * S``, captured), launches per scan as on one card; ms
    per scan in turns. ``devices``: the cards (by default every card)."""
    from groundgrid_torch.parallel import spatial

    if devices is None:
        devices = [torch.device("cuda", k) for k in range(torch.cuda.device_count())]
    if len(devices) < 2:
        log(f"phase 10 across cards: did not run ({len(devices)} card; it needs 2)")
        return None
    out = {}
    worlds = sorted({2, min(4, len(devices))})
    for label in SPATIAL_CONFIGS:
        config = spatial_config(label)
        for world in worlds:
            scans, state0 = spatial_scans(config, records, devices[0])
            one = [devices[0]] * world
            across = devices[:world]
            name = f"spatial {config.cell_count}^2 over {world} cards"
            for mode in ("replicated", "banded"):
                def make(kind, mode=mode):
                    if kind == "eager":
                        return spatial.SpatialStep(config, across, mode, with_scan_center=True)
                    return spatial.make_spatial_step(config, one if kind == "one card" else across,
                                                     mode, with_scan_center=True)

                want, want_counts, _ = run_spatial(make("one card"), state0, scans, one)
                for kind in ("eager", "captured"):
                    got, counts, _ = run_spatial(make(kind), state0, scans, across)
                    same_spatial(got, want, f"{name} ({mode}, {kind})")
                    if counts != want_counts:
                        raise AssertionError(f"{name} ({mode}, {kind}): launches {counts}")
                turns = {kind: [] for kind in ("eager", "captured", "one card")}
                for kind in ("eager", "captured", "one card", "one card", "captured", "eager"):
                    mesh = one if kind == "one card" else across
                    turns[kind].append(time_spatial(make(kind), state0, scans, mesh))
                out[f"{label}_{world}_{mode}_local"] = turns
                log(f"{name} ({mode}), in-process mesh: eager and captured (collectives "
                    f"between the graphs) bitwise one card, launches as one card; ms per scan "
                    f"in turns: " + ", ".join(f"{k} {v[0]:.3f} / {v[1]:.3f}"
                                              for k, v in turns.items()))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "records.npz")
        save_records(path, records)
        kinds = ("eager", "captured")
        for world in worlds:
            ranks = spawn_ranks(devices[:world], path, kinds, 300)
            name = f"spatial over {world} NCCL ranks"
            if isinstance(ranks, str):
                raise AssertionError(f"{name}: {ranks}")
            for label in SPATIAL_CONFIGS:
                config = spatial_config(label)
                scans, state0 = spatial_scans(config, records, devices[0])
                one = [devices[0]] * world
                for mode in ("replicated", "banded"):
                    want, want_counts, _ = run_spatial(spatial.make_spatial_step(
                        config, one, spiral_mode=mode, with_scan_center=True), state0, scans, one)
                    for kind in kinds:
                        check_ranks(ranks, want, want_counts, kind, label, mode, world,
                                    f"{name} {label} {mode} {kind}")
                    times = {kind: [float(v) for v in ranks[0][f"{label}_{mode}_{kind}_ms"]]
                             for kind in kinds}
                    out[f"{label}_{world}_{mode}_nccl"] = times
                    log(f"{name} {config.cell_count}^2 ({mode}): every rank bitwise its shard "
                        f"on one card, launches per scan K1 x1, K2 x3, K3 x1 a rank; rank 0's "
                        f"ms per scan in turns: " + ", ".join(
                            f"{k} {v[0]:.3f} / {v[1]:.3f}" for k, v in times.items()))
    log("phase 10 across cards summary: " + json.dumps(out))
    return out


@contextlib.contextmanager
def eager_steps():
    """The drivers and the fleet on ``make_step_fn``'s eager step: the other
    side of phase 11's turns."""
    from groundgrid_torch.parallel import sharding
    from groundgrid_torch.pipeline import make_step_fn
    from groundgrid_torch.runtime import driver

    saved = driver.make_step, sharding.make_step
    driver.make_step = sharding.make_step = make_step_fn
    try:
        yield
    finally:
        driver.make_step, sharding.make_step = saved


def bitwise(a, b) -> bool:
    """Two tensors equal bit for bit (NaN and -0.0 included)."""
    if a.dtype.is_floating_point:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a.cpu(), b.cpu())


def same_results(got, want, name, aux=False):
    """Labels, outliers (and with ``aux`` the 11 layers and x, y, z) bitwise."""
    if len(got) != len(want):
        raise AssertionError(f"{name}: {len(got)} results against {len(want)}")
    for k, (a, b) in enumerate(zip(got, want)):
        same = np.array_equal(a.labels, b.labels) and np.array_equal(a.outlier, b.outlier)
        if aux:
            same = same and all(np.array_equal(a.aux[key].view(np.int32),
                                               b.aux[key].view(np.int32)) for key in b.aux)
            same = same and all(np.array_equal(getattr(a, c), getattr(b, c)) for c in "xyz")
        if not same:
            raise AssertionError(f"{name}: scan {k + 1} not bitwise")


def phase_captured(config, records, device, earlier):
    """Phase 11: the captured step (``make_step``, one CUDA graph replayed
    per scan) against the eager ``make_step_fn`` step, bitwise, on the
    paths of phases 3, 4, 6 and 7 (phase 9 holds the captured fleet to
    eager streaming drivers); two captured runs bitwise; every replay under
    the sync check. Then ms per scan in turns (eager, captured, captured,
    eager) by CUDA events: phase 3's path, the streaming bench, ``bench
    --batch 64``, the busy share of ``bench --profile``; and sorted against
    unsorted on the captured step."""
    from groundgrid_torch.config import GroundGridConfig
    from groundgrid_torch.runtime import bench
    from groundgrid_torch.runtime.checkpoint import load_state, save_state
    from groundgrid_torch.runtime.driver import StreamingDriver

    out = {}
    # (a) phase 3's main path, four runs in turns, every scan's state kept
    runs = []
    for eager in (True, False, False, True):
        states = []
        res, driver, ms, _ = run_sequence(config, records, device, eager=eager,
                                          per_scan=lambda d: states.append(state_record(d)),
                                          sync_check=True)
        runs.append((res, states, ms, driver))
    for (a, sa, _, _), (b, sb, _, _), what in ((runs[1], runs[0], "captured vs eager"),
                                               (runs[2], runs[1], "two captured runs"),
                                               (runs[2], runs[3], "captured vs eager again")):
        same_results(a, b, f"main path, {what}")
        for k, (x, y) in enumerate(zip(sa, sb)):
            if not all(bitwise(u, v) for u, v in zip(x, y)):
                raise AssertionError(f"main path, {what}: scan {k + 1}'s state layers differ")
    out["main"] = dict(log_capture("main path (phase 3)", runs[1][3]),
                       eager_ms=[runs[0][2], runs[3][2]], captured_ms=[runs[1][2], runs[2][2]])
    log(f"phase 11 main path, {len(records)} scans: captured bitwise eager (labels, outliers, "
        f"ground, groundpatch, center, center_lo every scan), two captured runs bitwise, "
        f"replays under the sync check; ms per scan (CUDA events, host prep included) in turns: "
        f"eager {runs[0][2]:.3f}, captured {runs[1][2]:.3f}, captured {runs[2][2]:.3f}, eager "
        f"{runs[3][2]:.3f}")
    del runs

    # (b) phase 4's layer path: 11 layers, and a checkpoint resumed on the
    # captured step
    layer_cfg, layer_recs, layer_results = earlier["layers"]
    eager, _, _, _ = run_sequence(layer_cfg, layer_recs, device, with_aux=True, eager=True)
    same_results(layer_results, eager, "layers path, captured vs eager", aux=True)
    half = len(layer_recs) // 2
    _, first, _, _ = run_sequence(layer_cfg, layer_recs[:half], device, with_aux=True)
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/state.npz"
        save_state(path, first.state, half, layer_cfg, center64=first.center64)
        state, nxt, extra = load_state(path, layer_cfg, device)
    resumed = StreamingDriver(layer_cfg, device, with_aux=True)
    resumed.restore(state, extra["center64"])
    rest, _, _, _ = run_sequence(layer_cfg, layer_recs[nxt:], device, driver=resumed,
                                 sync_check=True)
    same_results(rest, eager[nxt:], "layers path, resumed captured vs eager", aux=True)
    log(f"phase 11 layers path, {len(layer_recs)} scans: captured bitwise eager (labels, "
        f"outliers, 11 layers, x/y/z); a checkpoint after scan {nxt} resumed on a new captured "
        f"step bitwise eager")

    # (c) phase 6, unsorted with the tracker's centers; (d) phase 7, 128 beams
    unsorted_results, unsorted_state = earlier["unsorted"]
    eager, driver, _, _ = run_sequence(GroundGridConfig(), records, device, eager=True)
    same_results(unsorted_results, eager, "unsorted path, captured vs eager")
    if not all(bitwise(u, v) for u, v in zip(unsorted_state, state_record(driver))):
        raise AssertionError("unsorted path: the final state differs from the eager step's")
    topk_cfg, topk_recs, topk_results, topk_candidates = earlier["topk"]
    marchable = []
    eager, _, _, _ = run_sequence(topk_cfg, topk_recs, device, eager=True,
                                  per_scan=lambda d: marchable.append(d.step.marchable))
    same_results(topk_results, eager, "128-beam path, captured vs eager")
    if marchable != topk_candidates:
        raise AssertionError(f"128-beam path: marchable {topk_candidates} (captured) against "
                             f"{marchable} (eager)")
    log(f"phase 11 unsorted path ({len(records)} scans, final state too) and 128-beam path "
        f"({len(topk_recs)} scans, marchable counts too): captured bitwise eager")

    # (e) the streaming bench's device ms per scan, in turns
    stream_ms = []
    for eager in (True, False, False, True):
        with eager_steps() if eager else contextlib.nullcontext():
            driver = StreamingDriver(config, device)
        for rec in records[:3]:
            driver.process(rec)
        steps, _ = bench.device_ms_per_step(driver, records)
        stream_ms.append(float(np.mean(steps)))
    out["stream_device_ms"] = {"eager": [stream_ms[0], stream_ms[3]],
                               "captured": [stream_ms[1], stream_ms[2]]}
    log(f"phase 11 streaming bench (device ms per scan, CUDA events over {len(records) - 2} "
        f"warm steps on prepared scans) in turns: eager {stream_ms[0]:.4f}, captured "
        f"{stream_ms[1]:.4f}, captured {stream_ms[2]:.4f}, eager {stream_ms[3]:.4f}")

    # (e') the device busy share of 8 warm steps (``bench --profile``), in turns
    busy = []
    for eager in (True, False, False, True):
        with eager_steps() if eager else contextlib.nullcontext():
            busy.append(bench.profile_steps(device=device).splitlines()[-1])
    out["profile"] = busy
    for name, line in zip(("eager", "captured", "captured", "eager"), busy):
        log(f"phase 11 bench --profile ({name}): {line}")

    # (f) bench --batch 64, in turns
    fleet = []
    for eager in (True, False, False, True):
        with eager_steps() if eager else contextlib.nullcontext():
            fleet.append(bench.run_fleet_benchmark(config, records[:8], FLEET_BATCH,
                                                   2 * FLEET_BATCH, 3, device))
        if fleet[-1]["fallbacks"]:
            raise AssertionError("fleet bench: sortedness fallbacks")
    keys = ("device_ms_per_scan", "device_ms_per_tick", "wall_ms_per_tick")
    out["fleet_bench"] = [{k: f[k] for k in keys} for f in fleet]
    log(f"phase 11 bench --batch {FLEET_BATCH} in turns (eager, captured, captured, eager): "
        f"device ms per scan {', '.join(str(f['device_ms_per_scan']) for f in fleet)}; ms per "
        f"tick {', '.join(str(f['device_ms_per_tick']) for f in fleet)}; wall ms per tick "
        f"{', '.join(str(f['wall_ms_per_tick']) for f in fleet)}")

    # (g) sorted against unsorted on the captured step, in turns
    modes = []
    for cfg in (config, GroundGridConfig(), GroundGridConfig(), config):
        _, driver, ms, _ = run_sequence(cfg, records, device)
        modes.append(ms)
    out["sorted_vs_unsorted_ms"] = {"sorted": [modes[0], modes[3]],
                                    "unsorted": [modes[1], modes[2]]}
    log(f"phase 11 captured step, ms per scan (CUDA events, host prep included) in turns: "
        f"sorted {modes[0]:.3f}, unsorted {modes[1]:.3f}, unsorted {modes[2]:.3f}, sorted "
        f"{modes[3]:.3f}")
    log("phase 11 summary: " + json.dumps(out))
    return out


def run_spatial_phase(records, device) -> dict:
    """Phase 10 on one card at both configurations, then across cards; the
    captured runs' launch counts."""
    counts = {}
    for label, shards in SPATIAL_CONFIGS.items():
        counts_s, _ = phase_spatial(spatial_config(label), records[:N_SPATIAL_SCANS], device,
                                    shards)
        counts = {k: counts.get(k, 0) + v for k, v in counts_s.items()}
    phase_spatial_cards(records[:N_SPATIAL_SCANS])
    return counts


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

    if sys.argv[1:] == ["--spatial"]:  # phases 1 and 10 alone
        run_spatial_phase(records, device)
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                 "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
        return 0
    driver = warm_driver(config, records, device)
    k1, cell = check_raster(config, driver, records[4])
    k2 = check_lookup(config, driver, cell, records[4])
    k3 = check_spiral(config, driver, records[4])
    k3g = check_spiral_global(device)
    high_driver = warm_driver(dataclasses.replace(HIGHRES_CONFIG, sorted_scans=True), records,
                              device)
    k3r = check_spiral_ranges(config, driver, records[4], high_driver, device)
    del high_driver
    k4 = check_detect(config, driver, records[4], records)
    torch.cuda.synchronize()

    counts, sorted_results = phase_sequence(config, records, device)
    layer_config = dataclasses.replace(config, wire_format=True, fused_detect=True)
    layer_counts, layer_results = phase_layers(layer_config, records[:N_LAYER_SCANS], device)
    high_config = dataclasses.replace(HIGHRES_CONFIG, sorted_scans=True, wire_format=True,
                                      fused_detect=True)
    phase_layers_highres(high_config, records[:N_HIGHRES_SCANS], device)
    phase_entry_point(config, records, device)
    unsorted_counts, unsorted = phase_unsorted(records, sorted_results, device)
    topk_counts, topk = phase_topk(device)
    phase_golden(device)
    fleet_counts, _ = phase_fleet(config, records, device)
    spatial_counts = run_spatial_phase(records, device)
    phase_captured(config, records, device, {
        "layers": (layer_config, records[:N_LAYER_SCANS], layer_results),
        "unsorted": (unsorted["results"], unsorted["state"]),
        "topk": (topk["config"], topk["records"], topk["results"], topk["candidates"])})
    # K3 at 1200^2: the full launch alone and the bands of S = 8
    k3.update({k + "_highres": v for k, v in k3r["1200"].items()
               if k in ("device_ms", "wrapper_device_ms", "call_ms", "bound_ms")})
    for key, res in (("364", k3), ("1200", k3), ("2416", k3g)):
        res.update({f"{k}_{key}": v for k, v in k3r[key].items() if k.startswith("band")})
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
            "launches_fleet": fleet_counts[key], "launches_spatial": spatial_counts[key],
            "max_abs_err": res["max_abs_err"],
            "ms": res["device_ms"], "device_ms": res["device_ms"],
            "wrapper_device_ms": res["wrapper_device_ms"], "call_ms": res["call_ms"],
            "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"], "library_ms": res["library_ms"],
            **{k: v for k, v in res.items()
               if k.endswith(("_highres", "_364", "_1200", "_2416"))},
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
