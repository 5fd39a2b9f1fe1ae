"""GPU smoke test of the PyTorch port: builds and checks its CUDA kernels,
then drives the sorted-scan streaming path, the layer-publishing wire path,
the entry point, the unsorted default path, a 128-beam buffer, the golden
parity tooling, a 64-vehicle fleet (sorted, vehicle by vehicle; unsorted,
as one batched body) and one grid split over shards, on one card, and
holds the captured step (one CUDA graph a scan, ``make_step``) to the
eager one.

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
   the same runs), K2 lookup (sorted point cells with 2 tables, the
   classify gather, and with 1, the old ground K6 now reads itself, a
   uniform random lattice-sized vector and the march lattice of a warm scan:
   bitwise; all but the first on no path, K2 measurements), K3 spiral (a warm state:
   confidence bitwise, heights atol 2e-5 / rtol 1e-5; and its global-band
   variant at n = 2416 on random layers, the same bounds), K4 fused detect
   (the warm raster layers of a real scan at 364^2 and at 1200^2, from a
   ``HIGHRES_CONFIG`` fused-detect driver warmed on 4 scans, and random
   layers at n = 12 and 45, one seed with low variance so that the main
   update fires: ground and confidence bitwise, two runs bitwise; timed at
   both grid sizes), K5 bin_points (a prepared scan: the six outputs
   bitwise, and the cell ids bitwise the host prep's), K6 march_budget and
   K7 march (a warm scan's budgets, keys, directions and selected candidates,
   as the step builds them by the plain versions, K6 reading each point's
   old ground from the moved grid, bitwise K2's plain gather and the plain
   budget, K7 walking K6's own outputs over the moved layers; bitwise,
   and on the scan twice over, 262,144 points, the exact-budget key; the
   occlusion key table K7 folds in timed alone, device ms and launches;
   both kernels' registers and
   spills by ``nvcc -Xptxas -v``), K8 detect_stage (``check_detect_stage``:
   the main path's detect stage against ``core/detect.py`` on the same
   CUDA tensors, K4's cases and the seam layers of ``detect_seam_layers``
   at n = 45 and 80, bitwise with NaN and -0.0; the halo'd row blocks of
   S = 4 at 364^2 and S = 8 at 1200^2 bitwise ``detect_block`` and,
   together, the full sweep; the plain stage's device ms and device
   activities by ``torch.profiler`` beside its call ms; timed at 364^2,
   1200^2 and on a batch of 64 grids, with its registers and spills by
   ``nvcc -Xptxas -v``); K9 raster_columns_ordered and K10 finish_layers
   (``check_raster_stage``: the raster stage around K1 on a warm scan, K9
   through the stable sort's order of the sorted scan and of the scan
   shuffled, K10 over K1's columns with the main path's three layers, with
   all layers and the max, and over 4 shards' columns; bitwise their plain
   versions); K11 select_candidates (``check_select``: a warm scan's
   budgets and keys, the scan twice over, 262,144 points on the exact key,
   and storms of 20,000 marchable points at 2^17 and 2^18, past the cap:
   the indices and the marchable count bitwise its plain version; timed in
   turns against ``torch.topk`` of the same keys, its library column); K12
   move (``check_move``: the warm state moved by a scan's shift, a large
   shift and a wipe, bitwise the plain move, the inputs untouched); each of
   K4-K12 two runs bitwise. K3's ring ranges (``spiral_interpolation_rings``) at
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
   distinct cells its ids name, K6 computes rays for candidates alone, K7
   counts the live steps up to each candidate's first hit and the cells
   they read in both layers, K11 reads the keys only past the cap, K12
   reads no exposed cell) and, for K2, one ``torch.index_select`` over
   the stacked tables, for K11 one ``torch.topk``, timed in turns with
   the kernel (no one PyTorch call computes K1, K3-K10 or K12). Then the
   batched launches of the unsorted fleet (``check_batched``): K1, K2 (the
   points' 2 tables and the march lattice's 1), K3-K12 on a batch of 64
   vehicles at 364^2 (8 warm scans cycled, each vehicle's layers made
   distinct), each bitwise its
   64 single launches and against its plain batched version (K3 at its
   bounds above); the batched launch's device ms against the 64 single
   launches' summed device ms, both calls' CUDA-event ms, the plain
   batched call's ms and the bound of the batch's work.
3. ``StreamingDriver`` with the default sorted config over 32 consecutive
   synthetic scans: per-scan launch counts (K1, K2, K3, K5-K12 x1; a replay
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
   over the first 16 scans: per-scan launch counts (K1 x2, K2-K7 x1), no
   fallback, labels against the plain-version run (>= 99.9 %)
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
   on F1 and IoUg; per scan K1 x1 (x2 for (g)), K2, K3, K5-K12 x1 and no
   sortedness fallback; (g) writes 11 layer PNGs per exported scan and the
   player. Prints ms/scan per variant (the payload's and CUDA events around
   the call) and the host prep p50 of NumPy against the native loader.
6. Unsorted mode at the config default, ``StreamingDriver(GroundGridConfig())``
   (364^2, 131072 points, raw scans transformed and stable-sorted on the
   device) over the 32 scans of phase 3: per-scan launch counts (as phase
   3), the sync check and the host-read step as in phase 3, labels
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
   3's records from record v mod 32 (backward for v >= 32): per tick K1,
   K2, K3, K5-K12 x64, the step of ticks 2-4 under the sync check (host prep
   and the tick's one fetch outside), the summary equal to the fetched
   labels' counts; every vehicle's labels and outliers (the fleet's one
   captured vehicle step) bitwise those of an eager ``StreamingDriver``
   over its stream; a 2-vehicle, 2-tick plain-version
   fleet (>= 99.9 %); tick 1 again with the summary all_reduced through a
   1-rank NCCL group (``parallel/multihost.py``): the local sum, bitwise
   labels; ``bench --batch 64``. Prints ms per tick and scans/s (CUDA
   events around the tick, host prep and fetch included) and the bench's
   metric line. Then the unsorted fleet (``phase_fleet_unsorted``), the
   default ``GroundGridConfig()`` with 64 vehicles on the same streams,
   stepped as one batched body captured as one graph a tick: per tick K1,
   K2, K3, K5-K12 x1, ticks 2-4 under the sync check, the summary, ms per
   tick with host prep and fetch, the capture's seconds and pool bytes;
   labels, outliers and the final state bitwise 64 single captured
   unsorted steps (the same fleet vehicle by vehicle, one replay per
   vehicle); then the device ms a tick of ``bench --batch``'s measure
   (scans prepared once) in turns: batched, per vehicle, per vehicle,
   batched; the sorted config on both branches in turns (per vehicle,
   batched, batched, per vehicle: timing only, for the open question of
   the sorted fleet on the batched body); and the device busy ms of a
   batched tick under ``torch.profiler`` with its heaviest kernels.
10. The spatial step (``parallel/spatial.py``), one grid split row-wise
   over an in-process mesh on the one card, sorted scans with their
   centers, both spiral modes: (a) ``HIGHRES_CONFIG`` (1200^2) over
   ``["cuda:0"] * 8``, (b) the default 364^2 over ``["cuda:0"] * 4``, each
   over the first 8 scans. The eager ``SpatialStep``: launches per scan K1,
   K2, K3, K5-K12 x S, steps 2-8 under the sync check, banded ==
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
   ``python3 chip_smoke.py --k8-tiles`` runs phase 1 and K8's tile
   candidates (``K8_TILES``) alone: each built alone, bitwise the plain
   stage at 364^2, 1200^2 and on 64 grids, timed there in turns.
   ``python3 chip_smoke.py --k5-variants`` runs phase 1 and K5's
   candidates (``K5_VARIANTS``: points a thread, threads a block) alone:
   each built alone, bitwise the plain version at 364^2 and on 64 scans,
   timed there in turns.
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
   and the eager step's device ms and launches per stage
   (``bench.profile_steps``), ``bench --batch 64``
   (``bench.run_fleet_benchmark``); sorted against unsorted ms per scan on
   the captured step (sorted, unsorted, unsorted, sorted). Each captured
   path prints its capture time and graph pool bytes.

The line before the last is the kernels' JSON record (``ms`` is the device
time, ``library_ms`` null where no one PyTorch call computes the function;
K4 and K8 add their ``*_highres`` times and bound at 1200^2, K8 its plain
stage's ``plain_device_ms`` and ``plain_launches``; ``launches`` counts phase
3, ``launches_unsorted`` phase 6, ``launches_topk`` phase 7 and
``launches_fleet`` phase 9's 4 sorted ticks, ``launches_fleet_unsorted``
its 4 unsorted (batched) ticks, ``batched64_*`` phase 2's batched times,
``launches_spatial`` the captured run
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
import math
import os
import re
import subprocess
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


def march_inputs(config, driver, rec):
    """The march's inputs on scan ``rec`` from the driver's warm state, as
    the step builds them, by the plain versions (the budgets from K2's plain
    gather of the old ground): the prepared scan, its scan scalars and
    binning, the moved layers, the budgets, keys and directions, and the
    selected candidates (K11's plain version)."""
    from groundgrid_torch.core import grid as gridlib
    from groundgrid_torch.core import outliers
    from groundgrid_torch.ops import lookup, select

    scan, s, binning, _ = prepared(config, driver, rec)
    ground, conf = gridlib.move(config, driver.state.ground, driver.state.groundpatch, s)
    (old_h,) = lookup.lookup_plain(binning.cell, [ground], config.cell_count ** 2)
    budget, key, dirs = outliers.march_budget(config, s, binning, scan.px, scan.py, scan.pz,
                                              old_h)
    k = min(config.max_outlier_candidates, scan.px.shape[-1])
    return {"scan": scan, "s": s, "binning": binning, "ground": ground, "conf": conf,
            "budget": budget, "key": key, "dirs": dirs,
            "pidx": select.select_candidates_plain(budget, key, k)[0]}


def march_lattice(config, driver, rec):
    """The flat cell ids the plain march hands K2 on scan ``rec`` from the
    driver's state, one lattice per chunk of candidates: the plain march
    (``core/outliers.py march``, over the occlusion key table) over
    :func:`march_inputs`, its K2 calls recorded, every candidate walking its
    own ray (the zero-budget ones too, whose directions K6 leaves 0). The
    step's march is K7, which reads neither K2 nor the table: the lattice is
    on no path, a K2 measurement."""
    from groundgrid_torch.core import exactf32, outliers
    from groundgrid_torch.ops import lookup

    x = march_inputs(config, driver, rec)
    scan, calls = x["scan"], []

    def keep(cell, tables, n):
        calls.append(cell.clone())
        return lookup.lookup_plain(cell, tables, n)

    *d, length = outliers._ray(scan.px, scan.py, scan.pz, x["s"])
    rays = torch.stack([exactf32.div_rn(v, length) for v in d])
    outliers.march(config, x["s"], x["ground"], x["conf"], x["pidx"], x["budget"], rays, keep)
    if not calls:
        raise AssertionError("the march made no lookup on the warm scan")
    return calls


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
    """K2 on sorted point cells with 2 tables (ground and variance: the
    step's one call, for classify) and with 1 (the old ground, which K6
    reads itself: on no path, a K2 measurement), a uniform random
    lattice-sized vector and the march lattice of scan ``rec_scan`` (on no
    path since K7 reads its keys itself: a K2 measurement)."""
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
    # one table, the old ground (K6 reads it itself: a K2 measurement),
    # beside index_select over the table with a zero word at n2
    one = kernel_times(lambda: lookup.lookup(cell, [ground], n2), 100, "lookup_kernel",
                       lambda: lookup.lookup_plain(cell, [ground], n2), 20)
    padded1 = padded[0].contiguous()
    if not torch.equal(lookup.lookup(cell, [ground], n2)[0].view(torch.int32),
                       torch.index_select(padded1, 0, cell).view(torch.int32)):
        raise AssertionError("K2: index_select differs from the kernel (1 table)")
    one["library_ms"] = device_ms(lambda: torch.index_select(padded1, 0, cell), 100)[0]
    one.update(bound(cell.nbytes + 4 * touched + 4 * cell.shape[0], 0))
    rec.update({"one_table_" + k: v for k, v in one.items()})
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
        f"ms; 1 table x {cell.shape[0]} sorted points (the old ground, on no path): device "
        f"{one['device_ms']:.4f} ms, index_select {one['library_ms']:.4f} ms, call "
        f"{one['call_ms']:.4f} ms, plain {one['plain_ms']:.4f} ms, bound "
        f"{one['bound_ms']:.5f} ms; 1 table x {lattice.shape[0]} uniform random "
        f"({lat_touched} distinct cells): "
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


def detect_cost(tabs, layers, interior=True):
    """Bytes and f32 operations of one detect sweep over ``layers`` (the
    five inputs, (N, N) or (B, N, N)): each input read once, the tables
    once (``interior`` too: K8 reads it, K4 does not), two layers written;
    per interior cell 6 operations per window cell (2 products, 3 sums, a
    min) over its 3x3 or 5x5 window and ~25 for the branch ladder."""
    n = tabs.use3.shape[-1]
    grids = layers[0].numel() // (n * n)
    use3 = tabs.use3[2:n - 2, 2:n - 2]
    n3 = int(use3.sum())
    flops = 6 * (9 * n3 + 25 * (use3.numel() - n3)) + 25 * use3.numel()
    read = [tabs.var_thr_sq, tabs.skip_thr, tabs.min_expected_s, tabs.use3]
    n_bytes = sum(t.nbytes for t in list(layers) + read + [tabs.interior] * interior)
    return n_bytes + grids * 2 * 4 * n * n, grids * flops


def detect_times(config, tabs, args, plain_reps=20):
    """K4's times on one case and its bound (``detect_cost``; K4 reads no
    ``interior``)."""
    from groundgrid_torch.ops import detect

    rec = kernel_times(lambda: detect.detect_fused(config, tabs, *args), 100, "detect_kernel",
                       lambda: detect.detect_fused_plain(config, tabs, *args), plain_reps)
    rec.update(bound(*detect_cost(tabs, args, interior=False)))
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


def stage_times(config, tabs, args, plain_reps=20):
    """K8's times on one case, its plain version's (call ms by CUDA
    events; device ms and device activities a call by ``torch.profiler``)
    and its bound (``detect_cost``)."""
    from groundgrid_torch.core import detect as detectlib
    from groundgrid_torch.ops.detect_stage import detect_stage
    from groundgrid_torch.runtime.kernel_timing import device_ms

    def plain():
        return detectlib.detect_ground_patches(config, tabs, *args)

    rec = kernel_times(lambda: detect_stage(config, tabs, *args), 100, "detect_stage_kernel",
                       plain, plain_reps)
    reps = max(2, plain_reps // 4)
    ms, seen = device_ms(plain, reps)
    rec.update(plain_device_ms=ms, plain_launches=seen / reps)
    rec.update(bound(*detect_cost(tabs, args)))
    return rec


def halo_blocks(layers, n_shards):
    """The row blocks of ``n_shards`` shards, as the spatial step gives them
    to K8: each shard's stencil inputs with ``HALO`` rows of its neighbours
    (zeros at the grid's top and bottom), its ground and groundpatch rows."""
    from groundgrid_torch.core.detect import HALO

    n = layers[0].shape[-1]
    rows = n // n_shards
    for s in range(n_shards):
        at = slice(s * rows, (s + 1) * rows)
        halos = [torch.nn.functional.pad(t, (0, 0, HALO, HALO))[at.start:at.stop + 2 * HALO]
                 for t in layers[:3]]
        yield at, halos, layers[3][at], layers[4][at]


def stage_batch(config, driver, records, b=None, layers=None):
    """K8 on a batch of ``b`` (FLEET_BATCH) grids at the main path's shapes,
    ``layers`` or :func:`batched_inputs`' of ``records[4:12]`` (warm raster
    layers, each vehicle's ground offset): one launch bitwise its ``b``
    single launches and the plain batched stage; timed against the single
    launches (``batched_times``)."""
    from groundgrid_torch.core import detect as detectlib
    from groundgrid_torch.ops.detect_stage import detect_stage

    b = FLEET_BATCH if b is None else b
    if layers is None:
        layers = batched_inputs(config, driver, records[4:12], b)["detect"]
    tabs = detectlib.make_tables(config, driver.device)
    got = detect_stage(config, tabs, *layers)
    want = detectlib.detect_ground_patches(config, tabs, *layers)
    for v in range(b):
        single = detect_stage(config, tabs, *(t[v] for t in layers))
        if not all(bitwise(g[v], w) for g, w in zip(got, single)):
            raise AssertionError(f"K8 batched: grid {v} differs from its single launch")
    if not all(bitwise(g, w) for g, w in zip(got, want)):
        raise AssertionError("K8 batched differs from its plain batched version")
    return dict(max_abs_err=0.0, **batched_times(
        "K8 detect_stage", lambda: detect_stage(config, tabs, *layers),
        lambda: [detect_stage(config, tabs, *(t[v] for t in layers)) for v in range(b)],
        lambda: detectlib.detect_ground_patches(config, tabs, *layers), "detect_stage_kernel",
        b, *detect_cost(tabs, layers)))


def check_detect_stage(config, driver, rec, records):
    """K8 against its plain version, ``core/detect.py`` on the same CUDA
    tensors: the warm raster layers of one real scan at 364^2 and at 1200^2
    (``HIGHRES_CONFIG``, a driver warmed on ``records[:4]``), random layers
    at n = 12 and 45 (seed 3 with variance x0.01: the main update fires),
    the seam layers (``detect_seam_layers``: +-0.0, FLT_MAX and NaN in
    min_gh and points inside windows, ties of the ladder) at n = 45 and 80;
    ground and confidence bitwise (NaN and -0.0 included), two runs
    bitwise. The halo'd row blocks of S = 4 shards at 364^2 and S = 8 at
    1200^2 (``halo=2``), each bitwise ``detect_block`` and together bitwise
    the full sweep. Timed at both grid sizes (``stage_times``) and on a
    batch of FLEET_BATCH grids at 364^2 (:func:`stage_batch`, ``b64_*``);
    the kernel's registers and spills (:func:`ptxas_usage`)."""
    from groundgrid_torch.config import HIGHRES_CONFIG, GroundGridConfig
    from groundgrid_torch.core import detect as detectlib
    from groundgrid_torch.data.synthetic import detect_layers, detect_seam_layers
    from groundgrid_torch.ops.detect_stage import detect_stage

    device = driver.device
    high = dataclasses.replace(HIGHRES_CONFIG, sorted_scans=True)
    high_driver = warm_driver(high, records, device)
    cases = [("364^2 warm scan", config, detectlib.make_tables(config, device),
              warm_detect_layers(config, driver, rec)),
             ("1200^2 warm scan", high, detectlib.make_tables(high, device),
              warm_detect_layers(high, high_driver, rec))]
    del high_driver
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
    for dim, res in ((16.65, 0.37), (40.0, 0.5)):
        cfg = GroundGridConfig(dimension=dim, resolution=res)
        tabs = detectlib.make_tables(cfg, device)
        for seed in range(2):
            cases.append((f"n={cfg.cell_count} seam seed {seed}", cfg, tabs, tuple(
                torch.from_numpy(a).to(device) for a in detect_seam_layers(cfg.cell_count, seed))))
    changed, full = [], {}
    for name, cfg, tabs, args in cases:
        got = detect_stage(cfg, tabs, *args)
        again = detect_stage(cfg, tabs, *args)
        want = detectlib.detect_ground_patches(cfg, tabs, *args)
        for g, a, w, what in zip(got, again, want, ("ground", "confidence")):
            if not bitwise(g, w):
                diff = g.view(torch.int32) != w.view(torch.int32)
                raise AssertionError(f"K8 ({name}) {what} differs in {int(diff.sum())} cells: "
                                     f"{g[diff][:4].tolist()} against {w[diff][:4].tolist()}")
            if not bitwise(g, a):
                raise AssertionError(f"K8 ({name}) {what}: two runs not bitwise equal")
        changed.append(int((got[1] != args[4]).sum()))
        if not changed[-1]:
            raise AssertionError(f"K8 ({name}): the sweep changed no cell")
        if "seam" in name:
            zeros = [int(((got[0] == 0) & (got[0].signbit() == neg)).sum()) for neg in (0, 1)]
            log(f"K8 {name}: {changed[-1]} cells updated, ground +0.0 in {zeros[0]} cells and "
                f"-0.0 in {zeros[1]}, NaN in {int(got[0].isnan().sum())}")
        full[name] = want
    for (name, cfg, tabs, args), n_shards in zip(cases[:2], (4, 8)):
        blocks = []
        for at, halos, g, c in halo_blocks(args, n_shards):
            rt = detectlib.row_tables(tabs, at)
            got = detect_stage(cfg, rt, *halos, g, c, halo=detectlib.HALO)
            want = detectlib.detect_block(cfg, rt, *halos, g, c)
            if not all(bitwise(x, y) for x, y in zip(got, want)):
                raise AssertionError(f"K8 ({name}, rows {at.start}-{at.stop - 1} of {n_shards} "
                                     f"shards) differs from detect_block")
            blocks.append(got)
        for i, what in enumerate(("ground", "confidence")):
            if not bitwise(torch.cat([b[i] for b in blocks]), full[name][i]):
                raise AssertionError(f"K8 ({name}): the {n_shards} halo'd blocks' {what} is not "
                                     f"the full sweep's")
    out = {"max_abs_err": 0.0, "library_ms": None}
    out.update(stage_times(*cases[0][1:]))
    high_times = stage_times(*cases[1][1:], plain_reps=5)
    for key in ("device_ms", "wrapper_device_ms", "call_ms", "plain_ms", "plain_device_ms",
                "plain_launches", "bound_ms"):
        out[key + "_highres"] = high_times[key]
    batch = stage_batch(config, driver, records)
    out.update({f"b{FLEET_BATCH}_{k}": v for k, v in batch.items()
                if k in ("device_ms", "singles_device_ms", "call_ms", "bound_ms")})
    usage = ptxas_usage("detect_stage.cu", ("detect_stage_kernel",))["detect_stage_kernel"]
    out["registers"], out["spill_store_bytes"], out["spill_load_bytes"] = usage
    for i, suffix in ((0, ""), (1, "_highres")):
        n = cases[i][1].cell_count
        log(f"K8 detect_stage {n}^2 warm scan ({changed[i]} cells updated): device "
            f"{out['device_ms' + suffix]:.4f} ms (wrapper {out['wrapper_device_ms' + suffix]:.4f} "
            f"ms), call {out['call_ms' + suffix]:.4f} ms, plain {out['plain_ms' + suffix]:.4f} "
            f"ms (device {out['plain_device_ms' + suffix]:.4f} ms in "
            f"{out['plain_launches' + suffix]:.0f} device activities), bound "
            f"{out['bound_ms' + suffix]:.4f} ms ({out['bound_by']})")
    log(f"K8 detect_stage at B = {FLEET_BATCH}, {config.cell_count}^2: device "
        f"{out[f'b{FLEET_BATCH}_device_ms']:.4f} ms, bound {out[f'b{FLEET_BATCH}_bound_ms']:.4f} "
        f"ms; {usage[0]} registers, spills {usage[1]} / {usage[2]} bytes")
    log("K8 detect_stage: bitwise core/detect.py and two runs bitwise at 364^2, 1200^2, n=12 "
        "and n=45 (4 seeds each), the seam layers at n=45 and 80 (2 seeds each); the halo'd "
        "blocks of S=4 at 364^2 and S=8 at 1200^2 bitwise detect_block and, together, the "
        "full sweep")
    return out


# f32 operations (adds, subtracts, multiplies, divides, square roots,
# floors) of the fused kernels, counted from csrc/exactf32.cuh: two_sum 6,
# split 4, two_prod 17, ds_add 14, ds_add_f32 13, two_prod_int_const 14,
# ds_bin 87 (and 8 for the splits of the resolution a thread), sumsq3_ds
# 79, sqrt_rn_ds 180, div_rn 123, the ray (3 differences, sumsq3_ds,
# sqrt_rn_ds) 262
BIN_FLOPS = 2 * 87 + 8 + 5  # a point: both axes, the splits, the squared distance
BUDGET_POINT_FLOPS = 1  # an in-map, unignored point: old_h - 0.2
BUDGET_CAND_FLOPS = 262 + 123 + 1  # a candidate: the ray, vz, its square
BUDGET_DIR_FLOPS = 2 * 123  # a marchable point: vx and vy
MARCH_STEP_FLOPS = 1 + 4 + 2 * 87 + 3  # a live step: step^2, the sample, its cells, thr
MARCH_BLOCK_FLOPS = 8  # a 3x3 confidence block summed


def budget_work(config, binning, z, ground):
    """What K6 must read of the moved ``ground`` on these points (one
    vehicle, or a batch row by row): the in-map, unignored points (``read``:
    they read their cell id and then the ground word), the distinct ground
    cells those ids name inside the grid (``cells``) and the candidates
    (``candidates``: at least 0.2 below that word)."""
    from groundgrid_torch.ops.lookup import lookup_plain

    n2 = config.cell_count ** 2
    live = binning.inmap & ~binning.ignored
    (old_h,) = lookup_plain(binning.cell, [ground], n2)
    row = torch.arange(math.prod(binning.cell.shape[:-1]), device=z.device).view(
        *binning.cell.shape[:-1], 1) * (n2 + 1)
    named = (binning.cell.long() + row)[live & (binning.cell < n2)]
    return {"read": int(live.sum()), "cells": int(torch.unique(named).numel()),
            "candidates": int((live & (z < old_h - float(np.float32(0.2)))).sum())}


def budget_cost(p, work, marchable):
    """K6's (bytes, f32 operations) on these inputs (:func:`budget_work`):
    19 bytes a point (z and the two flags read, budget, key and the zeroed
    outlier flag written), 4
    a point that reads its cell id and 4 a distinct ground cell those ids
    name, 8 a candidate (x and y, which only a candidate's ray reads) and
    12 a marchable point (its directions); the candidate tests, the
    candidates' rays and the marchable points' vx, vy."""
    return (19 * p + 4 * work["read"] + 4 * work["cells"] + 8 * work["candidates"]
            + 12 * marchable, BUDGET_POINT_FLOPS * work["read"]
            + BUDGET_CAND_FLOPS * work["candidates"] + BUDGET_DIR_FLOPS * marchable)


def march_cost(rows, walking, work):
    """K7's (bytes, f32 operations) on ``rows`` vehicles' :func:`march_work`:
    8 bytes a row (K11's count), 12 a candidate before it (``walking``:
    index, budget; the others end on the count), 12 a marching one (its
    directions), 4 a ground cell and 4 a confidence cell its samples read,
    1 a hit written (K6 zeroes the flags); 182 operations a step evaluated,
    8 a block summed."""
    return (8 * rows + 12 * walking + 12 * work["marching"] + 4 * work["ground_cells"]
            + 4 * work["conf_cells"] + work["hits"], MARCH_STEP_FLOPS * work["steps"]
            + MARCH_BLOCK_FLOPS * work["blocks"])


def host_packed(config, driver, scan):
    """The (SIZE,) f32 scan scalars of ``scan`` against the driver's state, on the host."""
    from groundgrid_torch.pipeline import scan_scalars as host_scalars

    return host_scalars(config, driver.state.center_np, driver.state.center_lo_np, scan)[0]


# the kernels line's further keys: registers and spills, the key table K7
# folds in, K8's plain stage on the profiler, K9 on a shuffled scan, K10
# with all layers and over 4 shards, K11's torch.topk launches and cluster
# shapes, K12's wipe (and, by prefix, K11's other cases)
EXTRA_KEYS = ("registers", "spill_store_bytes", "spill_load_bytes", "key_table_device_ms",
              "key_table_launches", "stage_device_ms", "stage_launches", "plain_device_ms", "plain_launches", "shuffled_device_ms",
              "aux_device_ms", "shards4_device_ms", "library_launches", "wipe_device_ms",
              "cluster_shapes")
EXTRA_PREFIXES = ("one_table_", "exact_key_", "overflow_", "tail_crossing_")


def march_work(config, s, ground, conf, pidx, budget, dirs):
    """What the march must evaluate on these inputs (one vehicle): the
    candidates with a live step (``marching``: they read their directions),
    the live steps of each up to its first hit (``any`` stops there), the
    distinct cells those steps read in the ground layer (``ground_cells``)
    and in the confidence layer (``conf_cells``: the cell itself, and the
    3x3 block where the cell's key could reach the threshold: ``blocks``
    samples), and the hits. The lattice of the plain march (``core/
    outliers.py march``), unchunked."""
    from groundgrid_torch.core import outliers
    from groundgrid_torch.core import rasterize as rasterlib
    from groundgrid_torch.core import scalars as scalarlib

    n = config.cell_count
    g = [scalarlib.grid(v) for v in (s.ox, s.oy, s.oz, s.sh0, s.sl0, s.sh1, s.sl1)]
    vx, vy, vz = (d[pidx][None, :] for d in dirs)
    steps = torch.arange(3, config.ray_steps, dtype=torch.float32, device=budget.device)[:, None]
    live = steps * steps < budget[pidx][None, :]
    i0, i1 = rasterlib.ds_cells(config, *g[3:], g[0] + steps * vx, g[1] + steps * vy)
    inside = (i0 > 0) & (i1 > 0) & (i0 < n - 1) & (i1 < n - 1)
    flat = torch.clamp(i0, 0, n - 1) * n + torch.clamp(i1, 0, n - 1)
    table = outliers.occlusion_key_table(config, ground, conf)
    keys = outliers._u32_bits(table.reshape(-1)[flat.reshape(-1)]).reshape(flat.shape)
    thr = outliers._mono_u32((steps * vz + g[2]) + float(np.float32(config.outlier_tolerance)))
    hit = live & inside & (keys >= thr)
    rank = torch.arange(steps.shape[0], device=budget.device)[:, None]
    first = torch.where(hit.any(0), hit.to(torch.int32).argmax(0), steps.shape[0])
    read = live & (rank <= first[None, :]) & inside
    cells = flat[read]
    # K7 sums the block only where thr > 0 and the cell's own tests pass
    boxed = read & (thr > 0) & (outliers._mono_u32(ground.reshape(-1)[flat]) >= thr) & (
        conf.reshape(-1)[flat] > float(np.float32(0.01)))
    r, c = (torch.clamp(i, min=3)[boxed][:, None] for i in (i0, i1))
    window = torch.arange(-1, 2, device=budget.device)
    block = ((r + window.repeat_interleave(3)) * n + (c + window.repeat(3))).reshape(-1)
    return {"marching": int(live.any(0).sum()), "steps": int((live & (rank <= first)).sum()),
            "live_steps": int(live.sum()), "ground_cells": int(torch.unique(cells).numel()),
            "conf_cells": int(torch.unique(torch.cat([cells, block])).numel()),
            "blocks": int(boxed.sum()), "hits": int(hit.any(0).sum())}


def ptxas_usage(source, kernels):
    """``{kernel: (registers, spill store bytes, spill load bytes)}`` of the
    named kernels of ``csrc/<source>``, as ``nvcc -Xptxas -v`` reports them
    under the build's flags (a compile of its own, into the build
    directory)."""
    from groundgrid_torch.ops import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
               os.path.join(tmp, "usage.o"), str(_build.CSRC / source)]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc -Xptxas -v failed ({proc.returncode}):\n{proc.stderr}")
    return parse_ptxas(proc.stdout + proc.stderr, kernels)


def parse_ptxas(text, kernels):
    """:func:`ptxas_usage`'s record from ``nvcc -Xptxas -v`` output."""
    out, name, spills = {}, None, (None, None)
    # longest names first: march_kernel is no part of march_budget_kernel,
    # but a later kernel's name may hold an earlier one's
    names = sorted(kernels, key=len, reverse=True)
    for line in text.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            name = next((k for k in names if k in entry.group(1)), None)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill:
            spills = (int(spill.group(1)), int(spill.group(2)))
        used = re.search(r"Used (\d+) registers", line)
        if used and name is not None:
            out[name] = (int(used.group(1)), *spills)
            name, spills = None, (None, None)
    missing = [k for k in kernels if k not in out]
    if missing:
        raise RuntimeError(f"nvcc -Xptxas -v reported no registers for {missing}")
    return out


# K8's tile candidates (kTileH, kTileW, kStrip): output rows and columns a
# block, cells a thread; the first is the one csrc/detect_stage.cu builds
K8_TILES = ((8, 64, 2), (8, 64, 4), (16, 64, 4))


def source_variants(source, entry_name, kernel, names, variants, tmp, label):
    """``{variant: (entry point, ptxas record, SASS mix)}``: ``csrc/<source>``
    with each variant's values of its ``constexpr int`` constants ``names``,
    built alone with the library's flags (one nvcc a variant, all started
    together) and loaded with ctypes; ``entry_name`` the C entry point,
    ``kernel`` the kernel the records name."""
    import ctypes

    from groundgrid_torch.ops import _build

    text = (_build.CSRC / source).read_text()
    with open(os.path.join(tmp, "exactf32.cuh"), "w") as f:
        f.write((_build.CSRC / "exactf32.cuh").read_text())
    jobs = {}
    for k, variant in enumerate(variants):
        src = text
        for name, value in zip(names, variant):
            src, found = re.subn(rf"constexpr int {name} = \d+;",
                                 f"constexpr int {name} = {value};", src)
            if found != 1:
                raise RuntimeError(f"{source}: no single {name}")
        path = os.path.join(tmp, f"{label.split()[0]}_{k}.cu")
        with open(path, "w") as f:
            f.write(src)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o",
               path[:-3] + ".so", path]
        jobs[variant] = (path[:-3] + ".so", subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                             stderr=subprocess.STDOUT, text=True))
    out = {}
    for variant, (lib, proc) in jobs.items():
        text_out, _ = proc.communicate(timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"{label} {variant}: nvcc failed\n{text_out}")
        entry = getattr(ctypes.CDLL(lib), entry_name)
        entry.argtypes = _build._SIGNATURES[entry_name]
        entry.restype = ctypes.c_int
        out[variant] = (entry, parse_ptxas(text_out, (kernel,))[kernel], sass_mix(lib, kernel))
    return out


def stage_variants(tiles, tmp):
    """``{tile: (entry point, ptxas record, SASS mix)}``:
    ``csrc/detect_stage.cu`` with each tile's constants (:func:`source_variants`)."""
    return source_variants("detect_stage.cu", "gg_detect_stage", "detect_stage_kernel",
                           ("kTileH", "kTileW", "kStrip"), tiles, tmp, "K8 tile")


def sass_mix(lib, kernel):
    """``{"instructions": n, opcode: count, ...}`` of ``kernel``'s SASS in
    the shared library ``lib`` (``cuobjdump -sass``): the static
    instruction count and its loads, stores, adds, mins, tests and
    barriers (the opcode's first word, e.g. LDS for LDS.128)."""
    from groundgrid_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                          timeout=120).stdout
    mix, inside = {}, False
    for line in text.splitlines():
        if "Function :" in line:
            inside = kernel in line
            continue
        op = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if inside and op:
            mix["instructions"] = mix.get("instructions", 0) + 1
            mix[op.group(1)] = mix.get(op.group(1), 0) + 1
    keep = ("instructions", "LDS", "LDG", "STS", "STG", "FADD", "FMNMX", "FSETP", "FSEL", "SEL",
            "BAR", "BRA")
    return {k: mix.get(k, 0) for k in keep}


def call_variant(entry, config, tabs, layers):
    """One launch of a K8 variant's entry point on ``layers`` (the whole
    grid, halo 0, one grid or a batch); its fresh outputs."""
    from groundgrid_torch.ops import _build
    from groundgrid_torch.ops.detect import _constants

    g = layers[3]
    out_g, out_c = torch.empty_like(g), torch.empty_like(layers[4])
    pccvt, out_tol, ocpcf = _constants(config)
    batch = g.shape[0] if g.dim() == 3 else 1
    _build.check(entry(*(t.data_ptr() for t in [*layers, tabs.records]), g.shape[-2],
                       config.cell_count, 0, batch, pccvt, out_tol, ocpcf, ocpcf * 2.0,
                       out_g.data_ptr(), out_c.data_ptr(),
                       torch.cuda.current_stream().cuda_stream), "detect_stage variant")
    return out_g, out_c


def phase_k8_tiles(config, records, device):
    """K8's tile candidates (:data:`K8_TILES`) on the warm layers of one
    scan at 364^2 and at 1200^2 and on a batch of FLEET_BATCH grids at
    364^2: each variant bitwise the plain stage, then its device ms by
    ``torch.profiler`` in turns (the candidates in order, then reversed),
    its registers and spills. Returns ``{tile: record}``."""
    from groundgrid_torch.config import HIGHRES_CONFIG
    from groundgrid_torch.core import detect as detectlib
    from groundgrid_torch.runtime.kernel_timing import device_ms

    driver = warm_driver(config, records, device)
    high = dataclasses.replace(HIGHRES_CONFIG, sorted_scans=True)
    cases = {"364": (config, warm_detect_layers(config, driver, records[4])),
             "1200": (high, warm_detect_layers(high, warm_driver(high, records, device),
                                               records[4])),
             f"b{FLEET_BATCH}": (config, batched_inputs(config, driver, records[4:12],
                                                         FLEET_BATCH)["detect"])}
    tabs = {key: detectlib.make_tables(cfg, device) for key, (cfg, _) in cases.items()}
    with tempfile.TemporaryDirectory() as tmp:
        variants = stage_variants(K8_TILES, tmp)
        out = {tile: {"registers": usage[0], "spill_store_bytes": usage[1],
                      "spill_load_bytes": usage[2], "sass": mix}
               for tile, (_, usage, mix) in variants.items()}
        for key, (cfg, layers) in cases.items():
            want = detectlib.detect_ground_patches(cfg, tabs[key], *layers)
            for tile, (entry, _, _) in variants.items():
                got = call_variant(entry, cfg, tabs[key], layers)
                if not all(bitwise(g, w) for g, w in zip(got, want)):
                    raise AssertionError(f"K8 tile {tile} ({key}) differs from the plain stage")
        for tile in list(K8_TILES) + list(K8_TILES)[::-1]:
            entry = variants[tile][0]
            for key, (cfg, layers) in cases.items():
                ms = device_ms(lambda: call_variant(entry, cfg, tabs[key], layers), 50,
                               "detect_stage_kernel")[0]
                out[tile].setdefault(f"device_ms_{key}", []).append(ms)
    for tile, rec in out.items():
        log(f"K8 tile {tile[0]} x {tile[1]}, {tile[2]} cells a thread: bitwise at 364^2, 1200^2 "
            f"and B = {FLEET_BATCH}; device ms in turns " + ", ".join(
                f"{key} " + " / ".join(f"{v:.4f}" for v in rec[f"device_ms_{key}"])
                for key in cases) + f"; {rec['registers']} registers, spills "
            f"{rec['spill_store_bytes']} / {rec['spill_load_bytes']} bytes; SASS {rec['sass']}")
    return {f"{t[0]}x{t[1]}/{t[2]}": rec for t, rec in out.items()}


# K5's candidates (kPts, kThreads): points a thread (the vector width) and
# threads a block; the first is the one csrc/binning.cu builds
K5_VARIANTS = ((2, 256), (4, 128), (4, 256), (2, 64), (2, 128), (1, 128), (1, 256), (8, 64))


def call_bin_variant(entry, config, s, x, y, rings, valid):
    """One launch of a K5 variant's entry point; its fresh outputs."""
    import math

    from groundgrid_torch.core import exactf32
    from groundgrid_torch.core import scalars as scalarlib
    from groundgrid_torch.core.rasterize import Binning
    from groundgrid_torch.ops import _build

    base, stride = scalarlib.device_rows(s, x)
    out = Binning(*(torch.empty(x.shape, dtype=dt, device=x.device) for dt in (
        torch.int32, torch.int32, torch.int32, torch.bool, torch.bool, torch.float32)))
    rh, rl, inv = exactf32.res_ds(config.resolution)
    _build.check(entry(x.data_ptr(), y.data_ptr(), rings.data_ptr(), valid.data_ptr(),
                       x.shape[-1], math.prod(x.shape[:-1]), base, stride, config.cell_count,
                       float(rh), float(rl), float(inv), int(config.max_ring),
                       float(np.float32(config.min_dist_squared)), *(t.data_ptr() for t in out),
                       torch.cuda.current_stream().cuda_stream), "bin_points variant")
    return out


def phase_k5_variants(config, records, device):
    """K5's candidates (:data:`K5_VARIANTS`) on a prepared scan at 364^2
    (131,072 points) and on a batch of FLEET_BATCH scans: each variant
    bitwise the plain version, then its device ms by ``torch.profiler`` in
    turns (the candidates in order, then reversed), its registers and
    spills. Returns ``{variant: record}``."""
    from groundgrid_torch.core import scalars as scalarlib
    from groundgrid_torch.core.rasterize import bin_points
    from groundgrid_torch.runtime.kernel_timing import device_ms

    driver = warm_driver(config, records, device)
    scan, s, _, _ = prepared(config, driver, records[4])
    x = batched_inputs(config, driver, records[4:12], FLEET_BATCH)
    px, py, _, rings, valid = x["points"]
    cases = {"364": (s, scan.px, scan.py, scan.rings, scan.valid > 0),
             f"b{FLEET_BATCH}": (scalarlib.view(x["scalars"]), px, py, rings, valid)}
    with tempfile.TemporaryDirectory() as tmp:
        variants = source_variants("binning.cu", "gg_bin", "binning_kernel",
                                   ("kPts", "kThreads"), K5_VARIANTS, tmp, "K5 variant")
        out = {v: {"registers": usage[0], "spill_store_bytes": usage[1],
                   "spill_load_bytes": usage[2], "sass": mix}
               for v, (_, usage, mix) in variants.items()}
        for key, args in cases.items():
            want = bin_points(config, *args)
            for v, (entry, _, _) in variants.items():
                got = call_bin_variant(entry, config, *args)
                if not all(bitwise(g, w) for g, w in zip(got, want)):
                    raise AssertionError(f"K5 variant {v} ({key}) differs from the plain version")
        for v in list(K5_VARIANTS) + list(K5_VARIANTS)[::-1]:
            entry = variants[v][0]
            for key, args in cases.items():
                ms = device_ms(lambda: call_bin_variant(entry, config, *args), 50,
                               "binning_kernel")[0]
                out[v].setdefault(f"device_ms_{key}", []).append(ms)
    for v, rec in out.items():
        log(f"K5 variant {v[0]} points a thread, {v[1]} threads a block: bitwise at 364^2 and "
            f"B = {FLEET_BATCH}; device ms in turns " + ", ".join(
                f"{key} " + " / ".join(f"{ms:.5f}" for ms in rec[f"device_ms_{key}"])
                for key in cases) + f"; {rec['registers']} registers, spills "
            f"{rec['spill_store_bytes']} / {rec['spill_load_bytes']} bytes; SASS {rec['sass']}")
    return {f"{v[0]}x{v[1]}": rec for v, rec in out.items()}


def check_binning(config, driver, rec):
    """K5 on a prepared scan (131,072 points) against its plain version on
    the card and the host prep's ids (the plain version on the CPU):
    bitwise, two runs bitwise; its times and bound (reads x, y, the ring
    and the valid flag, writes the six outputs: 31 bytes a point)."""
    from groundgrid_torch.core import scalars as scalarlib
    from groundgrid_torch.ops import binning

    scan, s, want, _ = prepared(config, driver, rec)
    args = (config, s, scan.px, scan.py, scan.rings, scan.valid > 0)
    got, again = binning.bin_points(*args), binning.bin_points(*args)
    for field, g, a, w in zip(want._fields, got, again, want):
        if not bitwise(g, w):
            raise AssertionError(f"K5 {field} differs from the plain version in "
                                 f"{int((g != w).sum())} points")
        if not bitwise(a, g):
            raise AssertionError(f"K5 {field}: two runs not bitwise equal")
    host = binning.bin_points_plain(config, scalarlib.view(torch.from_numpy(
        host_packed(config, driver, scan))), *(t.cpu() for t in args[2:]))
    if not bitwise(host.cell, got.cell):
        raise AssertionError("K5 cell ids differ from the host prep's")
    p = scan.px.shape[0]
    rec = {"max_abs_err": 0.0, "library_ms": None}
    rec.update(kernel_times(lambda: binning.bin_points(*args), 100, "binning_kernel",
                            lambda: binning.bin_points_plain(*args), 20))
    rec.update(bound(31 * p, BIN_FLOPS * p))
    log(f"K5 bin_points: {p} points ({int(got.inmap.sum())} in the map): bitwise the plain "
        f"version and the host prep's ids, two runs bitwise; device {rec['device_ms']:.4f} ms "
        f"(wrapper {rec['wrapper_device_ms']:.4f} ms), call {rec['call_ms']:.4f} ms, plain "
        f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.5f} ms ({rec['bound_by']})")
    return rec


def bin_batch(config, driver, records, b=None):
    """K5 on a batch of ``b`` (FLEET_BATCH) prepared scans (``records[4:12]``
    cycled, each its scan scalars): one launch bitwise the plain batched
    version; its device ms and bound (``kernel_turns.py`` times each tree's
    K5 so, by this script's probe)."""
    from groundgrid_torch.core import scalars as scalarlib
    from groundgrid_torch.ops import binning
    from groundgrid_torch.runtime.kernel_timing import device_ms

    b = FLEET_BATCH if b is None else b
    scans = [driver.make_scan(rec)[0] for rec in records[4:12]]
    pick = [scans[v % len(scans)] for v in range(b)]
    points = [torch.stack([getattr(sc, f) for sc in pick]) for f in ("px", "py", "rings", "valid")]
    packed = np.stack([host_packed(config, driver, sc) for sc in pick])
    args = (config, scalarlib.view(torch.from_numpy(packed).to(driver.device)), *points[:3],
            points[3] > 0)
    got, want = binning.bin_points(*args), binning.bin_points_plain(*args)
    if not all(bitwise(g, w) for g, w in zip(got, want)):
        raise AssertionError("K5 batched differs from its plain batched version")
    p = points[0].shape[-1]
    out = {"device_ms": device_ms(lambda: binning.bin_points(*args), 20, "binning_kernel")[0],
           **bound(31 * p * b, BIN_FLOPS * p * b)}
    log(f"K5 bin_points, B = {b}: bitwise the plain batched version; device "
        f"{out['device_ms']:.5f} ms, bound {out['bound_ms']:.5f} ms ({out['bound_by']})")
    return out


# K9 a point: the order (8 bytes), cell (4), inmap, ignored and outlier (3)
# and z (4) read, the id and seven columns (32) written (an accepted point's
# gi0 and gi1 come from its id); 15 f32 operations (pd, the plane shift's
# 11, pdc, pdc^2). K10 a cell: the six columns the main path's layers need
# read a shard (24 bytes; the z sum too with the aux layers, 28), 4 bytes a
# layer written; 10 f32 operations for the main path's three layers.
COLUMNS_BYTES, COLUMNS_FLOPS = 51, 15
FINISH_BYTES, FINISH_AUX_BYTES, FINISH_LAYER_BYTES, FINISH_FLOPS = 24, 28, 4, 10


def raster_stage_inputs(config, driver, rec):
    """The raster stage's inputs on scan ``rec`` from the driver's warm
    state, as the main path builds them: the scan scalars, the binning (K5),
    z, the march's outlier flags (K6, K11, K7) and the stable sort's order
    (of the sorted scan, the identity)."""
    from groundgrid_torch.core import outliers
    from groundgrid_torch.ops import binning, march, move, select

    scan, s, _, _ = prepared(config, driver, rec)
    b = binning.bin_points(config, s, scan.px, scan.py, scan.rings, scan.valid > 0)
    ground, conf = move.move(config, driver.state.ground, driver.state.groundpatch, s)
    outlier, _ = outliers.detect_outliers(config, s, ground, conf, b, scan.px, scan.py,
                                          scan.pz, march.march_budget,
                                          select.select_candidates, march.march)
    return s, b, scan.pz, outlier, torch.argsort(b.cell, dim=-1, stable=True)


def same_columns(got, want):
    return bitwise(got[0], want[0]) and all(bitwise(g, w) for g, w in zip(got[1], want[1]))


def same_layers(got, want):
    return all((g is None and w is None) or (g is not None and w is not None and bitwise(g, w))
               for g, w in zip(got, want))


def check_raster_stage(config, driver, rec):
    """K9 and K10 on a warm scan against their plain versions on the card,
    bitwise, two runs bitwise: K9 through the stable sort's order of the
    sorted scan (the main path's identity) and of the scan shuffled (the
    unsorted path's gathers); K10 over K1's columns of that scan with the
    main path's three layers, with all layers and the max (the aux path),
    and over 4 shards' columns (the spatial step's fold). Their times and
    bounds (:data:`COLUMNS_BYTES`, :data:`FINISH_BYTES`), and K1's after
    each producer of its columns (:func:`probe_k1_order`). Returns ``(k9,
    k10, k1_order)``."""
    from groundgrid_torch.core.rasterize import COLUMN_OPS, MAIN_LAYERS, Binning
    from groundgrid_torch.ops import raster, raster_stage
    from groundgrid_torch.runtime.kernel_timing import device_ms

    s, b, z, outlier, order = raster_stage_inputs(config, driver, rec)
    p, n2 = z.shape[-1], config.cell_count ** 2
    columns, columns_plain = (raster_stage.raster_columns_ordered,
                              raster_stage.raster_columns_ordered_plain)
    perm = torch.randperm(p, generator=torch.Generator().manual_seed(0)).to(z.device)
    sb = Binning(*(t[perm] for t in b))
    shuffled = (config, sb, z[perm], outlier[perm], s, torch.argsort(sb.cell, stable=True))
    args = (config, b, z, outlier, s, order)
    for name, a in (("sorted", args), ("shuffled", shuffled)):
        got, again, want = columns(*a), columns(*a), columns_plain(*a)
        if not same_columns(got, want):
            raise AssertionError(f"K9 ({name} scan) differs from its plain version")
        if not same_columns(again, got):
            raise AssertionError(f"K9 ({name} scan): two runs not bitwise equal")
    cell, cols = columns(*args)
    part = raster.raster_reduce(cell, cols, COLUMN_OPS, n2)
    bounds = np.linspace(0, p, 5).astype(int)
    shards = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        cb = Binning(*(t[lo:hi] for t in b))
        c, k = columns(config, cb, z[lo:hi], outlier[lo:hi], s, torch.argsort(cb.cell, stable=True))
        shards.append(raster.raster_reduce(c, k, COLUMN_OPS, n2))
    finish, finish_plain = raster_stage.finish_layers, raster_stage.finish_layers_plain
    cases = {"main": ([part], False), "aux": ([part], True), "shards4": (shards, False)}
    for name, (parts, aux) in cases.items():
        got, again = (finish(config, parts, s, aux) for _ in range(2))
        if not same_layers(got, finish_plain(config, parts, s, aux)):
            raise AssertionError(f"K10 ({name}) differs from its plain version")
        if not same_layers(again, got):
            raise AssertionError(f"K10 ({name}): two runs not bitwise equal")

    k9 = {"max_abs_err": 0.0, "library_ms": None}
    k9.update(kernel_times(lambda: columns(*args), 100, "raster_columns_kernel",
                           lambda: columns_plain(*args), 20))
    k9.update(bound(COLUMNS_BYTES * p, COLUMNS_FLOPS * int((cols[1] > 0).sum())))
    k9["shuffled_device_ms"] = device_ms(lambda: columns(*shuffled), 100,
                                         "raster_columns_kernel")[0]
    def call(fn, name):
        parts, aux = cases[name]
        return lambda: fn(config, parts, s, aux)

    k10 = {"max_abs_err": 0.0, "library_ms": None}
    k10.update(kernel_times(call(finish, "main"), 100, "raster_finish_kernel",
                            call(finish_plain, "main"), 20))
    k10.update(bound((FINISH_BYTES + FINISH_LAYER_BYTES * len(MAIN_LAYERS)) * n2,
                     FINISH_FLOPS * n2))
    k10["aux_bound_ms"] = bound((FINISH_AUX_BYTES + FINISH_LAYER_BYTES * 8) * n2, 0)["bound_ms"]
    for name in ("aux", "shards4"):
        k10[f"{name}_device_ms"] = device_ms(call(finish, name), 100, "raster_finish_kernel")[0]
    log(f"K9 raster_columns_ordered: {p} points ({int((cols[1] > 0).sum())} accepted): bitwise "
        f"the plain version, sorted and shuffled, two runs bitwise; device "
        f"{k9['device_ms']:.5f} ms (wrapper {k9['wrapper_device_ms']:.5f} ms; shuffled "
        f"{k9['shuffled_device_ms']:.5f}), call {k9['call_ms']:.4f} ms, plain "
        f"{k9['plain_ms']:.4f} ms, bound {k9['bound_ms']:.5f} ms ({k9['bound_by']})")
    log(f"K10 finish_layers: {n2} cells: bitwise the plain version (main path's 3 layers, all "
        f"with the max, 4 shards), two runs bitwise; device {k10['device_ms']:.5f} ms (wrapper "
        f"{k10['wrapper_device_ms']:.5f} ms; all layers {k10['aux_device_ms']:.5f}, 4 shards "
        f"{k10['shards4_device_ms']:.5f}), call {k10['call_ms']:.4f} ms, plain "
        f"{k10['plain_ms']:.4f} ms, bound {k10['bound_ms']:.5f} ms ({k10['bound_by']}; all "
        f"layers {k10['aux_bound_ms']:.5f})")
    return k9, k10, probe_k1_order(config, args, cell, cols)


def probe_k1_order(config, args, cell, cols):
    """K1's device ms (``torch.profiler``, its kernel alone) after each
    producer of its columns, in the step's order on one warm scan
    (``args``: K9's arguments; ``cell``, ``cols``: K9's output): K1
    repeated on K9's planes (phase 2's own K1 time), after K9 (the step),
    after the plain route's separate columns (the parent's step), after K9
    with the L2 cache flushed between (a 256 MB write), after copies of
    K9's columns into one (7, P) block, into seven separate tensors, and
    into a block whose planes are 1 KiB further apart, and after a 0.5 ms
    spin of one thread (``torch.cuda._sleep``: every other SM idle, as
    during K3). Returns ``{case: ms}``."""
    from groundgrid_torch.core.rasterize import COLUMN_OPS
    from groundgrid_torch.ops import raster, raster_stage
    from groundgrid_torch.runtime.kernel_timing import device_ms

    n2, p = config.cell_count ** 2, cell.shape[-1]
    columns, plain = raster_stage.raster_columns_ordered, raster_stage.raster_columns_ordered_plain
    flush = torch.empty(64 << 20, dtype=torch.int32, device=cell.device)
    stacked = torch.stack(cols)
    block = torch.empty_like(stacked)
    padded = torch.empty((len(cols), p + 256), dtype=torch.float32, device=cell.device)

    def k1(c):
        return raster.raster_reduce(c[0], c[1], COLUMN_OPS, n2)

    def flushed():
        c = columns(*args)
        flush.zero_()
        return k1(c)

    def copied(dst):
        dst.copy_(stacked)
        return k1((cell, list(dst.unbind(0))))

    cases = {
        "repeated": lambda: k1((cell, cols)),
        "after_k9": lambda: k1(columns(*args)),
        "after_plain_route": lambda: k1(plain(*args)),
        "after_k9_l2_flushed": flushed,
        "after_copy_block": lambda: copied(block),
        "after_copy_apart": lambda: k1((cell, [c.clone() for c in cols])),
        "after_copy_padded": lambda: copied(padded[:, :p]),
        "after_idle_sms": lambda: (torch.cuda._sleep(1 << 20), k1((cell, cols))),
    }
    out = {}
    for _ in range(2):  # in turns: the cases, then again
        for name, fn in cases.items():
            out.setdefault(name, []).append(device_ms(fn, 50, "raster_reduce_kernel")[0])
    log("K1 after each producer of its columns (device ms, two passes): " + ", ".join(
        f"{name} {ms[0]:.5f} / {ms[1]:.5f}" for name, ms in out.items()))
    return out


def k1_in_step(config, records, device):
    """K1's device ms a launch inside the step, eager (``make_step_fn``, as
    ``bench --profile`` stages it) and captured (the driver's step), by
    ``torch.profiler`` over ``records[2:10]`` after two warm steps; the
    longest run of cell ids K1 folds in each of those eager steps
    (``longest_runs``), and K1 repeated alone on the last one's own inputs
    (``repeated``). The tree's own step, so that ``kernel_turns.py`` reads
    it in any tree."""
    from groundgrid_torch.ops import raster
    from groundgrid_torch.pipeline import make_step_fn
    from groundgrid_torch.runtime.driver import StreamingDriver
    from groundgrid_torch.runtime.kernel_timing import device_ms, device_us, profiled

    out, inputs = {}, []
    for mode in ("eager", "captured"):
        driver = StreamingDriver(config, device=device)
        if mode == "eager":
            driver.step = step = make_step_fn(config)
            reduce = step._reduce

            def spy(cell, cols, ops, n2):  # holds each step's K1 inputs (no copy)
                inputs.append((cell, cols, ops, n2))
                return reduce(cell, cols, ops, n2)

            step._reduce = spy
        for rec in records[:2]:
            driver.process(rec)
        scans = [driver.make_scan(rec)[0] for rec in records[2:10]]
        torch.cuda.synchronize(device)
        with profiled() as prof:
            state = driver.state
            for scan in scans:
                state, _ = driver.step(state, scan)
            torch.cuda.synchronize(device)
        us, launches = device_us(prof, "raster_reduce_kernel")
        out[mode] = {"device_ms": us / 1000.0 / max(launches, 1),
                     "launches_per_step": launches / len(scans)}
    inputs = inputs[-len(scans):]
    out["longest_runs"] = [int(torch.bincount(cell[cell < n2].long(), minlength=n2).max())
                           for cell, _, _, n2 in inputs]
    out["repeated"] = {"device_ms": device_ms(lambda: raster.raster_reduce(*inputs[-1]), 50,
                                              "raster_reduce_kernel")[0]}
    return out


def no_flags(budget):
    """K7's outlier flags as K6 leaves them: all False, of the budget's shape."""
    return torch.zeros(budget.shape, dtype=torch.bool, device=budget.device)


def same_budgets(got, want):
    """K6's outputs bitwise: budget and key everywhere, the directions where
    the budget is positive (K6 writes them nowhere else)."""
    pos = want[0] > 0
    return (bitwise(got[0], want[0]) and bitwise(got[1], want[1])
            and bitwise(got[2][:, pos], want[2][:, pos]))


def check_march(config, driver, rec):
    """K6 and K7 on a warm scan against their plain versions, bitwise, two
    runs bitwise: K6 reading each point's old ground from the moved grid
    against K2's plain gather and the plain budget, K7 walking K6's own
    outputs; K6 also on the scan twice over (262,144 points: the
    exact-budget key) and K7 on its candidates. Times and bounds
    (:func:`budget_cost` of :func:`budget_work`, :func:`march_cost` of
    :func:`march_work`); the occlusion key table, the work K7 folds in,
    timed alone (device ms and launches); both kernels' registers and
    spills (:func:`ptxas_usage`). Returns the two records."""
    from groundgrid_torch.core import outliers
    from groundgrid_torch.core.rasterize import Binning
    from groundgrid_torch.runtime.kernel_timing import device_ms
    from groundgrid_torch.ops import march, select

    x = march_inputs(config, driver, rec)
    scan, s, b = x["scan"], x["s"], x["binning"]
    ground, conf = x["ground"], x["conf"]
    pts = (scan.px, scan.py, scan.pz)
    budget_args = (config, s, b, *pts, ground)
    want6 = (x["budget"], x["key"], x["dirs"])
    if not same_budgets(march.march_budget_plain(*budget_args), want6):
        raise AssertionError("K6's plain route differs from K2's plain gather and the plain "
                             "budget")
    for run in range(2):
        got6 = march.march_budget(*budget_args)
        if not same_budgets(got6, want6) or not bitwise(got6[3], no_flags(x["budget"])):
            raise AssertionError(f"K6 (run {run + 1}) differs from the plain version")
    n_m = (x["budget"] > 0).sum(-1)
    march_args = (config, s, ground, conf, x["pidx"], got6[0], got6[2], n_m)
    want = march.march_plain(config, s, ground, conf, x["pidx"], x["budget"], x["dirs"], n_m,
                             no_flags(x["budget"]))
    for run in range(2):
        got = march.march(*march_args, no_flags(x["budget"]))
        if not bitwise(got, want):
            raise AssertionError(f"K7 (run {run + 1}) differs from the plain version in "
                                 f"{int((got != want).sum())} points")
    # the exact-budget key: the scan twice over
    two = Binning(*(torch.cat([t, t]) for t in b))
    big = [torch.cat([t, t]) for t in pts]
    got = march.march_budget(config, s, two, *big, ground)
    plain = march.march_budget_plain(config, s, two, *big, ground)
    if not same_budgets(got, plain):
        raise AssertionError("K6 on 262,144 points differs from the plain version")
    pidx, n_two = select.select_candidates_plain(plain[0], plain[1],
                                                 config.max_outlier_candidates)
    if not bitwise(march.march(config, s, ground, conf, pidx, got[0], got[2], n_two, got[3]),
                   march.march_plain(config, s, ground, conf, pidx, plain[0], plain[2], n_two,
                                     plain[3])):
        raise AssertionError("K7 on 262,144 points differs from the plain version")

    p, k = scan.px.shape[0], x["pidx"].shape[0]
    reads = budget_work(config, b, scan.pz, ground)
    candidates = reads["candidates"]
    marchable = int((x["budget"] > 0).sum())
    usage = ptxas_usage("march.cu", ("march_budget_kernel", "march_kernel"))
    k6 = {"max_abs_err": 0.0, "library_ms": None, "candidates": candidates,
          "marchable": marchable, "ground_reads": reads["read"],
          "ground_cells": reads["cells"]}
    k6.update(kernel_times(lambda: march.march_budget(*budget_args), 100, "march_budget_kernel",
                           lambda: march.march_budget_plain(*budget_args), 20))
    k6.update(bound(*budget_cost(p, reads, marchable)))
    work = march_work(config, s, ground, conf, x["pidx"], x["budget"], x["dirs"])
    if work["hits"] != int(want.sum()):
        raise AssertionError(f"march_work counts {work['hits']} hits, the march {int(want.sum())}")
    k7 = {"max_abs_err": 0.0, "library_ms": None, **work, "marchable": marchable,
          "candidates": k}
    flags = no_flags(x["budget"])  # K7 sets the same hits on every call
    k7.update(kernel_times(lambda: march.march(*march_args, flags), 100, "march_kernel",
                           lambda: march.march_plain(*march_args, flags), 10))
    k7.update(bound(*march_cost(1, min(marchable, k), work)))
    # the march stage as the step runs it (core/outliers.py detect_outliers
    # with K6, K11 and K7): every device activity in the window is the
    # stage's, 3 a call (no fill of the flags, no comparison after K7; the
    # profiler now and then drops a record, never adds one)
    reps = 50
    stage_ms, stage_acts = device_ms(lambda: outliers.detect_outliers(
        config, s, ground, conf, b, *pts, march.march_budget, select.select_candidates,
        march.march), reps)
    if not 2.9 * reps <= stage_acts <= 3 * reps:
        raise AssertionError(f"the march stage is {stage_acts / reps:g} device activities a "
                             f"call, not K6, K11 and K7")
    k7.update(stage_device_ms=stage_ms, stage_launches=stage_acts / reps)
    # the key table K7 folds in, as the step built it before (every device
    # activity of one call; launches a call)
    table_ms, table_acts = device_ms(lambda: outliers.occlusion_key_table(config, ground, conf),
                                     reps)
    k7.update(key_table_device_ms=table_ms, key_table_launches=table_acts / reps)
    for out, kname in ((k6, "march_budget_kernel"), (k7, "march_kernel")):
        out["registers"], out["spill_store_bytes"], out["spill_load_bytes"] = usage[kname]
    log(f"K6 march_budget: {p} points ({reads['read']} reading the old ground from "
        f"{reads['cells']} distinct cells, {candidates} candidates, {marchable} marchable): "
        f"bitwise the plain route, K2's plain gather and the plain budget (and at {2 * p} "
        f"points, the scan twice over), two runs bitwise; "
        f"device {k6['device_ms']:.4f} ms, call {k6['call_ms']:.4f} ms, plain "
        f"{k6['plain_ms']:.4f} ms, bound {k6['bound_ms']:.5f} ms ({k6['bound_by']}); "
        f"{k6['registers']} registers, spills {k6['spill_store_bytes']} / "
        f"{k6['spill_load_bytes']} bytes")
    log(f"K7 march: {k} candidates ({work['marching']} marching, {work['hits']} hit), "
        f"{work['steps']} steps to evaluate of {work['live_steps']} live, "
        f"{work['ground_cells']} ground and {work['conf_cells']} confidence cells read, "
        f"{work['blocks']} blocks summed: bitwise the plain version (and at {2 * p} points), two "
        f"runs bitwise; device {k7['device_ms']:.4f} ms, call {k7['call_ms']:.4f} ms, plain "
        f"{k7['plain_ms']:.4f} ms, bound {k7['bound_ms']:.5f} ms ({k7['bound_by']}); "
        f"{k7['registers']} registers, spills {k7['spill_store_bytes']} / "
        f"{k7['spill_load_bytes']} bytes; the occlusion key table it folds in: "
        f"{table_ms:.4f} device ms, {table_acts / reps:g} launches a call; the march stage "
        f"(K6, K11, K7) {stage_ms:.4f} device ms, {stage_acts / reps:g} device activities a "
        f"call")
    return k6, k7


SELECT_BYTES_POINT, SELECT_BYTES_KEY, SELECT_BYTES_OUT = 4, 8, 8


def select_cost(budget, key, k):
    """K11's bytes on these inputs, each row: its budgets read once; its keys
    only where a row has more marchable points than ``k`` (the radix
    select); ``k`` indices and the count written."""
    rows = budget.reshape(-1, budget.shape[-1])
    over = int(((rows > 0).sum(-1) > k).sum())
    return (SELECT_BYTES_POINT * rows.numel() + SELECT_BYTES_KEY * over * rows.shape[-1]
            + SELECT_BYTES_OUT * (k + 1) * rows.shape[0])


def overflow_budgets(p, n_pos, seed, device):
    """A storm's (p,) budgets: ``n_pos`` positive (squared ray lengths of 0.2
    to 20 m, rounded to a few values so the cap falls inside tied groups)
    at random slots, the rest 0; and their selection keys."""
    from groundgrid_torch.core import outliers

    rng = np.random.default_rng(seed)
    out = np.zeros(p, np.float32)
    slots = rng.choice(p, n_pos, replace=False)
    out[slots] = (np.round(rng.uniform(0.04, 400.0, n_pos) / 40.0) * 40.0 + 0.5).astype(
        np.float32)
    budget = torch.from_numpy(out).to(device)
    return budget, outliers.selection_key(budget)


def check_select(config, driver, rec):
    """K11 on a warm scan's budgets and keys (the march's inputs, as the step
    builds them), on the scan twice over (262,144 points: the exact-budget
    key), on two storms past the cap (20,000 marchable points at 2^17 and
    2^18: the radix select on both keys, its keys in shared memory) and on
    a tail that crosses from one chunk into the next (2^16 points, 500
    marchable, k = 8,192: the tail spans chunks 0 and 1 of 4,096 points at
    16 blocks): bitwise its plain version (the indices and the marchable
    count), two runs bitwise; batches of 2 and 7 of the scan's rows (each
    row its single launch), each case's cluster shape. Times: the kernel in
    turns against ``torch.topk`` of the same keys (kernel, topk, topk,
    kernel; the library column), the plain version, the bound; registers
    and spills."""
    from groundgrid_torch.core import outliers
    from groundgrid_torch.ops import select
    from groundgrid_torch.runtime.kernel_timing import device_ms

    x = march_inputs(config, driver, rec)
    budget, key = x["budget"], x["key"]
    k = min(config.max_outlier_candidates, budget.shape[-1])
    twice = torch.cat([budget, budget])
    cases = {"scan": (budget, key), "exact_key": (twice, outliers.selection_key(twice)),
             "overflow": overflow_budgets(budget.shape[-1], 20000, 1, budget.device),
             "overflow_exact": overflow_budgets(2 * budget.shape[-1], 20000, 2, budget.device),
             "tail_crossing": overflow_budgets(1 << 16, 500, 3, budget.device)}
    shapes = {}
    for name, (b, kk) in cases.items():
        want = select.select_candidates_plain(b, kk, k)
        for run in range(2):
            got = select.select_candidates(b, kk, k)
            if not (bitwise(got[0], want[0]) and bitwise(got[1], want[1])):
                raise AssertionError(f"K11 ({name}, run {run + 1}) differs from the plain "
                                     f"version")
        shapes[name] = select.cluster_size(b.shape[-1], 1, b.device)
    span = 32 * -(-(1 << 11) // shapes["tail_crossing"])  # a chunk's points at its shape
    if not 500 + span <= k:
        raise AssertionError(f"K11: the tail_crossing case's tail ends inside chunk 0 "
                             f"({span} points)")
    for b in (2, 7):  # the scan's budgets rolled a row, their keys
        rows = torch.stack([budget.roll(37 * v) for v in range(b)])
        rows = (rows, outliers.selection_key(rows))
        got = select.select_candidates(*rows, k)
        want = select.select_candidates_plain(*rows, k)
        if not all(bitwise(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"K11 B = {b} differs from its plain batched version")
        for v in range(b):
            one = select.select_candidates(rows[0][v], rows[1][v], k)
            if not all(bitwise(g[v], o) for g, o in zip(got, one)):
                raise AssertionError(f"K11 B = {b}: row {v} differs from its single launch")
        shapes[f"batch{b}"] = select.cluster_size(budget.shape[-1], b, budget.device)
    if int(select.select_candidates(budget, key, k)[1]) > k:
        raise AssertionError("K11: the warm scan overflows the cap")
    result = {"max_abs_err": 0.0, "marchable": int((budget > 0).sum()), "candidates": k,
              "cluster_shapes": shapes}

    def timed(b, kk):
        def kernel():
            return select.select_candidates(b, kk, k)

        def library():
            return torch.topk(kk, k, dim=-1, sorted=False)

        out = kernel_times(kernel, 100, "select_kernel",
                           lambda: select.select_candidates_plain(b, kk, k), 20)
        # kernel and library in turns (kernel, library, library, kernel)
        lib_runs = [device_ms(library, 100)[0], device_ms(library, 100)[0]]
        dev_runs = [out["device_ms"], kernel_times(kernel, 100, "select_kernel")["device_ms"]]
        out.update(device_ms=sum(dev_runs) / 2, library_ms=sum(lib_runs) / 2,
                   device_turns=dev_runs, library_turns=lib_runs,
                   library_launches=device_ms(library, 20)[1] / 20)
        out.update(bound(select_cost(b, kk, k), 0))
        return out

    for name, (b, kk) in cases.items():
        res = timed(b, kk)
        if name == "scan":
            result.update(res)
        else:
            result.update({f"{name}_{field}": v for field, v in res.items()
                           if field in ("device_ms", "library_ms", "call_ms", "plain_ms",
                                        "bound_ms")})
        log(f"K11 select ({name}, {b.shape[-1]} points, {int((b > 0).sum())} marchable, k = "
            f"{k}): bitwise the plain version, two runs bitwise; device "
            f"{res['device_turns'][0]:.4f} / {res['device_turns'][1]:.4f} ms, torch.topk "
            f"{res['library_turns'][0]:.4f} / {res['library_turns'][1]:.4f} ms "
            f"({res['library_launches']:g} device activities a call) in turns, call "
            f"{res['call_ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, bound "
            f"{res['bound_ms']:.5f} ms ({res['bound_by']})")
    result.pop("device_turns"), result.pop("library_turns")
    usage = ptxas_usage("select.cu", ("select_kernel",))["select_kernel"]
    result["registers"], result["spill_store_bytes"], result["spill_load_bytes"] = usage
    log(f"K11 select: {usage[0]} registers, spills {usage[1]} / {usage[2]} bytes")
    return result



def select_batch(config, driver, records, b=None):
    """K11 on a batch of ``b`` (FLEET_BATCH) warm scans' budgets and keys
    (``records[4:12]`` cycled, as :func:`march_inputs` builds them): one
    launch bitwise the plain batched version and each row its single
    launch; its device ms and bound (``kernel_turns.py`` times each tree's
    K11 so, by this script's probe)."""
    from groundgrid_torch.ops import select
    from groundgrid_torch.runtime.kernel_timing import device_ms

    b = FLEET_BATCH if b is None else b
    rows = [march_inputs(config, driver, rec) for rec in records[4:12]]
    budget = torch.stack([rows[v % len(rows)]["budget"] for v in range(b)])
    key = torch.stack([rows[v % len(rows)]["key"] for v in range(b)])
    k = min(config.max_outlier_candidates, budget.shape[-1])
    got, want = select.select_candidates(budget, key, k), select.select_candidates_plain(
        budget, key, k)
    if not all(bitwise(g, w) for g, w in zip(got, want)):
        raise AssertionError("K11 batched differs from its plain batched version")
    for v in range(min(b, len(rows))):
        one = select.select_candidates(budget[v], key[v], k)
        if not (bitwise(got[0][v], one[0]) and bitwise(got[1][v], one[1])):
            raise AssertionError(f"K11 batched: row {v} differs from its single launch")
    out = {"device_ms": device_ms(lambda: select.select_candidates(budget, key, k), 20,
                                  "select_kernel")[0],
           **bound(select_cost(budget, key, k), 0)}
    if hasattr(select, "cluster_size"):  # a tree whose launch chooses its cluster
        out["cluster"] = select.cluster_size(budget.shape[-1], b, budget.device)
    log(f"K11 select_candidates, B = {b}: bitwise the plain batched version and its single "
        f"launches; device {out['device_ms']:.5f} ms, bound {out['bound_ms']:.5f} ms "
        f"({out['bound_by']}), cluster {out.get('cluster')}")
    return out


def move_batch(config, driver, records, b=None):
    """K12 on a batch of ``b`` (FLEET_BATCH) grids at the main path's size:
    the driver's warm layers, offset a vehicle, each moved by its own warm
    scan's shift (``records[4:12]`` cycled); one launch bitwise the plain
    batched move and each grid its single launch; its device ms and bound
    (``kernel_turns.py`` times each tree's K12 so, by this script's probe)."""
    from groundgrid_torch.core import scalars as scalarlib
    from groundgrid_torch.ops import move
    from groundgrid_torch.runtime.kernel_timing import device_ms

    b = FLEET_BATCH if b is None else b
    packed = [host_packed(config, driver, driver.make_scan(rec)[0]) for rec in records[4:12]]
    sb = torch.from_numpy(np.stack([packed[v % len(packed)] for v in range(b)])).to(
        driver.device)
    offset = torch.arange(b, dtype=torch.float32, device=driver.device)[:, None, None] * 1e-3
    ground = driver.state.ground[None] + offset
    conf = torch.stack([driver.state.groundpatch.roll(v, 0) for v in range(b)])
    rows = [scalarlib.view(sb[v]) for v in range(b)]
    got = move.move(config, ground, conf, scalarlib.view(sb))
    want = move.move_plain(config, ground, conf, scalarlib.view(sb))
    if not all(bitwise(g, w) for g, w in zip(got, want)):
        raise AssertionError("K12 batched differs from the plain batched move")
    for v in range(b):
        one = move.move(config, ground[v], conf[v], rows[v])
        if not all(bitwise(g[v], o) for g, o in zip(got, one)):
            raise AssertionError(f"K12 batched: grid {v} differs from its single launch")
    out = {"device_ms": device_ms(lambda: move.move(config, ground, conf, scalarlib.view(sb)),
                                  20, "move_kernel")[0],
           **bound(sum(move_cost(config, r) for r in rows), 0)}
    log(f"K12 move, B = {b}: bitwise the plain batched move and its single launches; device "
        f"{out['device_ms']:.5f} ms, bound {out['bound_ms']:.5f} ms ({out['bound_by']})")
    return out

K11_CLUSTERS = (1, 2, 4, 8, 16)  # the cluster sizes gg_select takes


def phase_k11_shapes(config, records, device):
    """K11's cluster sizes against each other, each forced through
    ``gg_select``'s ``cluster`` argument: the warm scan's budgets and keys
    as batches of 1, 2, 7 and 64 rows (``records[4:12]`` cycled, as
    :func:`select_batch` builds them) and the storms of :func:`check_select`
    at 2^17 and 2^18 points. Each shape the card places bitwise the plain
    version, then its device ms in turns (the sizes in order, then
    reversed), beside the size the launch's rule takes. Returns the
    record."""
    from groundgrid_torch.ops import _build, select
    from groundgrid_torch.runtime.kernel_timing import device_ms

    driver = warm_driver(config, records, device)
    rows = [march_inputs(config, driver, rec) for rec in records[4:12]]
    k = config.max_outlier_candidates
    p = rows[0]["budget"].shape[-1]
    inputs = {}
    for b in (1, 2, 7, FLEET_BATCH):
        inputs[f"batch{b}"] = (torch.stack([rows[v % len(rows)]["budget"] for v in range(b)]),
                               torch.stack([rows[v % len(rows)]["key"] for v in range(b)]))
    for name, pts, seed in (("storm_2^17", p, 1), ("storm_2^18", 2 * p, 2)):
        inputs[name] = tuple(t[None] for t in overflow_budgets(pts, 20000, seed, device))

    def call(budget, key, cluster):
        pidx = torch.empty((budget.shape[0], k), dtype=torch.int64, device=device)
        n_m = torch.empty(budget.shape[0], dtype=torch.int64, device=device)
        code = _build.launch("gg_select", device, budget.data_ptr(), key.data_ptr(),
                             budget.shape[-1], budget.shape[0], k, cluster, pidx.data_ptr(),
                             n_m.data_ptr())
        return code, pidx, n_m

    out = {}
    for name, (budget, key) in inputs.items():
        want = select.select_candidates_plain(budget, key, k)
        placed = []
        for c in K11_CLUSTERS:
            code, pidx, n_m = call(budget, key, c)
            torch.cuda.synchronize(device)
            if code != 0:
                continue  # the card places no such cluster
            if not (bitwise(pidx, want[0]) and bitwise(n_m, want[1])):
                raise AssertionError(f"K11 {name} at {c} blocks a row differs from the plain "
                                     f"version")
            placed.append(c)
        times = {c: [] for c in placed}
        for c in placed + placed[::-1]:
            times[c].append(device_ms(lambda: call(budget, key, c), 50, "select_kernel")[0])
        out[name] = {"rule": select.cluster_size(budget.shape[-1], budget.shape[0], device),
                     "device_ms": {str(c): v for c, v in times.items()}}
        log(f"K11 shapes, {name} ({budget.shape[0]} x {budget.shape[-1]}): rule "
            f"{out[name]['rule']} blocks a row; device ms in turns "
            + ", ".join(f"{c}: {v[0]:.5f} / {v[1]:.5f}" for c, v in times.items()))
    return out


MOVE_BYTES_KEPT, MOVE_BYTES_CELL = 8, 8  # a kept cell's two words read; two written


def move_cost(config, s):
    """K12's bytes on these scan scalars: both layers written at every cell,
    read at the cells the shift keeps (an exposed cell reads nothing)."""
    from groundgrid_torch.core import grid as gridlib

    n = config.cell_count
    exposed = gridlib.exposed_mask(n, s.k0, s.k1, s.k0.device)
    cells = exposed.numel()
    return MOVE_BYTES_CELL * cells + MOVE_BYTES_KEPT * (cells - int(exposed.sum()))


def check_move(config, driver, rec):
    """K12 on the driver's warm state with scan ``rec``'s scan scalars (the
    step's move), with a large shift (37, -150) and with a wipe (n, n):
    bitwise the plain move (``core/grid.py move``), two runs bitwise, the
    inputs untouched. Times on the warm scan's move; the bound; registers
    and spills. No single PyTorch call computes it (``torch.roll`` moves
    the layers but resets no exposed cell)."""
    from groundgrid_torch.core import scalars as scalarlib
    from groundgrid_torch.ops import move

    scan, _ = driver.make_scan(rec)
    packed = host_packed(config, driver, scan)
    n = config.cell_count
    ground, conf = driver.state.ground.clone(), driver.state.groundpatch.clone()
    cases = {}
    for name, k in (("scan", None), ("large_shift", (37, -150)), ("wipe", (n, n))):
        p = packed.copy()
        if k is not None:
            p.view(np.int32)[scalarlib.K0], p.view(np.int32)[scalarlib.K1] = k
        cases[name] = scalarlib.view(torch.from_numpy(p).to(driver.device))
    for name, s in cases.items():
        want = move.move_plain(config, ground, conf, s)
        for run in range(2):
            got = move.move(config, ground, conf, s)
            if not all(bitwise(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"K12 ({name}, run {run + 1}) differs from the plain move")
        if not (bitwise(ground, driver.state.ground) and bitwise(conf, driver.state.groundpatch)):
            raise AssertionError(f"K12 ({name}) wrote its inputs")
    s = cases["scan"]
    out = {"max_abs_err": 0.0, "library_ms": None, "shift": [int(s.k0), int(s.k1)]}
    out.update(kernel_times(lambda: move.move(config, ground, conf, s), 100, "move_kernel",
                            lambda: move.move_plain(config, ground, conf, s), 20))
    out.update(bound(move_cost(config, s), 0))
    wipe = kernel_times(lambda: move.move(config, ground, conf, cases["wipe"]), 100,
                        "move_kernel")
    out["wipe_device_ms"] = wipe["device_ms"]
    high = move_highres(config, driver, records=[rec])
    out["device_ms_highres"], out["bound_ms_highres"] = high["device_ms"], high["bound_ms"]
    usage = ptxas_usage("move.cu", ("move_kernel",))["move_kernel"]
    out["registers"], out["spill_store_bytes"], out["spill_load_bytes"] = usage
    log(f"K12 move: the warm scan's shift {out['shift']}, a large shift (37, -150) and a wipe "
        f"({n}, {n}) bitwise the plain move, two runs bitwise, inputs untouched; device "
        f"{out['device_ms']:.4f} ms (the wipe {wipe['device_ms']:.4f}; 1200^2, also bitwise "
        f"on both shifts, {out['device_ms_highres']:.4f} against a bound of "
        f"{out['bound_ms_highres']:.5f}), call {out['call_ms']:.4f} ms, plain "
        f"{out['plain_ms']:.4f} ms, bound {out['bound_ms']:.5f} ms ({out['bound_by']}); "
        f"{usage[0]} registers, spills "
        f"{usage[1]} / {usage[2]} bytes")
    return out

def move_highres(config, driver, records):
    """K12 at 1200^2 (``HIGHRES_CONFIG``'s grid): seeded layers moved by the
    warm scan ``records[-1]``'s shift and plane, and by (37, -150), whose
    columns take two runs of a row (k1 % 4 != 0): bitwise the plain move;
    the device ms and bound of the warm shift (the layers, 23 MB, stay in
    the 50 MB L2 between the timed calls). ``kernel_turns.py`` times each
    tree's K12 so, by this script's probe."""
    from groundgrid_torch.config import HIGHRES_CONFIG
    from groundgrid_torch.core import scalars as scalarlib
    from groundgrid_torch.ops import move

    high = HIGHRES_CONFIG
    packed = host_packed(config, driver, driver.make_scan(records[-1])[0])
    rng = np.random.default_rng(1200)
    n = high.cell_count
    g = torch.from_numpy(rng.normal(-1.7, 0.4, (n, n)).astype(np.float32)).to(driver.device)
    c = torch.from_numpy(rng.uniform(0.0, 1.0, (n, n)).astype(np.float32)).to(driver.device)
    shifts = {}
    for name, k in (("scan", None), ("large_shift", (37, -150))):
        q = packed.copy()
        if k is not None:
            q.view(np.int32)[scalarlib.K0], q.view(np.int32)[scalarlib.K1] = k
        shifts[name] = scalarlib.view(torch.from_numpy(q).to(driver.device))
        want = move.move_plain(high, g, c, shifts[name])
        if not all(bitwise(x, w) for x, w in zip(move.move(high, g, c, shifts[name]), want)):
            raise AssertionError(f"K12 at {n}^2 ({name}) differs from the plain move")
    out = {"device_ms": kernel_times(lambda: move.move(high, g, c, shifts["scan"]), 100,
                                     "move_kernel")["device_ms"],
           **bound(move_cost(high, shifts["scan"]), 0)}
    log(f"K12 move at {n}^2: the warm scan's shift and (37, -150) bitwise the plain move; "
        f"device {out['device_ms']:.5f} ms, bound {out['bound_ms']:.5f} ms ({out['bound_by']})")
    return out


def batched_inputs(config, driver, records, b):
    """Phase 2's batch of ``b`` vehicles at the main path's shapes: the
    prepared scans of ``records`` (cycled) against the driver's warm state,
    and its layers made distinct a vehicle (heights offset, confidence
    rolled, base heights spread), so that a kernel reading another
    vehicle's data shows. Returns a dict of stacked inputs."""
    from groundgrid_torch.core import grid as gridlib
    from groundgrid_torch.core import rasterize as rasterlib
    from groundgrid_torch.ops import raster

    per_scan = []
    for rec in records:
        scan, s, binning, accept = prepared(config, driver, rec)
        cols, ops = rasterlib.raster_columns(config, binning, scan.pz, accept, s)
        layers = rasterlib.rasterize_sorted(config, binning, scan.pz, accept, s,
                                            raster.raster_reduce)
        moved = gridlib.move(config, driver.state.ground, driver.state.groundpatch, s)
        per_scan.append((binning.cell, cols, (layers.points, layers.variance,
                                              layers.min_ground_height, *moved), s.base_z,
                         (scan.px, scan.py, scan.pz, scan.rings, scan.valid > 0),
                         host_packed(config, driver, scan)))
    pick = [per_scan[v % len(per_scan)] for v in range(b)]
    offset = torch.arange(b, dtype=torch.float32, device=driver.device)[:, None, None] * 1e-3
    ground, conf = driver.state.ground, driver.state.groundpatch
    return {
        "cell": torch.stack([p[0] for p in pick]),
        "cols": [torch.stack([p[1][j] for p in pick]) for j in range(len(ops))],
        "ops": ops,
        "ground": ground[None] + offset,
        "conf": torch.stack([conf.roll(v, 0) for v in range(b)]),
        "base_z": torch.stack([p[3] for p in pick]) + offset[:, 0, 0] * 10.0,
        "detect": [torch.stack([p[2][j] for p in pick]) + (offset if j == 3 else 0.0)
                   for j in range(5)],
        "points": [torch.stack([p[4][j] for p in pick]) for j in range(5)],
        "scalars": torch.from_numpy(np.stack([p[5] for p in pick])).to(driver.device),
    }


def batched_times(name, batched, singles, plain, kname, b, n_bytes, n_flops, reps=20):
    """The batched launch's device ms (its kernel's own time per call), the
    ``b`` single launches' device ms together and both calls' CUDA-event
    ms, one plain batched call's ms, and the bound of the batch's work."""
    from groundgrid_torch.runtime.kernel_timing import device_ms, event_ms

    out = {"device_ms": device_ms(batched, reps, kname)[0],
           "singles_device_ms": device_ms(singles, max(2, reps // 10), kname, per_call=b)[0],
           "call_ms": event_ms(batched, reps),
           "singles_call_ms": event_ms(singles, max(2, reps // 10)),
           "plain_ms": event_ms(plain, 1)}
    out.update(bound(n_bytes, n_flops))
    log(f"{name} batched, B = {b}: one launch {out['device_ms']:.4f} device ms (call "
        f"{out['call_ms']:.4f} ms) against {b} single launches {out['singles_device_ms']:.4f} "
        f"device ms (calls {out['singles_call_ms']:.4f} ms); plain batched "
        f"{out['plain_ms']:.1f} ms; bound {out['bound_ms']:.4f} ms ({out['bound_by']})")
    return out


def check_batched(config, driver, records, b=None):
    """Phase 2's batched kernels, the unsorted fleet's launches: K1, K2 (the
    points' two tables, and one table over the march lattice), K3, K4 and
    K8 on a batch of ``b`` (FLEET_BATCH) vehicles at the main path's
    shapes, each bitwise its ``b`` single launches and against its plain
    batched version (K1, K2, K4, K8 bitwise; K3 confidence bitwise, heights
    atol 2e-5 / rtol 1e-5); timed against the single launches
    (``batched_times``)."""
    from groundgrid_torch.core import detect as detectlib
    from groundgrid_torch.ops import detect, lookup, raster, spiral

    b = FLEET_BATCH if b is None else b
    x = batched_inputs(config, driver, records, b)
    n, n2, m = config.cell_count, config.cell_count ** 2, config.center_cell
    cell, cols, ops = x["cell"], x["cols"], x["ops"]
    out = {}

    # K1: 7 columns of b prepared scans
    got = raster.raster_reduce(cell, cols, ops, n2)
    want = raster.raster_reduce_plain(cell, cols, ops, n2)
    for v in range(b):
        single = raster.raster_reduce(cell[v], [c[v] for c in cols], ops, n2)
        if not all(bitwise(g[v], w) for g, w in zip(got, single)):
            raise AssertionError(f"K1 batched: vehicle {v} differs from its single launch")
    if not all(bitwise(g, w) for g, w in zip(got, want)):
        raise AssertionError("K1 batched differs from its plain batched version")
    real = int((cell < n2).sum())
    out["raster"] = dict(max_abs_err=0.0, **batched_times(
        "K1 raster_reduce", lambda: raster.raster_reduce(cell, cols, ops, n2),
        lambda: [raster.raster_reduce(cell[v], [c[v] for c in cols], ops, n2)
                 for v in range(b)],
        lambda: raster.raster_reduce_plain(cell, cols, ops, n2), "raster_reduce_kernel", b,
        cell.nbytes + 4 * len(cols) * real + 4 * len(cols) * n2 * b, len(cols) * real))

    # K2: the points' two tables, and one table over the march lattice
    tables = [x["ground"], x["conf"]]
    lattice = march_lattice(config, driver, records[0])[0]
    lat = lattice[None].expand(b, -1).contiguous()
    cases = (("points, 2 tables", cell, tables), ("march lattice, 1 table", lat, tables[1:]))
    for name, ids, tabs in cases:
        got = lookup.lookup(ids, tabs, n2)
        want = lookup.lookup_plain(ids, tabs, n2)
        for v in range(b):
            single = lookup.lookup(ids[v], [t[v] for t in tabs], n2)
            if not all(bitwise(g[v], w) for g, w in zip(got, single)):
                raise AssertionError(f"K2 batched ({name}): vehicle {v} differs from its single "
                                     f"launch")
        if not all(bitwise(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"K2 batched ({name}) differs from its plain batched version")
    touched = sum(int(torch.unique(cell[v][cell[v] < n2]).numel()) for v in range(b))
    out["lookup"] = dict(max_abs_err=0.0, **batched_times(
        "K2 lookup (points, 2 tables)", lambda: lookup.lookup(cell, tables, n2),
        lambda: [lookup.lookup(cell[v], [t[v] for t in tables], n2) for v in range(b)],
        lambda: lookup.lookup_plain(cell, tables, n2), "lookup_kernel", b,
        cell.nbytes + 2 * 4 * touched + 2 * 4 * cell.numel(), 0, reps=50))
    lat_touched = b * int(torch.unique(lattice[lattice < n2]).numel())
    march = batched_times(
        "K2 lookup (march lattice, 1 table)", lambda: lookup.lookup(lat, tables[1:], n2),
        lambda: [lookup.lookup(lat[v], [tables[1][v]], n2) for v in range(b)],
        lambda: lookup.lookup_plain(lat, tables[1:], n2), "lookup_kernel", b,
        lat.nbytes + 4 * lat_touched + 4 * lat.numel(), 0)
    out["lookup"].update({"march_" + k: v for k, v in march.items()})

    # K3: b warm grids, one block each
    ground, conf, base_z = x["ground"], x["conf"], x["base_z"]
    g_k, c_k = spiral.spiral_interpolation(config, ground.clone(), conf.clone(), base_z)
    g_p, c_p = spiral.spiral_interpolation_plain(config, ground.clone(), conf.clone(), base_z)
    for v in range(b):
        single = spiral.spiral_interpolation(config, ground[v].clone(), conf[v].clone(),
                                             base_z[v])
        if not (bitwise(g_k[v], single[0]) and bitwise(c_k[v], single[1])):
            raise AssertionError(f"K3 batched: grid {v} differs from its single launch")
    if not torch.equal(c_k, c_p):
        raise AssertionError(f"K3 batched confidence differs from its plain version in "
                             f"{int((c_k != c_p).sum())} cells")
    if not torch.allclose(g_k, g_p, atol=2e-5, rtol=1e-5):
        raise AssertionError(f"K3 batched heights beyond atol 2e-5 / rtol 1e-5: max "
                             f"{float((g_k - g_p).abs().max())}")
    h, c = ground.clone(), conf.clone()
    visits = (m - 1) * (4 * m + 2) + 1
    out["spiral"] = dict(max_abs_err=float((g_k - g_p).abs().max()), **batched_times(
        "K3 spiral_interpolation", lambda: spiral.spiral_interpolation(config, h, c, base_z),
        lambda: [spiral.spiral_interpolation(config, h[v], c[v], base_z[v]) for v in range(b)],
        lambda: spiral.spiral_interpolation_plain(config, h, c, base_z), "spiral_kernel", b,
        b * 2 * 4 * ((2 * m + 1) ** 2 + (2 * m - 1) ** 2), b * 55 * visits, reps=10))

    # K4: b scans' warm raster layers
    tabs = detectlib.make_tables(config, driver.device)
    layers = x["detect"]
    got = detect.detect_fused(config, tabs, *layers)
    want = detect.detect_fused_plain(config, tabs, *layers)
    for v in range(b):
        single = detect.detect_fused(config, tabs, *(t[v] for t in layers))
        if not all(bitwise(g[v], w) for g, w in zip(got, single)):
            raise AssertionError(f"K4 batched: grid {v} differs from its single launch")
    if not all(bitwise(g, w) for g, w in zip(got, want)):
        raise AssertionError("K4 batched differs from its plain batched version")
    out["detect"] = dict(max_abs_err=0.0, **batched_times(
        "K4 detect_fused", lambda: detect.detect_fused(config, tabs, *layers),
        lambda: [detect.detect_fused(config, tabs, *(t[v] for t in layers)) for v in range(b)],
        lambda: detect.detect_fused_plain(config, tabs, *layers), "detect_kernel", b,
        *detect_cost(tabs, layers, interior=False)))

    # K8: the same layers through the main path's stage
    out["detect_stage"] = stage_batch(config, driver, records, b, layers)
    out.update(check_batched_fused(config, x, b))
    log(f"batched kernels, B = {b} at {n}^2: K1, K2 (points and march lattice), K3, K4, K8, "
        f"K5, K6, K11, K7, K9, K10 and K12 each bitwise its {b} single launches and against "
        f"its plain batched version")
    return out


def check_batched_fused(config, x, b):
    """K5, K6, K11, K7, K9, K10 and K12 on the batch of :func:`batched_inputs`
    (each vehicle its scan, scan scalars and moved layers; K11 over K6's
    budgets and keys; K9 through the stable sort's order of K5's ids, with
    K7's outlier flags; K10 over K1's columns, the main path's three
    layers; K12 moving each vehicle's grid), each bitwise its ``b`` single
    launches and its plain batched version; timed against the single
    launches (``batched_times``)."""
    from groundgrid_torch.core import scalars as scalarlib
    from groundgrid_torch.core.rasterize import COLUMN_OPS, MAIN_LAYERS, Binning
    from groundgrid_torch.ops import binning, march, move, raster, raster_stage, select

    sb = scalarlib.view(x["scalars"])
    rows = [scalarlib.view(x["scalars"][v]) for v in range(b)]
    px, py, pz, rings, valid = x["points"]
    ground, conf = x["detect"][3], x["detect"][4]
    p, out = px.shape[-1], {}

    def row(t, v):
        return Binning(*(f[v] for f in t)) if isinstance(t, Binning) else t[v]

    def check(name, got, want, single):
        got, want = (got,) if isinstance(got, torch.Tensor) else got, (
            (want,) if isinstance(want, torch.Tensor) else want)
        if not all(bitwise(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"{name} batched differs from its plain batched version")
        for v in range(b):
            s1 = single(v)
            s1 = (s1,) if isinstance(s1, torch.Tensor) else s1
            if not all(bitwise(g[v], w) for g, w in zip(got, s1)):
                raise AssertionError(f"{name} batched: vehicle {v} differs from its single launch")

    bin_args = (config, sb, px, py, rings, valid)
    bins = binning.bin_points(*bin_args)
    check("K5", bins, binning.bin_points_plain(*bin_args),
          lambda v: binning.bin_points(config, rows[v], px[v], py[v], rings[v], valid[v]))
    out["bin"] = dict(max_abs_err=0.0, **batched_times(
        "K5 bin_points", lambda: binning.bin_points(*bin_args),
        lambda: [binning.bin_points(config, rows[v], px[v], py[v], rings[v], valid[v])
                 for v in range(b)],
        lambda: binning.bin_points_plain(*bin_args), "binning_kernel", b, 31 * p * b,
        BIN_FLOPS * p * b))

    budget_args = (config, sb, bins, px, py, pz, ground)
    budget, key, dirs, flags6 = march.march_budget(*budget_args)
    plain6 = march.march_budget_plain(*budget_args)
    if not same_budgets((budget, key, dirs), plain6) or not bitwise(flags6, plain6[3]):
        raise AssertionError("K6 batched differs from its plain batched version")
    for v in range(b):
        single = march.march_budget(config, rows[v], row(bins, v), px[v], py[v], pz[v],
                                    ground[v])
        if not same_budgets((budget[v], key[v], dirs[:, v]), single):
            raise AssertionError(f"K6 batched: vehicle {v} differs from its single launch")
    out["march_budget"] = dict(max_abs_err=0.0, **batched_times(
        "K6 march_budget", lambda: march.march_budget(*budget_args),
        lambda: [march.march_budget(config, rows[v], row(bins, v), px[v], py[v], pz[v],
                                    ground[v]) for v in range(b)],
        lambda: march.march_budget_plain(*budget_args), "march_budget_kernel", b,
        *budget_cost(p * b, budget_work(config, bins, pz, ground), int((budget > 0).sum()))))

    k = min(config.max_outlier_candidates, p)
    sel_args = (budget, key, k)
    pidx, n_m = select.select_candidates(*sel_args)
    check("K11", select.select_candidates(*sel_args), select.select_candidates_plain(*sel_args),
          lambda v: select.select_candidates(budget[v], key[v], k))
    out["select"] = dict(max_abs_err=0.0, **batched_times(
        "K11 select_candidates", lambda: select.select_candidates(*sel_args),
        lambda: [select.select_candidates(budget[v], key[v], k) for v in range(b)],
        lambda: select.select_candidates_plain(*sel_args), "select_kernel", b,
        select_cost(budget, key, k), 0))
    march_args = (config, sb, ground, conf, pidx, budget, dirs, n_m)

    def single_march(v):
        return march.march(config, rows[v], ground[v], conf[v], pidx[v], budget[v], dirs[:, v],
                           n_m[v], no_flags(budget[v]))

    want = march.march_plain(config, sb, ground, conf, pidx, plain6[0], plain6[2], n_m,
                             no_flags(budget))
    check("K7", march.march(*march_args, no_flags(budget)), want, single_march)
    flags = no_flags(budget)  # K7 sets the same hits on every call
    work = [march_work(config, rows[v], ground[v], conf[v], pidx[v], plain6[0][v],
                       plain6[2][:, v]) for v in range(b)]
    total = {key_: sum(w[key_] for w in work) for key_ in work[0]}
    out["march"] = dict(max_abs_err=0.0, steps=total["steps"], **batched_times(
        "K7 march", lambda: march.march(*march_args, flags),
        lambda: [single_march(v) for v in range(b)],
        lambda: march.march_plain(*march_args, flags), "march_kernel", b,
        *march_cost(b, int(torch.clamp(n_m, max=k).sum()), total)))

    # K9 and K10: the batch's raster stage around K1, through the stable
    # sort's order, the main path's three layers
    outlier = march.march(*march_args, no_flags(budget))
    order = torch.argsort(bins.cell, dim=-1, stable=True)
    col_args = (config, bins, pz, outlier, sb, order)

    def single_columns(v):
        cell_v, cols_v = raster_stage.raster_columns_ordered(config, row(bins, v), pz[v],
                                                              outlier[v], rows[v], order[v])
        return (cell_v, *cols_v)

    cell, cols = raster_stage.raster_columns_ordered(*col_args)
    check("K9", (cell, *cols), (lambda c: (c[0], *c[1]))(
        raster_stage.raster_columns_ordered_plain(*col_args)), single_columns)
    out["raster_columns"] = dict(max_abs_err=0.0, **batched_times(
        "K9 raster_columns_ordered", lambda: raster_stage.raster_columns_ordered(*col_args),
        lambda: [single_columns(v) for v in range(b)],
        lambda: raster_stage.raster_columns_ordered_plain(*col_args), "raster_columns_kernel",
        b, COLUMNS_BYTES * p * b, COLUMNS_FLOPS * int((cols[1] > 0).sum())))
    n2 = config.cell_count ** 2
    part = raster.raster_reduce(cell, cols, COLUMN_OPS, n2)

    def finish(fn, s, parts):
        layers = fn(config, [parts], s)
        return tuple(getattr(layers, name) for name in MAIN_LAYERS)

    check("K10", finish(raster_stage.finish_layers, sb, part),
          finish(raster_stage.finish_layers_plain, sb, part),
          lambda v: finish(raster_stage.finish_layers, rows[v], [c[v] for c in part]))
    out["raster_finish"] = dict(max_abs_err=0.0, **batched_times(
        "K10 finish_layers", lambda: finish(raster_stage.finish_layers, sb, part),
        lambda: [finish(raster_stage.finish_layers, rows[v], [c[v] for c in part])
                 for v in range(b)],
        lambda: finish(raster_stage.finish_layers_plain, sb, part), "raster_finish_kernel", b,
        (FINISH_BYTES + FINISH_LAYER_BYTES * len(MAIN_LAYERS)) * n2 * b, FINISH_FLOPS * n2 * b))

    # K12: the batch's grids (before the move) moved by each vehicle's shift
    move_args = (config, x["ground"], x["conf"], sb)
    check("K12", move.move(*move_args), move.move_plain(*move_args),
          lambda v: move.move(config, x["ground"][v], x["conf"][v], rows[v]))
    out["move"] = dict(max_abs_err=0.0, **batched_times(
        "K12 move", lambda: move.move(*move_args),
        lambda: [move.move(config, x["ground"][v], x["conf"][v], rows[v]) for v in range(b)],
        lambda: move.move_plain(*move_args), "move_kernel", b,
        sum(move_cost(config, rows[v]) for v in range(b)), 0))
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


def path_launches(steps, raster=None, detect=0):
    """The main path's launches over ``steps`` steps (or shards, or batched
    steps): K1 (``raster``: twice a step with the aux count), K2 (ground and
    variance for classify; K6 reads the old ground itself), K3, K5, K6, K7,
    K9, K10, K11 and K12 x1 (the march stage's three launches: K6, K11 and
    K7, :func:`check_march` checking under the profiler that it launches
    nothing else), K4 ``detect`` (the fused detect, ``steps`` or 0) and K8
    the other steps."""
    return {"raster": steps if raster is None else raster, "lookup": steps, "spiral": steps,
            "detect": detect, "bin": steps, "march_budget": steps, "march": steps,
            "detect_stage": steps - detect, "raster_columns": steps, "raster_finish": steps,
            "select": steps, "move": steps}


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
    check_launches(counts, path_launches(n), driver, "main path")
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
    check_launches(counts, path_launches(n, raster=2 * n, detect=n), driver, "layers path")
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
    check_launches(counts, path_launches(n, raster=2 * n, detect=n), driver,
                   f"layers path at {config.cell_count}^2")
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
    want = path_launches(n_scans, raster=raster_per_scan * n_scans)
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
        f"K1 x1 (x2 playback), K2, K3, K5-K12 x1; 0 fallbacks; loaders native; "
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
    check_launches(counts, path_launches(n), driver, "unsorted path")
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
    check_launches(counts, path_launches(n), driver, "128-beam path")
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
    want = dict(path_launches(b), spiral_band=b, spiral_global=0)
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
    if any(path_counts().values()):
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

@contextlib.contextmanager
def fleet_branch(batched: bool):
    """The fleet bench's fleets on one branch whatever their config:
    ``batched`` one batched step a device, else one captured single step
    replayed per vehicle (the two sides of phase 9's turns)."""
    from groundgrid_torch.runtime import bench

    made = bench.make_fleet_step

    def make(config, mesh):
        fleet = made(config, mesh)
        fleet.batched = batched
        return fleet

    bench.make_fleet_step = make
    try:
        yield
    finally:
        bench.make_fleet_step = made


def fleet_turns(config, records, device, order):
    """``bench --batch``'s device ms a tick (scans prepared once) of the
    fleet of FLEET_BATCH on ``config``, one run per entry of ``order``
    (True: batched, False: per vehicle), in that order."""
    from groundgrid_torch.runtime import bench

    turns = []
    for batched in order:
        with fleet_branch(batched):
            res = bench.run_fleet_benchmark(config, records[:8], FLEET_BATCH, 2 * FLEET_BATCH,
                                            3, device)
        if res["batched"] != batched or res["fallbacks"]:
            raise AssertionError(f"fleet bench: branch {res['batched']}, fallbacks "
                                 f"{res['fallbacks']}")
        turns.append({k: res[k] for k in ("batched", "device_ms_per_tick", "device_ms_per_scan",
                                          "wall_ms_per_tick")})
    return turns


def profile_fleet(config, records, device, n_ticks=3):
    """Device busy ms a tick of the fleet bench's warm ticks under
    ``torch.profiler``, its share of the ticks' CUDA-event span, and the
    heaviest kernels by device time."""
    from groundgrid_torch.runtime import bench
    from groundgrid_torch.runtime.kernel_timing import device_us, profiled

    mesh, states, scans = bench.fleet_inputs(config, records[:8], FLEET_BATCH, device)
    fleet = bench.make_fleet_step(config, mesh)
    for _ in range(3):
        states, _, _ = fleet(states, scans)
    torch.cuda.synchronize(device)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with profiled() as prof:
        start.record()
        for _ in range(n_ticks):
            states, _, _ = fleet(states, scans)
        end.record()
        torch.cuda.synchronize(device)
    busy_us, activities = device_us(prof)
    busy_ms, span_ms = busy_us / 1000.0 / n_ticks, start.elapsed_time(end) / n_ticks
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=12)
    log(f"{table}\nfleet of {FLEET_BATCH} ({'batched' if fleet.batched else 'per vehicle'}): "
        f"device busy {busy_ms:.4f} ms a tick ({activities / n_ticks:.1f} device activities a "
        f"tick) over {n_ticks} warm ticks; span {span_ms:.4f} ms a tick (profiler on): busy "
        f"share {busy_ms / span_ms:.4f}")
    return {"busy_ms_per_tick": busy_ms, "span_ms_per_tick": span_ms,
            "activities_per_tick": activities / n_ticks}


def phase_fleet_unsorted(records, device):
    """Phase 9, unsorted: the default config's fleet of FLEET_BATCH vehicles,
    one batched step captured as one graph a tick (the JAX fleet's
    ``jax.vmap`` branch)."""
    from groundgrid_torch.config import GroundGridConfig
    from groundgrid_torch.ops import reset_launch_counts
    from groundgrid_torch.runtime.fleet import FleetDriver

    config = GroundGridConfig()
    b = FLEET_BATCH
    streams = fleet_streams(records, b, FLEET_TICKS)
    fleet = FleetDriver(config, batch=b, device=device)
    if not fleet.step.batched:
        raise AssertionError("the unsorted fleet does not take the batched step")
    ticks, tick_ms, total = [], [], {}
    want = dict(path_launches(1), spiral_band=1, spiral_global=0)
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
        ticks.append(fleet.fetch(tok))
        end.record()
        end.synchronize()
        tick_ms.append(start.elapsed_time(end))
        if counts != want:
            raise AssertionError(f"unsorted fleet tick {k + 1}: launches {counts} (want {want})")
        total = {key: total.get(key, 0) + v for key, v in counts.items()}
        check_summary(ticks[-1], f"unsorted fleet tick {k + 1}")
    step = fleet.step.steps[0]
    if not step.captured:
        raise AssertionError("the unsorted fleet's batched step was not captured")
    capture = {"capture_s": step.capture_seconds, "pool_bytes": step.pool_bytes}
    log(f"unsorted fleet of {b}, {FLEET_TICKS} ticks, batched: launches per tick {want}; "
        f"ticks 2-{FLEET_TICKS} under the sync check; ms per tick (CUDA events, host prep and "
        f"fetch included) {', '.join(f'{t:.1f}' for t in tick_ms)}; one graph a tick, capture "
        f"{capture['capture_s']:.3f} s, pool {capture['pool_bytes']} bytes "
        f"({capture['pool_bytes'] / 2 ** 30:.2f} GiB)")

    # the reference: b single captured unsorted steps, one replayed per vehicle
    ref = FleetDriver(config, batch=b, device=device)
    ref.step.batched = False
    reset_launch_counts()
    for k in range(FLEET_TICKS):
        tick = ref.process([s[k] for s in streams])
        if not (np.array_equal(tick.labels, ticks[k].labels)
                and np.array_equal(tick.outlier, ticks[k].outlier)):
            raise AssertionError(f"unsorted fleet tick {k + 1}: batched not bitwise {b} single "
                                 f"captured steps")
    if path_counts()["spiral"] != b * FLEET_TICKS:
        raise AssertionError("the per-vehicle fleet did not replay a step per vehicle")
    for got, want_block in zip(fleet.states, ref.states):
        for a, c in ((got.ground, want_block.ground), (got.groundpatch, want_block.groundpatch),
                     (got.center, want_block.center), (got.center_lo, want_block.center_lo)):
            if not bitwise(a, c):
                raise AssertionError("unsorted fleet: the batched state differs from the "
                                     "single steps'")
    log(f"unsorted fleet: labels, outliers and the final state of all {b} vehicles bitwise "
        f"{b} single captured unsorted steps (one replayed per vehicle) over the same streams")
    del fleet, ref

    # device ms a tick (bench --batch's measure, scans prepared once), in
    # turns: batched, per vehicle, per vehicle, batched; then the sorted
    # config on both branches (per vehicle, batched, batched, per vehicle);
    # then a profile of the batched tick
    turns = fleet_turns(config, records, device, (True, False, False, True))
    sorted_turns = fleet_turns(dataclasses.replace(config, sorted_scans=True), records, device,
                               (False, True, True, False))
    out = {"ms_per_tick": tick_ms, **capture, "turns": turns, "sorted_turns": sorted_turns,
           "profile": profile_fleet(config, records, device)}
    for name, ts in (("unsorted", turns), ("sorted", sorted_turns)):
        log(f"{name} fleet of {b}, device ms a tick in turns "
            f"({', '.join('batched' if t['batched'] else 'per vehicle' for t in ts)}): "
            f"{', '.join(str(t['device_ms_per_tick']) for t in ts)}; wall ms a tick "
            f"{', '.join(str(t['wall_ms_per_tick']) for t in ts)}")
    return total, out


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
    per_scan = dict(path_launches(n_shards), spiral_band=n_shards, spiral_global=0)
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
    log(f"{name}, {n} scans: launches per scan K1, K2, K3, K5-K12 x{n_shards} in both spiral "
        f"modes; steps 2-{n} under the sync check; banded == "
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
                        f"on one card, launches per scan K1, K2, K3 x1 a rank; rank 0's "
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

    # (e') the device busy share of 8 warm steps (``bench --profile``), in
    # turns; each run also profiles the eager step stage by stage
    busy, stages = [], []
    for eager in (True, False, False, True):
        with eager_steps() if eager else contextlib.nullcontext():
            lines = bench.profile_steps(device=device).splitlines()
        busy.append(lines[-1])
        stages.append([line for line in lines
                       if line.startswith(("eager step", "  stage", "  outside"))])
    out["profile"], out["stages"] = busy, stages
    for name, line in zip(("eager", "captured", "captured", "eager"), busy):
        log(f"phase 11 bench --profile ({name}): {line}")
    log("phase 11 bench --profile, the eager step by stage (the first and the last run):\n"
        + "\n".join(stages[0]) + "\n" + "\n".join(stages[-1]))

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

    if sys.argv[1:] == ["--k8-tiles"]:  # phase 1 and K8's tile candidates alone
        print(json.dumps({"k8_tiles": phase_k8_tiles(config, records, device)}))
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                 "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
        return 0
    if sys.argv[1:] == ["--k5-variants"]:  # phase 1 and K5's candidates alone
        print(json.dumps({"k5_variants": phase_k5_variants(config, records, device)}))
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                 "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
        return 0
    if sys.argv[1:] == ["--k11-shapes"]:  # phase 1 and K11's cluster sizes alone
        print(json.dumps({"k11_shapes": phase_k11_shapes(config, records, device)}))
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                 "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
        return 0
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
    k8 = check_detect_stage(config, driver, records[4], records)
    k5 = check_binning(config, driver, records[4])
    k9, k10, _ = check_raster_stage(config, driver, records[4])
    k6, k7 = check_march(config, driver, records[4])
    k11 = check_select(config, driver, records[4])
    k12 = check_move(config, driver, records[4])
    batched = check_batched(config, driver, records[4:12])
    del driver
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
    unsorted_fleet_counts, _ = phase_fleet_unsorted(records, device)
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
        # XLA's fusions of the JAX step's binning and march (no Pallas kernel)
        ("bin_points", "binning.cu", "groundgrid_tpu/core/rasterize.py:92", "bin", k5, counts),
        ("march_budget", "march.cu", "groundgrid_tpu/core/outliers.py:116", "march_budget", k6,
         counts),
        ("march", "march.cu", "groundgrid_tpu/core/outliers.py:116", "march", k7, counts),
        # and of its non-fused detect stage
        ("detect_ground_patches", "detect_stage.cu", "groundgrid_tpu/core/detect.py:93",
         "detect_stage", k8, counts),
        # and of its raster stage around the Pallas kernel
        ("raster_columns_ordered", "raster_stage.cu", "groundgrid_tpu/core/rasterize.py:312",
         "raster_columns", k9, counts),
        ("finish_layers", "raster_stage.cu", "groundgrid_tpu/core/rasterize.py:409",
         "raster_finish", k10, counts),
        # and of its candidate selection and grid move
        ("select_candidates", "select.cu", "groundgrid_tpu/core/outliers.py:228", "select", k11,
         counts),
        ("move", "move.cu", "groundgrid_tpu/core/grid.py:143", "move", k12, counts),
    ):
        kernels.append({
            "name": name, "route": "cuda", "source": f"groundgrid_torch/csrc/{route_file}",
            "replaces": replaces, "launches": launches[key],
            "launches_unsorted": unsorted_counts[key], "launches_topk": topk_counts[key],
            "launches_fleet": fleet_counts[key], "launches_spatial": spatial_counts[key],
            "launches_fleet_unsorted": unsorted_fleet_counts[key],
            **{f"batched{FLEET_BATCH}_{k}": v
               for k, v in batched.get(key.replace("_band", ""), {}).items()
               if key != "spiral_global"},
            "max_abs_err": res["max_abs_err"],
            "ms": res["device_ms"], "device_ms": res["device_ms"],
            "wrapper_device_ms": res["wrapper_device_ms"], "call_ms": res["call_ms"],
            "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"], "library_ms": res["library_ms"],
            **{k: v for k, v in res.items()
               if k.endswith(("_highres", "_364", "_1200", "_2416")) or k in EXTRA_KEYS
               or k.startswith(EXTRA_PREFIXES)},
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
