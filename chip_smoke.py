"""GPU smoke test of the PyTorch port: builds and checks its CUDA kernels,
then drives the sorted-scan streaming path and the layer-publishing wire
path on one card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero, printing no result):

1. Environment: torch and CUDA versions, the card's name and power limit,
   the kernels' build time (nvcc, from ``groundgrid_torch/csrc``).
2. Each kernel against its plain PyTorch version on the same CUDA tensors,
   at the main paths' shapes (364^2 grid, 131072-point buffer):
   K1 raster (7 columns of a prepared scan: counts, sums, min and max all
   bitwise, the plain version folding each run in the kernel's order), K2
   lookup (sorted point cells with 1 and 2 tables, an unsorted
   lattice-sized cell vector: bitwise), K3 spiral (a warm state:
   confidence bitwise, heights atol 2e-5 / rtol 1e-5), K4 fused detect
   (the warm raster layers of a real scan at 364^2, and random layers at
   n = 12 and 45, one seed with low variance so that the main update
   fires: ground and confidence bitwise). CUDA-event times beside
   the plain versions'.
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

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import tempfile
import time

import numpy as np
import torch

N_SCANS = 32
N_LAYER_SCANS = 16
AGREE_MIN = 0.999
GROUND_TRUTH_IDS = (40, 72)  # synthetic road and terrain (SemanticKITTI ids)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean CUDA-event milliseconds of ``fn()`` over ``reps`` calls, warmed."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


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
    ms = cuda_ms(lambda: raster.raster_reduce(cell, cols, ops, n2), 50)
    plain_ms = cuda_ms(lambda: raster.raster_reduce_plain(cell, cols, ops, n2), 10)
    log(f"K1 raster_reduce: {cell.shape[0]} points, {len(cols)} columns, n2={n2}: "
        f"max_abs_err {err:.3g}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return err, ms, plain_ms, cell


def check_lookup(config, driver, cell):
    """K2 on sorted point cells (1 and 2 tables) and an unsorted lattice vector."""
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
    ms = cuda_ms(lambda: lookup.lookup(cell, [ground, conf], n2), 100)
    plain_ms = cuda_ms(lambda: lookup.lookup_plain(cell, [ground, conf], n2), 20)
    lat_ms = cuda_ms(lambda: lookup.lookup(lattice, [conf], n2), 100)
    lat_plain_ms = cuda_ms(lambda: lookup.lookup_plain(lattice, [conf], n2), 20)
    log(f"K2 lookup: bitwise on all cases; 2 tables x {cell.shape[0]} sorted points: "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; 1 table x {lattice.shape[0]} unsorted: "
        f"kernel {lat_ms:.4f} ms, plain {lat_plain_ms:.4f} ms")
    return 0.0, ms, plain_ms


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
    ms = cuda_ms(lambda: spiral.spiral_interpolation(config, h, c, base_z), 20)
    plain_ms = cuda_ms(lambda: spiral.spiral_interpolation_plain(config, h, c, base_z), 2)
    log(f"K3 spiral_interpolation: {config.cell_count}^2, {config.center_cell - 1} rings: "
        f"confidence bitwise, height max_abs_err {err:.3g}, kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms")
    return err, ms, plain_ms


def check_detect(config, driver, rec):
    """K4 on the warm raster layers of one real scan (364^2) and on random
    layers at n = 12 and 45, against its plain version: bitwise."""
    from groundgrid_torch.config import GroundGridConfig
    from groundgrid_torch.core import detect as detectlib
    from groundgrid_torch.core import grid as gridlib
    from groundgrid_torch.core import rasterize as rasterlib
    from groundgrid_torch.data.synthetic import detect_layers
    from groundgrid_torch.ops import detect, raster

    scan, binning, accept = prepared(config, driver, rec)
    layers = rasterlib.rasterize_sorted(config, binning, scan.pz, scan.t_map_velo[:3, 3],
                                        accept, scan.center, scan.t_base_map,
                                        raster.raster_reduce)
    moved = gridlib.move(config, driver.state, scan.t_base_map, scan.center, scan.center_lo)
    device = scan.px.device
    cases = [("364^2 warm scan", config, detectlib.make_tables(config, device),
              (layers.points, layers.variance, layers.min_ground_height, moved.ground,
               moved.groundpatch))]
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
        want = detect.detect_fused_plain(cfg, tabs, *args)
        for g, w, what in zip(got, want, ("ground", "confidence")):
            if not torch.equal(g, w):
                raise AssertionError(f"K4 ({name}) {what} differs in {int((g != w).sum())} "
                                     f"cells, max {float((g - w).abs().max())}")
            err = max(err, float((g - w).abs().max()))
        changed.append(int((got[1] != args[4]).sum()))
        if not changed[-1]:
            raise AssertionError(f"K4 ({name}): the sweep changed no cell")
    _, tabs, args = cases[0][1:]
    ms = cuda_ms(lambda: detect.detect_fused(config, tabs, *args), 100)
    plain_ms = cuda_ms(lambda: detect.detect_fused_plain(config, tabs, *args), 20)
    log(f"K4 detect_fused: bitwise at {config.cell_count}^2 ({changed[0]} cells updated), "
        f"n=12 and n=45 (4 seeds each); {config.cell_count}^2: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms")
    return err, ms, plain_ms


def run_sequence(config, records, device, with_aux=False, driver=None):
    """Results (input order) of ``driver`` (a fresh one by default) over
    ``records``, with the CUDA-event and host-clock ms/scan of the run."""
    from groundgrid_torch.runtime.driver import StreamingDriver

    if driver is None:
        driver = StreamingDriver(config, device, with_aux=with_aux)
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    results = [driver.process(rec) for rec in records]
    end.record()
    end.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1000.0 / len(records)
    event_ms = start.elapsed_time(end) / len(records)
    return results, driver, event_ms, wall_ms


def check_launches(counts, want, driver, name):
    log(f"{name} over {want['spiral']} scans: launches {counts} (want {want}), "
        f"fallbacks {driver.step.fallbacks}")
    if counts != want:
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
    from groundgrid_torch.ops import launch_counts, reset_launch_counts

    reset_launch_counts()
    results, driver, event_ms, wall_ms = run_sequence(config, records, device)
    counts = launch_counts()
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
    return counts


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


def main() -> int:
    phase_environment()
    from groundgrid_torch.config import GroundGridConfig
    from groundgrid_torch.runtime.bench import synthetic_records

    device = torch.device("cuda", 0)
    config = GroundGridConfig(sorted_scans=True)
    t0 = time.perf_counter()
    records = synthetic_records(config, N_SCANS)
    log(f"{N_SCANS} synthetic HDL-64E scans rendered in {time.perf_counter() - t0:.1f} s, "
        f"{records[0].points.shape[0]} points in the first")

    driver = warm_driver(config, records, device)
    k1 = check_raster(config, driver, records[4])
    k2 = check_lookup(config, driver, k1[3])
    k3 = check_spiral(config, driver, records[4])
    k4 = check_detect(config, driver, records[4])
    torch.cuda.synchronize()

    counts = phase_sequence(config, records, device)
    layer_config = dataclasses.replace(config, wire_format=True, fused_detect=True)
    layer_counts = phase_layers(layer_config, records[:N_LAYER_SCANS], device)
    kernels = []
    # launches: each kernel's count in the path it serves (K4: phase 4)
    for name, route_file, replaces, key, res, launches in (
        ("raster_reduce", "raster.cu", "groundgrid_tpu/ops/pallas_raster.py:229", "raster", k1,
         counts),
        ("lookup", "lookup.cu", "groundgrid_tpu/ops/pallas_lookup.py:95", "lookup", k2, counts),
        ("spiral_interpolation", "spiral.cu", "groundgrid_tpu/ops/pallas_spiral.py:662",
         "spiral", k3, counts),
        ("detect_ground_patches_fused", "detect.cu", "groundgrid_tpu/ops/pallas_detect.py:157",
         "detect", k4, layer_counts),
    ):
        kernels.append({
            "name": name, "route": "cuda", "source": f"groundgrid_torch/csrc/{route_file}",
            "replaces": replaces, "launches": launches[key], "max_abs_err": res[0],
            "ms": res[1], "plain_ms": res[2],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
