"""GPU smoke test of the PyTorch port: builds and checks its CUDA kernels,
then drives the sorted-scan streaming path on one card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero, printing no result):

1. Environment: torch and CUDA versions, the card's name and power limit,
   the kernels' build time (nvcc, from ``groundgrid_torch/csrc``).
2. Each kernel against its plain PyTorch version on the same CUDA tensors,
   at the main path's shapes (364^2 grid, 131072-point buffer):
   K1 raster (7 columns of a prepared scan: counts, sums, min and max all
   bitwise, the plain version folding each run in the kernel's order), K2
   lookup (sorted point cells with 1 and 2 tables, an unsorted
   lattice-sized cell vector: bitwise), K3 spiral (a warm state:
   confidence bitwise, heights atol 2e-5 / rtol 1e-5). CUDA-event times
   beside the plain versions'.
3. ``StreamingDriver`` with the default sorted config over 32 consecutive
   synthetic scans: per-scan launch counts (K1 x1, K2 x3, K3 x1), no
   sortedness fallback, labels against the plain-version run on the card
   (>= 99.9 % agreement), a second kernel run bitwise equal to the first,
   ground-vs-truth recall/precision, ms/scan from CUDA events.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

N_SCANS = 32
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


def check_raster(config, driver, rec):
    """K1 on the 7 columns of one prepared scan, against its plain version."""
    from groundgrid_torch.core import rasterize as rasterlib
    from groundgrid_torch.ops import raster

    scan, _ = driver.make_scan(rec)
    binning = rasterlib.bin_points(config, scan.center, scan.center_lo, scan.px, scan.py,
                                   scan.rings, scan.valid > 0, scan.t_map_velo[:3, 3])
    cell = binning.cell
    if not bool((cell[1:] >= cell[:-1]).all()):
        raise AssertionError("prepared scan is not cell-sorted on the device")
    accept = binning.inmap & ~binning.ignored
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


def run_sequence(config, records, device):
    """Labels (input order) and final layers of a fresh driver over ``records``,
    with the CUDA-event and host-clock ms/scan of the run."""
    from groundgrid_torch.runtime.driver import StreamingDriver

    driver = StreamingDriver(config, device=device)
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    labels = [driver.process(rec).labels for rec in records]
    end.record()
    end.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1000.0 / len(records)
    event_ms = start.elapsed_time(end) / len(records)
    return labels, driver, event_ms, wall_ms


def phase_sequence(config, records, device):
    import dataclasses

    from groundgrid_torch.ops import launch_counts, reset_launch_counts

    reset_launch_counts()
    labels, driver, event_ms, wall_ms = run_sequence(config, records, device)
    counts = launch_counts()
    n = len(records)
    want = {"raster": n, "lookup": 3 * n, "spiral": n}
    log(f"main path over {n} scans: launches {counts} (want {want}), "
        f"fallbacks {driver.step.fallbacks}")
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want}")
    if driver.step.fallbacks != 0:
        raise AssertionError(f"{driver.step.fallbacks} sortedness fallbacks")
    log(f"main path: {event_ms:.3f} ms/scan (CUDA events, host prep included), "
        f"{1000.0 / event_ms:.2f} scans/s; host clock {wall_ms:.3f} ms/scan")

    for lbl, rec in zip(labels, records):
        if lbl.shape != (rec.points.shape[0],) or not np.isin(lbl, (0, 49, 99)).all():
            raise AssertionError("labels of the wrong shape or values")
    for t in (driver.state.ground, driver.state.groundpatch):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError("grid layers not finite")

    plain_cfg = dataclasses.replace(config, use_pallas=False)
    plain_labels, _, plain_ms, _ = run_sequence(plain_cfg, records, device)
    total = sum(len(lbl) for lbl in labels)
    mism = sum(int((a != b).sum()) for a, b in zip(labels, plain_labels))
    log(f"labels vs plain versions on the card: {mism} of {total} points differ "
        f"({1 - mism / total:.6%} agree; plain path {plain_ms:.3f} ms/scan)")
    if 1 - mism / total < AGREE_MIN:
        raise AssertionError(f"label agreement below {AGREE_MIN:.1%}")

    again, driver2, _, _ = run_sequence(config, records, device)
    if not all(np.array_equal(a, b) for a, b in zip(labels, again)):
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
    torch.cuda.synchronize()

    counts = phase_sequence(config, records, device)
    kernels = []
    for name, route_file, replaces, key, res in (
        ("raster_reduce", "raster.cu", "groundgrid_tpu/ops/pallas_raster.py:229", "raster", k1),
        ("lookup", "lookup.cu", "groundgrid_tpu/ops/pallas_lookup.py:95", "lookup", k2),
        ("spiral_interpolation", "spiral.cu", "groundgrid_tpu/ops/pallas_spiral.py:662",
         "spiral", k3),
    ):
        kernels.append({
            "name": name, "route": "cuda", "source": f"groundgrid_torch/csrc/{route_file}",
            "replaces": replaces, "launches": counts[key], "max_abs_err": res[0],
            "ms": res[1], "plain_ms": res[2],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
