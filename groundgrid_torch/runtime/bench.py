"""Throughput benchmark of the PyTorch step on a CUDA device.

The port's counterpart of ``groundgrid_tpu/runtime/bench.py``: synthetic
HDL-64E scans (64 beams x 2048 azimuths, ~118k valid points), the default
sorted-scan configuration, and the same metric name,
``synthetic_hdl64_scans_per_sec_per_chip``. Two modes, as there:

* streaming (``batch=1``): one ego vehicle.

  - ``device_ms_per_scan``: CUDA events around warm forward steps on
    host-prepared scans, the same 32-distinct-scan cycle as the JAX bench
    (two re-warm steps re-enter the forward path after the cycle wraps, so
    no timed step is a backward teleport). The event span is the device
    timeline of the steps, including the gaps where the device waits on
    the host's dispatch, so it bounds the busy time above.
  - ``wall_ms_per_scan``: host clock over ``StreamingDriver.process``, host
    prep (map-frame transform, cell sort, pinned H2D copy) and the label
    fetch included; ``host_prep_ms_p50_p90`` is the host prep alone.

* fleet (``batch=B > 1``, BASELINE.json config 5): B vehicles stepped in
  lock-step by the fleet step (``parallel/sharding.py``). As in the JAX
  bench, 8 distinct scans are prepared once, every vehicle starts at the
  first pose and vehicle v steps scan ``v mod 8`` every tick.
  ``device_ms_per_scan`` is the mean CUDA-event span of a tick over B, over
  at least ``FLEET_MIN_TICKS`` timed ticks (``n_scans / B`` if more);
  ``wall_ms_per_scan`` adds the tick's fetch of the fleet summary.

Run on the card: ``python -m groundgrid_torch.runtime.bench`` prints one
JSON line; ``--profile`` prints instead a ``torch.profiler`` table of eight
warm steps by device time, the eager step's device ms and launches stage
by stage (``pipeline.STAGES``, the raster stage also by its parts,
``pipeline.RASTER_PARTS``: sort, check, K9, K1, K10), then the device busy ms per step (the sum of
the device activities' durations over the steps). A device that is not CUDA raises: this bench
gives no CPU number.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from groundgrid_torch.config import GroundGridConfig
from groundgrid_torch.data.synthetic import make_scene, render_scan, vehicle_pose
from groundgrid_torch.parallel.sharding import (
    make_fleet_step,
    make_mesh,
    shard_fleet_pytree,
    stack_fleet_pytree,
)
from groundgrid_torch.pipeline import (
    RASTER_PARTS,
    STAGES,
    CenterTracker,
    init_state,
    make_step_fn,
    pad_scan,
    prepare_scan,
)
from groundgrid_torch.runtime.driver import ScanRecord, StreamingDriver
from groundgrid_torch.runtime.kernel_timing import device_us, profiled, stage_us

FLEET_MIN_TICKS = 8  # a fleet tick's span varies by tens of percent between ticks


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed ({proc.returncode}): {proc.stderr.strip()}")
    return proc.stdout.strip()


def require_cuda(device) -> torch.device:
    """``device`` as a CUDA device; raise if it is not one or none is present."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"a CUDA device is required (got {device}, "
                           f"cuda available: {torch.cuda.is_available()})")
    return device


def synthetic_records(config: GroundGridConfig, n_distinct: int, n_beams: int = 64,
                      n_azimuth: int = 2048, seed: int = 0) -> list[ScanRecord]:
    """Consecutive synthetic scans of the bench scene (1.2 m apart)."""
    scene = make_scene(seed, extent=min(200.0, 2 * config.dimension))
    records = []
    for k in range(n_distinct):
        T = vehicle_pose(scene, k, step_m=1.2)
        pts, lbl = render_scan(scene, T, n_beams=n_beams, n_azimuth=n_azimuth, seed=seed + k)
        records.append(ScanRecord(index=k, timestamp=0.1 * k, points=pts, labels=lbl,
                                  t_map_velo=T))
    return records


def device_ms_per_step(driver: StreamingDriver, records: list[ScanRecord]):
    """CUDA-event ms of each ``driver.step`` over warm forward scans, and the
    host-clock ms of each scan's host prep (``driver.make_scan``).

    Re-warms on ``records[0:2]`` (the driver state may sit at the end of the
    cycle), prepares the rest on the host, then times only the steps.
    """
    warm = min(2, len(records))
    for rec in records[:warm]:
        driver.process(rec)
    scans, prep_ms = [], []
    for rec in records[warm:]:
        t0 = time.perf_counter()
        scans.append(driver.make_scan(rec)[0])
        torch.cuda.synchronize(driver.device)
        prep_ms.append((time.perf_counter() - t0) * 1000.0)
    if not scans:
        raise ValueError("need more than two records to time forward steps")
    torch.cuda.synchronize(driver.device)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(len(scans) + 1)]
    events[0].record()
    state = driver.state
    for scan, end in zip(scans, events[1:]):
        state, _ = driver.step(state, scan)
        end.record()
    events[-1].synchronize()
    driver.state = state
    return [a.elapsed_time(b) for a, b in zip(events, events[1:])], prep_ms


def fleet_inputs(config: GroundGridConfig, records: list[ScanRecord], batch: int, device):
    """The fleet bench's inputs on ``device``: ``(mesh, states, scans)``.

    Each record is prepared once against the stream's f64 center tracker
    (sorted and cell-sorted on the host, or, for an unsorted config, padded
    raw with the tracker's center); every vehicle starts at the first
    record's pose, and vehicle v steps the prepared scan ``v mod
    len(records)``.
    """
    mesh = make_mesh([device])
    positions = [np.asarray(r.t_map_velo, np.float64)[:2, 3] for r in records]
    tracker = CenterTracker(config, positions[0])
    scans = []
    for r, pos in zip(records, positions):
        center = tracker.update(pos)
        if config.sorted_scans:
            scans.append(prepare_scan(config, r.points[:, :3], r.labels, r.t_map_velo, center,
                                      "cpu")[0])
        else:
            chi, clo = tracker.center_ds()
            scans.append(pad_scan(config, r.points, r.labels, r.t_map_velo, "cpu")
                         ._replace(center=chi, center_lo=clo))
    states = stack_fleet_pytree([init_state(config, records[0].t_map_velo, "cpu")] * batch)
    batched = stack_fleet_pytree([scans[v % len(scans)] for v in range(batch)])
    return mesh, shard_fleet_pytree(states, mesh), shard_fleet_pytree(batched, mesh)


def run_fleet_benchmark(config: GroundGridConfig, records: list[ScanRecord], batch: int,
                        n_scans: int, warmup: int, device) -> dict:
    """Fleet throughput of ``batch`` vehicles on one CUDA device: the
    metric line's fleet fields. A sorted config steps each device's
    vehicles one by one, an unsorted one as one batch
    (``parallel/sharding.py``)."""
    mesh, states, scans = fleet_inputs(config, records, batch, device)
    fleet = make_fleet_step(config, mesh)
    for _ in range(warmup):
        states, _, summary = fleet(states, scans)
    int(summary.ground_points)
    ticks, wall = [], []
    for _ in range(max(FLEET_MIN_TICKS, n_scans // batch)):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        start.record()
        states, _, summary = fleet(states, scans)
        end.record()
        int(summary.ground_points)  # the tick's fetch
        wall.append((time.perf_counter() - t0) * 1000.0)
        ticks.append(start.elapsed_time(end))
    tick_ms, wall_ms = float(np.mean(ticks)), float(np.mean(wall))
    _log(f"bench: fleet of {batch}: {tick_ms:.3f} device ms per tick (CUDA events), wall "
         f"{wall_ms:.3f} ms per tick, {len(ticks)} ticks timed")
    return {
        "batch": batch,
        "n_chips": 1,
        "total_scans_per_sec": round(1000.0 * batch / tick_ms, 2),
        "device_ms_per_scan": round(tick_ms / batch, 4),
        "device_ms_per_tick": round(tick_ms, 4),
        "device_ms_per_tick_min_p50_p90_max": [round(float(v), 4)
                                               for v in np.percentile(ticks, [0, 50, 90, 100])],
        "ticks_timed": len(ticks),
        "wall_ms_per_scan": round(wall_ms / batch, 4),
        "wall_ms_per_tick": round(wall_ms, 4),
        "fallbacks": fleet.fallbacks,
        "batched": fleet.batched,
        "methodology": (
            "value = 1000 / device_ms_per_scan; device_ms_per_scan = mean CUDA-event "
            "span of a warm fleet tick over the batch (device waits on the host's "
            "dispatch included); wall_ms_per_scan = host clock over the tick and its "
            "fetch of the fleet summary, over the batch; scans prepared once, as in the "
            "JAX fleet bench"
        ),
    }


def run_benchmark(n_scans: int = 64, batch: int = 1, resolution: float = 0.33,
                  dimension: float = 120.0, warmup: int = 3, n_beams: int = 64,
                  n_azimuth: int = 2048, max_points: int = 131072, device="cuda") -> dict:
    """Throughput of the sorted-scan step on one CUDA device: streaming
    (``batch=1``) or a fleet of ``batch`` vehicles."""
    device = require_cuda(device)
    config = GroundGridConfig(resolution=resolution, dimension=dimension,
                              max_points=max_points, sorted_scans=True)
    if batch > 1:
        records = synthetic_records(config, 8, n_beams, n_azimuth)
        fleet = run_fleet_benchmark(config, records, batch, n_scans, warmup, device)
        return {
            "metric": "synthetic_hdl64_scans_per_sec_per_chip",
            "value": round(1000.0 / fleet["device_ms_per_scan"], 2),
            "unit": "scans/s/chip",
            "extra": {
                "platform": "cuda",
                "gpu": torch.cuda.get_device_name(device),
                "nvidia_smi_name_power_limit": gpu_name_and_power_limit(),
                "grid_cells": config.cell_count,
                "points_per_scan": int(min(records[0].points.shape[0], max_points)),
                **fleet,
            },
        }
    n_distinct = min(32, max(4, n_scans))
    records = synthetic_records(config, n_distinct, n_beams, n_azimuth)
    n_points = int(min(records[0].points.shape[0], max_points))
    _log(f"bench: device={torch.cuda.get_device_name(device)} grid={config.cell_count}^2 "
         f"{n_points} points/scan, {n_distinct} distinct scans")

    driver = StreamingDriver(config, device=device)
    for i in range(warmup):
        driver.process(records[i % n_distinct])
    torch.cuda.synchronize(device)
    wall = []
    for i in range(n_scans):
        t0 = time.perf_counter()
        driver.process(records[i % n_distinct])
        wall.append((time.perf_counter() - t0) * 1000.0)

    steps, prep = device_ms_per_step(driver, records)
    device_ms, wall_ms = float(np.mean(steps)), float(np.mean(wall))
    per_chip = 1000.0 / device_ms
    _log(f"bench: wall {wall_ms:.3f} ms/scan (host prep included), "
         f"device {device_ms:.3f} ms/scan (CUDA events)")
    return {
        "metric": "synthetic_hdl64_scans_per_sec_per_chip",
        "value": round(per_chip, 2),
        "unit": "scans/s/chip",
        "extra": {
            "platform": "cuda",
            "gpu": torch.cuda.get_device_name(device),
            "nvidia_smi_name_power_limit": gpu_name_and_power_limit(),
            "batch": 1,
            "n_chips": 1,
            "grid_cells": config.cell_count,
            "points_per_scan": n_points,
            "device_ms_per_scan": round(device_ms, 4),
            "device_ms_p50_p90": [round(float(v), 4) for v in np.percentile(steps, [50, 90])],
            "device_steps_timed": len(steps),
            "wall_ms_per_scan": round(wall_ms, 4),
            "wall_ms_p50_p90": [round(float(v), 4) for v in np.percentile(wall, [50, 90])],
            "wall_scans_timed": len(wall),
            "wall_scans_per_sec": round(1000.0 / wall_ms, 2),
            "host_prep_ms_p50_p90": [round(float(v), 4) for v in np.percentile(prep, [50, 90])],
            "methodology": (
                "value = 1000 / device_ms_per_scan; device_ms_per_scan = mean "
                "CUDA-event span of warm forward steps on host-prepared scans "
                "(device waits on the host included); wall_ms_per_scan = mean host "
                "clock over StreamingDriver.process, host prep and label fetch "
                "included"
            ),
        },
    }


def profile_steps(n_steps: int = 8, device="cuda") -> str:
    """``torch.profiler`` table of warm default-geometry steps (the driver's,
    captured), by device time; then the device busy ms per step and its
    share of the steps' CUDA-event span."""
    device = require_cuda(device)
    config = GroundGridConfig(sorted_scans=True)
    records = synthetic_records(config, n_steps + 2)
    driver = StreamingDriver(config, device=device)
    for rec in records[:2]:
        driver.process(rec)
    scans = [driver.make_scan(rec)[0] for rec in records[2:]]
    torch.cuda.synchronize(device)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with profiled() as prof:
        state = driver.state
        start.record()
        for scan in scans:
            state, _ = driver.step(state, scan)
        end.record()
        torch.cuda.synchronize(device)
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=25)
    busy_us, activities = device_us(prof)
    span_ms = start.elapsed_time(end) / len(scans)
    busy_ms = busy_us / 1000.0 / len(scans)
    stages = stage_lines(config, records, device)
    return (f"{table}\n{stages}\ndevice busy {busy_ms:.4f} ms per step "
            f"({activities / len(scans):.1f} device activities per step) over {len(scans)} "
            f"warm steps; span {span_ms:.4f} ms per step (CUDA events, profiler on): busy "
            f"share {busy_ms / span_ms:.4f}; step {type(driver.step).__name__}")


def stage_lines(config: GroundGridConfig, records: list[ScanRecord], device) -> str:
    """The eager step's device ms and launches a step, stage by stage (its
    ``record_function`` ranges, ``pipeline.STAGES``, and under the raster
    stage its parts, ``pipeline.RASTER_PARTS``; a replayed graph has none),
    over ``records[2:]`` after two warm steps, as lines."""
    driver = StreamingDriver(config, device=device)
    driver.step = make_step_fn(config)
    for rec in records[:2]:
        driver.process(rec)
    scans = [driver.make_scan(rec)[0] for rec in records[2:]]
    torch.cuda.synchronize(device)
    with profiled() as prof:
        state = driver.state
        for scan in scans:
            state, _ = driver.step(state, scan)
    busy_us, activities = device_us(prof)
    stages = stage_us(prof, STAGES)
    parts = stage_us(prof, RASTER_PARTS)
    n = len(scans)
    lines = [f"eager step by stage ({n} warm steps, a step): device {busy_us / 1000.0 / n:.4f} "
             f"ms, {activities / n:.1f} device activities"]
    for name, (us, count) in stages.items():
        if count:
            lines.append(f"  stage {name}: {us / 1000.0 / n:.4f} device ms, {count / n:.1f} "
                         f"launches")
        if name == "raster":
            lines.extend(f"    part {part}: {p_us / 1000.0 / n:.4f} device ms, "
                         f"{p_count / n:.1f} launches"
                         for part, (p_us, p_count) in parts.items() if p_count)
    us = busy_us - sum(v[0] for v in stages.values())
    count = activities - sum(v[1] for v in stages.values())
    lines.append(f"  outside the stages: {us / 1000.0 / n:.4f} device ms, {count / n:.1f} "
                 f"device activities")
    return "\n".join(lines)


def main() -> None:
    if "--profile" in sys.argv[1:]:
        print(profile_steps())
        return
    print(json.dumps(run_benchmark()))


if __name__ == "__main__":
    main()
