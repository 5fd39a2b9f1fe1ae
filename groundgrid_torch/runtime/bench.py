"""Throughput benchmark of the PyTorch step on a CUDA device.

The port's counterpart of ``groundgrid_tpu/runtime/bench.py`` (streaming,
batch 1): one ego vehicle over synthetic HDL-64E scans (64 beams x 2048
azimuths, ~118k valid points), the default sorted-scan configuration, and
the same metric name, ``synthetic_hdl64_scans_per_sec_per_chip``.

* ``device_ms_per_scan``: CUDA events around warm forward steps on
  host-prepared scans, the same 32-distinct-scan cycle as the JAX bench
  (two re-warm steps re-enter the forward path after the cycle wraps, so no
  timed step is a backward teleport). The event span is the device timeline
  of the steps, including the gaps where the device waits on the host (the
  step reads the device twice per scan), so it bounds the busy time above.
* ``wall_ms_per_scan``: host clock over ``StreamingDriver.process``, host
  prep (map-frame transform, cell sort, pinned H2D copy) and the label
  fetch included; ``host_prep_ms_p50_p90`` is the host prep alone.

Run on the card: ``python -m groundgrid_torch.runtime.bench`` prints one
JSON line; ``--profile`` prints instead a ``torch.profiler`` table of eight
warm steps by device time. A device that is not CUDA raises: this bench
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
from groundgrid_torch.runtime.driver import ScanRecord, StreamingDriver


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


def run_benchmark(n_scans: int = 64, resolution: float = 0.33, dimension: float = 120.0,
                  warmup: int = 3, n_beams: int = 64, n_azimuth: int = 2048,
                  max_points: int = 131072, device="cuda") -> dict:
    """Streaming throughput of the sorted-scan step on one CUDA device."""
    device = require_cuda(device)
    config = GroundGridConfig(resolution=resolution, dimension=dimension,
                              max_points=max_points, sorted_scans=True)
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
    """``torch.profiler`` table of warm default-geometry steps, by device time."""
    device = require_cuda(device)
    config = GroundGridConfig(sorted_scans=True)
    records = synthetic_records(config, n_steps + 2)
    driver = StreamingDriver(config, device=device)
    for rec in records[:2]:
        driver.process(rec)
    scans = [driver.make_scan(rec)[0] for rec in records[2:]]
    torch.cuda.synchronize(device)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        state = driver.state
        for scan in scans:
            state, _ = driver.step(state, scan)
        torch.cuda.synchronize(device)
    return prof.key_averages().table(sort_by="cuda_time_total", row_limit=25)


def main() -> None:
    if "--profile" in sys.argv[1:]:
        print(profile_steps())
        return
    print(json.dumps(run_benchmark()))


if __name__ == "__main__":
    main()
