"""Config-space fuzzing: random valid configs + golden-parity sweep.

The torch counterpart of ``groundgrid_tpu/eval/fuzz.py`` (``random_config``,
``min_ray_steps``, ``describe``, ``fuzz_one``) and of the campaign runner
``scripts/config_fuzz.py``, with the port as the pipeline under test on an
explicit ``--device``:

    python -m groundgrid_torch.eval.fuzz [--n 50] [--fused | --wire] [--device cuda]

Each row is a 2-scan adversarial parity run (``eval/accuracy.py``) of one
random or boundary config against the port's copy of the golden oracle.
Configs run as drawn: ``random_config`` leaves ``sorted_scans`` at its
default, False, so the random rows run unsorted mode. Acceptance per row, as
the JAX campaign's: max |metric delta| < 0.1 pt and label disagreement
< 2e-3; ``--wire`` rows (the s16 wire ingest against the f32 oracle) < 1 pt,
their flips reported, not bounded. The markdown table goes to ``--out``
(default under ``fuzz_reports/``, which git ignores); the last line of
standard output is a JSON summary.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time

import numpy as np
import torch

from groundgrid_torch.config import GroundGridConfig
from groundgrid_torch.core.outliers import IDX_BITS


def min_ray_steps(dimension: float, resolution: float) -> int:
    """The lower bound pipeline._validate enforces (grid half-diagonal)."""
    cells = int(round(dimension / resolution))
    half = cells * resolution / 2.0
    return int(math.ceil(half * math.sqrt(2.0))) + 8


def random_config(rng: np.random.Generator) -> GroundGridConfig:
    """One random VALID config, grid capped at ~128 cells/side so the
    pure-Python oracle stays affordable (cost ~ cells^2 per scan)."""
    resolution = float(rng.uniform(0.1, 1.0))
    cells = int(rng.integers(40, 128))
    dimension = cells * resolution
    need = min_ray_steps(dimension, resolution)
    return GroundGridConfig(
        dimension=dimension,
        resolution=resolution,
        max_points=int(rng.integers(8192, 40000)),  # mostly non-multiples
        ray_steps=need + int(rng.integers(0, 32)),
        max_outlier_candidates=int(rng.integers(1024, 8192)),
        march_chunk=int(rng.integers(128, 2048)),
        border_drop=bool(rng.integers(0, 2)),
        point_count_cell_variance_threshold=int(rng.integers(4, 20)),
        distance_factor=float(rng.uniform(0.00005, 0.0002)),
        patch_size_change_distance=float(rng.uniform(5.0, 30.0)),
        occupied_cells_decrease_factor=float(rng.uniform(2.0, 10.0)),
        outlier_tolerance=float(rng.uniform(0.05, 0.2)),
    )


def describe(cfg: GroundGridConfig) -> dict:
    return dict(
        dimension=round(cfg.dimension, 4), resolution=round(cfg.resolution, 5),
        cells=cfg.cell_count, max_points=cfg.max_points,
        ray_steps=cfg.ray_steps, max_outlier_candidates=cfg.max_outlier_candidates,
        march_chunk=cfg.march_chunk, border_drop=cfg.border_drop,
        point_count_cell_variance_threshold=cfg.point_count_cell_variance_threshold,
        distance_factor=round(cfg.distance_factor, 7),
        patch_size_change_distance=round(cfg.patch_size_change_distance, 3),
        occupied_cells_decrease_factor=round(cfg.occupied_cells_decrease_factor, 3),
        outlier_tolerance=round(cfg.outlier_tolerance, 4),
    )


def fuzz_one(cfg: GroundGridConfig, seed: int, n_scans: int = 2, wire: bool = False, *,
             device) -> dict:
    """Parity-run one config on ``device``; the benchmark dict + config summary.

    ``wire=True``: the pipeline runs the s16 wire ingest (``sorted_scans +
    wire_format``) while golden stays on the exact f32 path. As in the JAX
    campaign, both engines then get ``max_points`` rounded up to a multiple
    of 1024 (scans here are ~6k points, far below any cap: behavior-neutral).
    """
    from groundgrid_torch.eval.accuracy import run_accuracy_benchmark

    pipe_cfg = None
    if wire:
        cap = ((cfg.max_points + 1023) // 1024) * 1024
        cfg = dataclasses.replace(cfg, max_points=cap)
        pipe_cfg = dataclasses.replace(cfg, sorted_scans=True, wire_format=True)
    r = run_accuracy_benchmark(
        cfg, n_scans=n_scans, seed=seed, n_beams=16, n_azimuth=400,
        step_m=2.0, adversarial=True, pipeline_config=pipe_cfg, device=device,
    )
    r["config"] = describe(cfg)
    return r


def boundary_configs() -> list[tuple[str, GroundGridConfig]]:
    """The JAX campaign's five boundary rows (``scripts/config_fuzz.py``)."""
    ceiling = 1 << IDX_BITS
    return [
        ("u32-sort ceiling +640 (top_k fallback, CHUNK/GROUP non-multiple)",
         GroundGridConfig(dimension=40.0, resolution=0.5, max_points=ceiling + 640,
                          ray_steps=70, max_outlier_candidates=2048)),
        ("u32-sort ceiling exact",
         GroundGridConfig(dimension=40.0, resolution=0.5, max_points=ceiling, ray_steps=70,
                          max_outlier_candidates=2048)),
        ("ray_steps at validated lower bound",
         GroundGridConfig(dimension=50.0, resolution=0.5, max_points=16384,
                          ray_steps=min_ray_steps(50.0, 0.5), max_outlier_candidates=2048)),
        ("march_chunk > candidate cap (single clipped chunk)",
         GroundGridConfig(dimension=40.0, resolution=0.5, max_points=16384, ray_steps=70,
                          max_outlier_candidates=512, march_chunk=4096)),
        ("non-f32-exact resolution 0.37",
         GroundGridConfig(dimension=44.4, resolution=0.37, max_points=16384,
                          ray_steps=min_ray_steps(44.4, 0.37) + 5,
                          max_outlier_candidates=2048)),
    ]


def campaign(n: int, fused: bool = False) -> list[tuple[str, GroundGridConfig, int]]:
    """``(name, config, seed)`` rows: the boundary configs, then ``n`` random
    ones, seeded as the JAX campaign seeds them."""
    runs = [(name, cfg, 900 + i) for i, (name, cfg) in enumerate(boundary_configs())]
    runs += [(f"random #{i}", random_config(np.random.default_rng(1000 + i)), 40 + i)
             for i in range(n)]
    if fused:
        runs = [(name, dataclasses.replace(cfg, fused_detect=True), seed)
                for name, cfg, seed in runs]
    return runs


def row_ok(r: dict, wire: bool) -> bool:
    """The campaign's acceptance: < 0.1 pt and < 2e-3 label mismatch; wire
    rows < 1 pt (a single quantization-perturbed cell is ~0.5-1 pt of a
    2-scan micro-world's score)."""
    if wire:
        return r["max_abs_delta_pt"] < 1.0
    return r["max_abs_delta_pt"] < 0.1 and r["label_mismatch_rate"] < 2e-3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m groundgrid_torch.eval.fuzz")
    ap.add_argument("--n", type=int, default=50, help="random configs after the 5 boundary rows")
    ap.add_argument("--out", default="", help="markdown table path (default under fuzz_reports/)")
    ap.add_argument("--fused", action="store_true",
                    help="run every config with fused_detect=True (K4's campaign)")
    ap.add_argument("--wire", action="store_true",
                    help="the pipeline runs the s16 wire ingest against the f32 golden")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the pipeline (default cuda; raises without a card)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: CUDA is not available")
    mode = "_fused" if args.fused else "_wire" if args.wire else ""
    out = args.out or os.path.join("fuzz_reports", f"config_fuzz{mode}.md")

    t0 = time.monotonic()
    runs = campaign(args.n, args.fused)
    rows, worst, worst_mismatch, fails = [], 0.0, 0.0, 0
    for name, cfg, seed in runs:
        r = fuzz_one(cfg, seed=seed, wire=args.wire, device=device)
        ok = row_ok(r, args.wire)
        fails += 0 if ok else 1
        worst = max(worst, r["max_abs_delta_pt"])
        worst_mismatch = max(worst_mismatch, r["label_mismatch_rate"])
        c = r["config"]
        rows.append(
            f"| {name} | {'sorted' if cfg.sorted_scans or args.wire else 'unsorted'} | "
            f"{c['dimension']:.1f}/{c['resolution']:.3f} ({c['cells']}^2) | "
            f"{c['max_points']} | {c['ray_steps']} | "
            f"{c['max_outlier_candidates']}/{c['march_chunk']} | "
            f"{'on' if c['border_drop'] else 'off'} | {r['max_abs_delta_pt']:.4f} | "
            f"{r['label_mismatch_rate']:.2e} | {'ok' if ok else '**FAIL**'} |")
        print(f"{name}: max|d|={r['max_abs_delta_pt']:.4f} pt "
              f"mismatch={r['label_mismatch_rate']:.2e} {'ok' if ok else 'FAIL'}", flush=True)
    wall = time.monotonic() - t0
    backend = r["workload"]["backend"]
    body = "\n".join([
        "# Config-space fuzz: groundgrid_torch vs its golden oracle"
        + (" (fused_detect=True)" if args.fused else "")
        + (" (s16 wire ingest vs f32 golden)" if args.wire else ""),
        "",
        "Generated by `python -m groundgrid_torch.eval.fuzz` on " + backend + ". Each row",
        "is a 2-scan adversarial parity run of the port against its golden oracle;",
        "acceptance per row: " + ("max |metric delta| < 1 pt (wire)." if args.wire else
                                  "max |metric delta| < 0.1 pt and label disagreement < 2e-3."),
        "",
        f"- configs: {len(runs)} ({len(boundary_configs())} boundary + {args.n} random), "
        f"wall {wall:.0f} s",
        f"- worst max|delta|: **{worst:.4f} pt**; worst label mismatch: "
        f"**{worst_mismatch:.2e}**; failures: **{fails}**",
        "",
        "| config | mode | dim/res (cells) | max_points | ray_steps | cands/chunk | border "
        "| max|delta| (pt) | label mismatch | status |",
        "|---|---|---|---|---|---|---|---|---|---|",
        *rows,
        "",
    ])
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        f.write(body)
    print(json.dumps(dict(configs=len(runs), worst_delta_pt=worst,
                          worst_mismatch=worst_mismatch, failures=fails,
                          wall_s=round(wall, 1), backend=backend, out=out)), flush=True)
    return 0 if fails == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
