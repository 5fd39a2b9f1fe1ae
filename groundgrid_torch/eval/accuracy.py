"""Metric-level accuracy benchmark: the port's pipeline vs the golden oracle.

The torch counterpart of ``groundgrid_tpu/eval/accuracy.py``: the port's
:class:`~groundgrid_torch.runtime.driver.StreamingDriver` on an explicit
``device`` is the pipeline under test, scored against the port's copy of the
NumPy oracle (``groundgrid_torch/golden.py``) on the same scans.

The acceptance currency of the reference is its seq-00 metric table
(the reference's ``README.md:56-94``, produced by
``launch/KITTIEvaluate.launch``): F1 97.35 / IoUg 94.84. With no
SemanticKITTI dataset in this environment, the strongest available evidence
is *delta-level*: run an adversarial synthetic sequence through BOTH the
pipeline and the sequential NumPy golden oracle, score each with the
exact reference scorer (``eval/metrics.py``), and bound |ΔF1| and |ΔIoUg|.
The 0.5 pt acceptance budget (BASELINE.md) is reserved for the racy-reference
gap (the C++ races its accumulators across threads, SURVEY.md §7); the
deterministic-pipeline-vs-deterministic-oracle delta must stay within 0.1 pt.

Used by ``python -m groundgrid_torch accuracy`` (writes the markdown report)
and by ``tests/test_torch_accuracy.py`` (asserts the bound in CI geometry).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from groundgrid_torch.config import GroundGridConfig
from groundgrid_torch.core import transforms as tf
from groundgrid_torch.eval.metrics import Evaluator

HEADLINE = ("precision", "recall", "f1", "accuracy", "ioug")


def run_accuracy_benchmark(
    config: GroundGridConfig,
    n_scans: int = 120,
    seed: int = 17,
    n_beams: int = 64,
    n_azimuth: int = 1800,
    step_m: float = 1.2,
    adversarial: bool = True,
    progress=None,
    chaos_control: bool = False,
    world: str = "",
    variant: str = "city",
    rain_rate: float = 0.0,
    pipeline_config: GroundGridConfig | None = None,
    *,
    device,
) -> dict:
    """Run the port's pipeline on ``device`` and the golden oracle over the
    same sequence.

    Returns a dict with per-engine headline metrics, their deltas (in
    percentage points), the per-scan label disagreement rate, and workload
    stats. ``progress`` (optional callable) receives one line per scan.

    ``chaos_control``: additionally run a second golden oracle on the SAME
    scans with its per-scan VARIANCE map nudged by +-1 float32 ulp (random
    sign per nonzero cell) and report its metric deltas vs unperturbed
    golden. Rationale (measured, scripts/accuracy_diag.py +
    scripts/chaos_diag.py at full geometry): every value detect WRITES is
    order-invariant (integer counts, mins, and their quotients), so golden
    is BITWISE stable under full point-order permutation -- reassociation
    noise by itself is not the divergence mechanism. What separates any two
    valid engines is the float32 rounding of the variance path (sequential
    Welford vs parallel two-pass sums), which detect THRESHOLDS
    (GroundSegmentation.cpp:369-382); a flipped near-tie cell then shifts
    ground by metres and the spiral spreads it. The +-1-ulp variance nudge
    injects exactly that noise class at its smallest magnitude, so the
    control measures the algorithm's intrinsic rounding-tie sensitivity: a
    pipeline-vs-golden delta comparable to this envelope is inherent to ANY
    reimplementation that does not replicate golden's per-cell sequential
    arithmetic bit for bit (the racy reference cannot replicate even its
    own). Pass ``chaos_control="perm"`` for the older point-order
    permutation control (kept for the bitwise-stability regression claim).
    """
    from groundgrid_torch.data.synthetic import (
        adversarial_sequence, synthetic_sequence,
    )
    from groundgrid_torch.golden import GoldenGroundGrid
    from groundgrid_torch.runtime.driver import StreamingDriver
    from groundgrid_torch.data.semantickitti import ScanRecord

    if pipeline_config is not None:
        # one geometry for both engines: the label comparison is per point
        # and the deltas are scored on the same cells (ADVICE.md)
        for field in ("dimension", "resolution", "cell_count"):
            if getattr(pipeline_config, field) != getattr(config, field):
                raise ValueError(f"pipeline_config.{field} differs from config.{field}")

    if world == "kitti":
        # KITTI-operating-point urban world (data/kitti_world.py): scored
        # profile tuned to the reference's seq-00 table so parity is
        # measured in its ~98-99 % recall regime (ACCURACY_r4.md campaign)
        import functools

        from groundgrid_torch.data.kitti_world import kitti_sequence

        gen = functools.partial(
            kitti_sequence, variant=variant, rain_rate=rain_rate,
            resolution=config.resolution,
        )
    else:
        gen = adversarial_sequence if adversarial else synthetic_sequence
    # pipeline_config lets the driver run an ingest variant (e.g. the s16
    # wire format) while golden stays on the exact f32 path, so the deltas
    # price the variant itself (scripts/config_fuzz.py --wire).
    driver = StreamingDriver(pipeline_config or config, device)
    golden = GoldenGroundGrid(config)
    ev_pipe = Evaluator("accuracy")
    ev_gold = Evaluator("accuracy")
    chaos_mode = "perm" if chaos_control == "perm" else "ulp"
    golden_p = GoldenGroundGrid(config) if chaos_control else None
    ev_gold_p = Evaluator("accuracy") if chaos_control else None
    if golden_p is not None and chaos_mode == "ulp":
        golden_p.chaos_variance_ulps = 1

    total_pts = 0
    label_mismatch = 0
    label_total = 0
    t0 = time.monotonic()
    for idx, (pts_velo, lbl, T) in enumerate(
        gen(n_scans, seed=seed, n_beams=n_beams, n_azimuth=n_azimuth,
            step_m=step_m)
    ):
        rec = ScanRecord(
            index=idx, timestamp=float(idx) * 0.1,
            points=np.concatenate(
                [pts_velo, np.zeros((len(pts_velo), 1), np.float32)], axis=1
            ),
            labels=np.asarray(lbl, np.int32),
            t_map_velo=np.asarray(T, np.float64),
        )
        res = driver.process(rec)
        ev_pipe.add_cloud(res.labels, lbl)

        mv, mb, bm = tf.scan_poses(T)
        x, y, z = tf.transform_points_soa(
            np.asarray(mv), pts_velo[:, 0], pts_velo[:, 1], pts_velo[:, 2]
        )
        pts_map = np.stack([x, y, z], axis=-1)
        golden.update_odom(np.asarray(T, np.float64), np.asarray(bm, np.float64))
        want = golden.filter_cloud(
            pts_map, lbl, np.asarray(mv[:3, 3]), np.asarray(mb, np.float64)
        )
        ev_gold.add_cloud(want, lbl)

        if golden_p is not None:
            golden_p.update_odom(
                np.asarray(T, np.float64), np.asarray(bm, np.float64)
            )
            if chaos_mode == "perm":
                # same points in permuted order: the racing insert threads'
                # accumulation scrambling (scoring is order-invariant)
                perm = np.random.default_rng(10_000 + idx).permutation(
                    len(pts_map)
                )
                want_p = golden_p.filter_cloud(
                    pts_map[perm], np.asarray(lbl)[perm],
                    np.asarray(mv[:3, 3]), np.asarray(mb, np.float64),
                )
                ev_gold_p.add_cloud(want_p, np.asarray(lbl)[perm])
            else:
                # +-1-ulp variance nudge (golden_p.chaos_variance_ulps)
                want_p = golden_p.filter_cloud(
                    pts_map, lbl, np.asarray(mv[:3, 3]),
                    np.asarray(mb, np.float64),
                )
                ev_gold_p.add_cloud(want_p, lbl)

        got = np.asarray(res.labels)[: len(want)]
        label_mismatch += int((got != np.asarray(want)).sum())
        label_total += len(want)
        total_pts += len(want)
        if progress is not None:
            progress(
                f"scan {idx + 1}/{n_scans}: {len(want)} pts, "
                f"cumulative label mismatch "
                f"{label_mismatch}/{label_total}"
            )

    mp = ev_pipe.compute().as_dict()
    mg = ev_gold.compute().as_dict()
    deltas = {k: (mp[k] - mg[k]) * 100.0 for k in HEADLINE}
    control = {}
    if golden_p is not None:
        mgp = ev_gold_p.compute().as_dict()
        env = {k: (mgp[k] - mg[k]) * 100.0 for k in HEADLINE}
        control = dict(
            golden_perturbed=mgp,
            chaos_mode=chaos_mode,
            chaos_envelope_pt=env,
            max_abs_chaos_envelope_pt=max(abs(v) for v in env.values()),
        )
    return dict(
        **control,
        workload=dict(
            n_scans=n_scans, seed=seed, n_beams=n_beams, n_azimuth=n_azimuth,
            step_m=step_m, adversarial=adversarial,
            world=world or ("adversarial" if adversarial else "benign"),
            variant=variant if world == "kitti" else "",
            rain_rate=rain_rate if world == "kitti" else 0.0,
            dimension=config.dimension, resolution=config.resolution,
            cells=config.cell_count, total_points=total_pts,
            wall_s=time.monotonic() - t0,
            backend=_backend(driver.device),
        ),
        pipeline=mp,
        golden=mg,
        delta_pt=deltas,
        max_abs_delta_pt=max(abs(v) for v in deltas.values()),
        label_mismatch_rate=label_mismatch / max(label_total, 1),
    )


def _backend(device: torch.device) -> str:
    """The torch device, with the card's name on CUDA."""
    if device.type == "cuda":
        return f"{device} ({torch.cuda.get_device_name(device)})"
    return str(device)


def format_accuracy_report(result: dict) -> str:
    """Human-readable ACCURACY.md body for a benchmark result."""
    w = result["workload"]
    lines = [
        "# Accuracy evidence: pipeline vs golden oracle (metric deltas)",
        "",
        "Generated by `python -m groundgrid_torch accuracy` "
        "(`groundgrid_torch/eval/accuracy.py`). Both engines consumed the "
        f"identical {w.get('world', 'adversarial')} synthetic sequence; "
        "both outputs were scored "
        "with the reference scorer logic (`eval/metrics.py`, verified "
        "against `eval_groundpoint_classifier.py:135-195`).",
        "",
        f"- workload: {w['n_scans']} scans x ~{w['total_points'] // max(w['n_scans'], 1)}"
        f" pts (seed {w['seed']}, {w['n_beams']} beams x {w['n_azimuth']} azimuth,"
        f" step {w['step_m']} m, world={w.get('world', 'adversarial' if w.get('adversarial', True) else 'benign')}"
        + (f" variant={w['variant']} rain={w['rain_rate']}"
           if w.get("world") == "kitti" else "") + ")",
        f"- geometry: {w['dimension']} m / {w['resolution']} m => "
        f"{w['cells']}x{w['cells']} cells",
        f"- pipeline backend: {w['backend']}; wall {w['wall_s']:.0f} s "
        "(dominated by the pure-Python oracle)",
        "",
        "| metric | pipeline | golden | delta (pt) |",
        "|---|---|---|---|",
    ]
    for k in HEADLINE:
        lines.append(
            f"| {k} | {result['pipeline'][k] * 100:.4f}% "
            f"| {result['golden'][k] * 100:.4f}% "
            f"| {result['delta_pt'][k]:+.4f} |"
        )
    lines += [
        "",
        f"Max |delta| = **{result['max_abs_delta_pt']:.4f} pt** "
        "(acceptance bound: 0.1 pt out of the 0.5 pt budget, the rest "
        "reserved for the racy-reference gap, SURVEY.md §7).",
        f"Raw per-point label disagreement: "
        f"{result['label_mismatch_rate']:.3%}.",
    ]
    if "chaos_envelope_pt" in result:
        env = result["chaos_envelope_pt"]
        if result.get("chaos_mode") == "perm":
            desc = (
                "**Chaos control** (golden vs golden with the points fed in "
                "a permuted order -- the accumulation-order scrambling the "
                "reference's racing insert threads produce run to run, "
                "GroundSegmentation.cpp:200-310):"
            )
            closing = (
                "A pipeline-vs-golden delta at or below this envelope is "
                "indistinguishable from the reference's own run-to-run "
                "nondeterminism on this content. (Measured bitwise-ZERO: "
                "every value detect writes is order-invariant, so point "
                "order alone cannot separate two engines -- see the ulp "
                "control for the noise class that does.)"
            )
        else:
            desc = (
                "**Chaos control** (golden vs golden with the per-scan "
                "variance map nudged by +-1 float32 ulp per nonzero cell "
                "-- the smallest possible difference between two valid "
                "roundings of the same real-arithmetic variance, which "
                "detect thresholds at GroundSegmentation.cpp:369-382 and "
                "state feedback then amplifies):"
            )
            closing = (
                "A pipeline-vs-golden delta comparable to this envelope is "
                "intrinsic to ANY reimplementation that does not replicate "
                "the oracle's per-cell sequential arithmetic bit for bit; "
                "the racy reference does not replicate even its own "
                "(unsynchronized Welford writes from 8 threads corrupt "
                "variance far beyond 1 ulp)."
            )
        lines += [
            "",
            desc,
            "",
            "| metric | golden-vs-perturbed delta (pt) |",
            "|---|---|",
            *[f"| {k} | {env[k]:+.4f} |" for k in HEADLINE],
            "",
            f"Max |envelope| = {result['max_abs_chaos_envelope_pt']:.4f} pt. "
            + closing,
        ]
    lines += [
        "",
        "The adversarial world contains steep grades, retaining walls, "
        "bridge decks, porous vegetation, sub-surface mirror reflections "
        "(exercising the occlusion ray-march, GroundSegmentation.cpp:242-275) "
        "and 6-DoF pitched/rolled odometry (exercising the damage-fill "
        "base-plane math, GroundGrid.cpp:121-133).",
    ]
    return "\n".join(lines) + "\n"
