"""Command-line interface of the port: evaluate / playback / accuracy / bench.

The torch counterpart of ``groundgrid_tpu/runtime/cli.py``, with its flags,
output lines and JSON payload, on one explicit ``--device`` (default
``cuda``; without a card it raises, nothing falls back to the CPU):

  * ``evaluate`` == KITTIEvaluate.launch: lock-step playback + scorer with
    the every-500-clouds statistics print (eval_groundpoint_classifier.py:123);
    ``--sequence 00-10`` aggregates, ``--on-device-eval`` scores on the device
  * ``playback`` == KITTIPlayback.launch: stream a sequence, log timing,
    optionally export layer images, terrain artifacts, an HTML player or a
    live viewer
  * ``accuracy`` == the pipeline-vs-golden metric deltas on synthetic worlds
    (``eval/accuracy.py``), exit code 0 within ``--budget-pt``
  * ``bench``    == the port's synthetic throughput benchmark (one JSON line);
    ``--batch B`` above 1 runs a fleet of B vehicles (``runtime/fleet.py``)

Sorted-scan mode is the default (the JAX CLI's default on its accelerator);
``--no-sorted`` runs unsorted mode, where ``--native-loader`` reads raw scans
in the C++ threads and the step transforms and sorts on the device.

    python -m groundgrid_torch evaluate --directory <kitti_root> --sequence 00
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from groundgrid_torch.config import GroundGridConfig
from groundgrid_torch.data import native_loader
from groundgrid_torch.data.semantickitti import SemanticKITTI
from groundgrid_torch.eval.baseline import format_baseline_comparison
from groundgrid_torch.eval.metrics import Evaluator
from groundgrid_torch.runtime import viz
from groundgrid_torch.runtime.checkpoint import load_state, save_state
from groundgrid_torch.runtime.driver import StreamingDriver
from groundgrid_torch.runtime.evaluate import evaluate_records
from groundgrid_torch.runtime.live import LiveServer


def _add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; raises without a card)")


def _add_sorted(p: argparse.ArgumentParser) -> None:
    p.add_argument("--sorted", dest="sorted_scans", action="store_true", default=None,
                   help="sorted-scan mode: host transform and cell sort (the default)")
    p.add_argument("--no-sorted", dest="sorted_scans", action="store_false",
                   help="unsorted mode: raw scans, transformed and sorted on the device")


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--dimension", type=float, default=120.0)
    p.add_argument("--resolution", type=float, default=0.33)
    p.add_argument("--max-points", type=int, default=131072)
    p.add_argument("--start", type=float, default=0.0, help="start seconds (player start)")
    p.add_argument("--end", type=float, default=float("inf"), help="end seconds (player end)")
    _add_sorted(p)
    p.add_argument("--wire", action="store_true",
                   help="s16 quantized wire format (~2.5x smaller ingest, ~1-2 mm lossy)")
    p.add_argument("--native-loader", action="store_true",
                   help="prepare scans in the C++ prefetching loader's threads")
    p.add_argument("--pipeline-depth", type=int, default=0,
                   help="scans dispatched ahead of the fetch (0 = lock-step; "
                        "bitwise-identical results; incompatible with "
                        "--checkpoint; --on-device-eval fetches nothing per scan)")
    p.add_argument("--checkpoint", default="",
                   help="grid-state checkpoint file (.npz) to write "
                        "periodically (and resume from with --resume)")
    p.add_argument("--checkpoint-every", type=int, default=500,
                   help="checkpoint cadence in scans (default 500)")
    p.add_argument("--resume", action="store_true",
                   help="resume from --checkpoint if it exists (written by either "
                        "package; bitwise continuation of the uninterrupted run)")
    _add_device(p)


def _device(args) -> torch.device:
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: CUDA is not available "
                           "(nothing falls back to the CPU; pass --device cpu)")
    return device


def _sorted_mode(args) -> bool:
    """``--sorted`` / ``--no-sorted``; sorted by default."""
    return args.sorted_scans is not False


def _config(args) -> GroundGridConfig:
    wire = bool(args.wire)
    return GroundGridConfig(dimension=args.dimension, resolution=args.resolution,
                            max_points=args.max_points,
                            sorted_scans=wire or _sorted_mode(args), wire_format=wire)


def _records(ds, cfg, args, device, start_index=None, center64=None):
    """The record stream of the ``--start`` / ``--end`` player window.

    With ``--native-loader`` the prefetching loader starts at the first
    in-window scan, binning against the center track a driver starting there
    keeps (from ``center64``, a resumed driver's center, if given), and is
    closed when the stream ends; in unsorted mode it is the raw loader,
    which reads and truncates to ``max_points``, as the JAX CLI's does.
    ``start_index`` (resume) also skips already-processed scans.
    """
    first = ds.seek_index(args.start) if args.start > 0 else 0
    if start_index is not None:
        first = max(first, int(start_index))
    end = args.end

    if not args.native_loader:
        def gen_raw():
            for idx in range(first, len(ds)):
                if float(ds.times[idx]) > end:
                    return
                yield ds.read_scan(idx)
        return gen_raw()

    if cfg.sorted_scans:
        kind = native_loader.WirePrefetchingLoader if cfg.wire_format \
            else native_loader.SortedPrefetchingLoader
        loader = kind(ds, cfg, device, start=first, center64=center64)
    else:
        kind = native_loader.PrefetchingLoader
        loader = kind(ds, cap=cfg.max_points)
        if first:
            loader.seek(first)
    if not loader.native:
        print(f"warning: {kind.__name__} is not native (native/loader.cpp did not "
              "build); preparing scans in NumPy", file=sys.stderr, flush=True)

    def gen_native():
        try:
            for rec in loader:
                if rec.timestamp > end:
                    return
                yield rec
        finally:
            loader.close()
    return gen_native()


def _load_resume(args, cfg, device):
    """``(state, next_index, extra)`` from --checkpoint when resuming, else None."""
    if not (args.resume and args.checkpoint and os.path.exists(args.checkpoint)):
        return None
    return load_state(args.checkpoint, cfg, device)


def _parse_sequences(spec: str) -> list[str]:
    """'00' | '3' | '00-10' | '00,02,05' -> list of zero-padded ids."""
    out: list[str] = []
    for part in spec.split(","):
        part = part.strip()
        if "-" in part:
            lo, hi = part.split("-")
            out.extend(f"{s:02d}" for s in range(int(lo), int(hi) + 1))
        else:
            out.append(f"{int(part):02d}")
    return out


def _depth_and_checkpoint(args) -> bool:
    if args.pipeline_depth > 0 and args.checkpoint:
        # with scans in flight the grid state runs ahead of the yielded
        # result, so a checkpoint would pair state(t+d) with index t+1
        print("--pipeline-depth and --checkpoint are mutually exclusive "
              "(in-flight scans make the checkpointed state run ahead of "
              "the stream position)", file=sys.stderr)
        return True
    return False


def cmd_evaluate(args) -> int:
    """Lock-step evaluation over one or more sequences.

    A single sequence reproduces KITTIEvaluate.launch; a range like
    ``--sequence 00-10`` runs the aggregate evaluation (BASELINE.json
    config 3): the grid resets between sequences, one confusion table
    accumulates.
    """
    cfg = _config(args)
    device = _device(args)
    if _depth_and_checkpoint(args):
        return 2
    sequences = _parse_sequences(str(args.sequence))
    name = sequences[0] if len(sequences) == 1 else ",".join(sequences)
    per_seq = {}
    if args.on_device_eval:
        if args.checkpoint:
            print("error: --checkpoint is not supported with --on-device-eval "
                  "(confusion counts live on device)", file=sys.stderr)
            return 2
        ev = Evaluator(name)
        total_stats = None
        for seq in sequences:
            ds = SemanticKITTI(args.directory, seq)
            seq_ev, total_stats = evaluate_records(cfg, _records(ds, cfg, args, device), seq,
                                                   device)
            per_seq[seq] = seq_ev.compute().as_dict()
            ev.nonground_count += seq_ev.nonground_count
            ev.true_positive += seq_ev.true_positive
            ev.false_positive += seq_ev.false_positive
            ev.total += seq_ev.total
            ev.clouds += seq_ev.clouds
    else:
        driver = StreamingDriver(cfg, device)
        ev = Evaluator(name)
        seq_start, resume_index = 0, None
        resumed = _load_resume(args, cfg, device)
        if resumed is not None:
            state, resume_index, extra = resumed
            driver.restore(state, center64=extra.get("center64"))
            ev.load_state_dict(extra["evaluator"])
            per_seq = extra.get("per_sequence", {})
            if extra.get("sequence") in sequences:
                seq_start = sequences.index(extra["sequence"])
            print(f"resumed at sequence {sequences[seq_start]} "
                  f"scan {resume_index} ({ev.clouds} clouds scored)",
                  file=sys.stderr, flush=True)
        for si, seq in enumerate(sequences[seq_start:], start=seq_start):
            ds = SemanticKITTI(args.directory, seq)
            seq_ev = Evaluator(seq)
            first = None
            if si == seq_start and resume_index is not None:
                seq_ev.load_state_dict(resumed[2]["seq_evaluator"])
                first = resume_index
            else:
                driver.reset()
            for res, gt_labels, rec_index in _scored_results(
                    driver, _records(ds, cfg, args, device, start_index=first,
                                     center64=driver.center64), args):
                ev.add_cloud(res.labels, gt_labels)
                seq_ev.add_cloud(res.labels, gt_labels)
                if ev.clouds % 500 == 0:  # reference cadence (:123-124)
                    print(ev.format_statistics(), flush=True)
                if (args.checkpoint and args.checkpoint_every > 0
                        and ev.clouds % args.checkpoint_every == 0):
                    save_state(args.checkpoint, driver.state, rec_index + 1, cfg,
                               extra=dict(evaluator=ev.state_dict(),
                                          seq_evaluator=seq_ev.state_dict(),
                                          sequence=seq, per_sequence=per_seq),
                               center64=driver.center64)
            per_seq[seq] = seq_ev.compute().as_dict()
        total_stats = driver.stats
    print(ev.format_statistics(), flush=True)
    m = ev.compute()
    if sequences == ["00"]:
        # the reference's only published result is the seq-00 table
        # (BASELINE.md): print the side-by-side comparison
        print(format_baseline_comparison(m.as_dict(), ev.clouds), flush=True)
    payload = dict(
        sequences=sequences,
        scans=ev.clouds,
        avg_ms=total_stats.avg_ms if total_stats else None,
        scans_per_sec=total_stats.scans_per_sec if total_stats else None,
        # depth > 0: avg_ms is dispatch-to-fetch latency including pipeline
        # residency, not comparable to lock-step latency
        pipeline_depth=total_stats.pipeline_depth if total_stats else args.pipeline_depth,
        **m.as_dict(),
    )
    if len(sequences) > 1:
        payload["per_sequence"] = per_seq
    print(json.dumps(payload), flush=True)
    return 0


def _scored_results(driver, records, args):
    """Yield ``(result, gt_labels, record_index)``, pipelined under
    ``--pipeline-depth``.

    Ground-truth labels of in-flight scans wait in a side map keyed by scan
    index until their result arrives (results stay in order).
    """
    pending = {}

    def tap():
        for rec in records:
            pending[rec.index] = rec.labels
            yield rec

    for res in driver.run(tap(), pipeline_depth=args.pipeline_depth):
        gt = pending.pop(res.index)
        # entries below res.index belong to scans the driver dropped
        # (non-finite pose) and would otherwise leak for the whole run
        for stale in [k for k in pending if k < res.index]:
            del pending[stale]
        yield res, gt, res.index


def cmd_playback(args) -> int:
    cfg = _config(args)
    device = _device(args)
    ds = SemanticKITTI(args.directory, args.sequence)
    if _depth_and_checkpoint(args):
        return 2
    want_aux = bool(args.export_layers or args.export_terrain
                    or args.export_html or args.serve is not None)
    driver = StreamingDriver(cfg, device, with_aux=want_aux)
    recorder = None
    if args.export_html:
        recorder = viz.SequenceRecorder(max_frames=args.html_max_frames,
                                        embed_3d_every=args.html_3d_every)
    live = None
    if args.serve is not None:
        live = LiveServer(port=args.serve).start()
        print(f"live viewer at {live.url} (follow mode; space pauses)",
              file=sys.stderr, flush=True)
    resume_index = None
    resumed = _load_resume(args, cfg, device)
    if resumed is not None:
        state, resume_index, extra = resumed
        driver.restore(state, center64=extra.get("center64"))
        print(f"resumed at scan {resume_index}", file=sys.stderr, flush=True)
    prev_ts = None
    for res in driver.run(_records(ds, cfg, args, device, start_index=resume_index,
                                   center64=driver.center64),
                          pipeline_depth=args.pipeline_depth):
        if args.rate > 0 and prev_ts is not None:
            # real-time pacing like the player's sim clock
            # (kitti_data_publisher.py:80-109)
            budget = (res.timestamp - prev_ts) / args.rate - res.wall_ms / 1000.0
            if budget > 0:
                time.sleep(budget)
        prev_ts = res.timestamp
        n_ground, n_nonground = int((res.labels == 49).sum()), int((res.labels == 99).sum())
        print(f"scan {res.index}: {res.n_points} pts ground={n_ground} "
              f"nonground={n_nonground} {res.wall_ms:.1f} ms "
              f"(avg {driver.stats.avg_ms:.1f} ms, {driver.stats.scans_per_sec:.1f} scans/s)",
              flush=True)
        center = driver.state.center_np
        if args.export_layers and res.index % args.export_every == 0:
            viz.export_layers(res.aux, args.export_layers, prefix=f"{res.index:06d}_")
        if args.export_terrain and res.index % args.export_every == 0:
            viz.save_terrain_artifact(args.export_terrain, res.aux["ground"],
                                      res.aux["points_raw"], res.index,
                                      float(center[0]), float(center[1]))
        if (recorder is not None or live is not None) and res.index % args.html_every == 0:
            caption = f"scan {res.index}  ground={n_ground} nonground={n_nonground}"
            layer = res.aux["ground"]
            # z0: terrain height under the vehicle (the reference's "car
            # cell", GroundGridNodelet.cpp:254) anchors the 3-D view
            c = layer.shape[0] // 2
            frame = dict(caption=caption, layer=layer, z=res.z, z0=float(layer[c, c]),
                         resolution=cfg.resolution)
            for sink in (recorder, live):
                if sink is not None:
                    sink.add(res.x, res.y, res.labels, center, **frame)
        if (args.checkpoint and args.checkpoint_every > 0
                and (res.index + 1) % args.checkpoint_every == 0):
            save_state(args.checkpoint, driver.state, res.index + 1, cfg,
                       center64=driver.center64)
    if recorder is not None:
        out = recorder.write_html(args.export_html, title=f"groundgrid-torch seq {args.sequence}")
        note = f" ({recorder.dropped} frames past capacity dropped)" if recorder.dropped else ""
        print(f"wrote {len(recorder.frames)}-frame player to {out}{note}", flush=True)
    if live is not None:
        live.finish()
        if args.serve_linger != 0:
            print(f"sequence done; live viewer stays at {live.url} (Ctrl-C to exit)",
                  file=sys.stderr, flush=True)
            try:
                if args.serve_linger < 0:
                    while True:
                        time.sleep(3600)
                time.sleep(args.serve_linger)
            except KeyboardInterrupt:
                pass
        live.stop()
    return 0


def cmd_accuracy(args) -> int:
    """Pipeline-vs-golden metric deltas on synthetic scans (``eval/accuracy.py``).

    Exit code 0 when max |delta| is within ``--budget-pt`` (or, with
    ``--chaos-control``, within the perturbed oracle's envelope). Writes the
    markdown report to ``--output``, else prints it; the last line is JSON.
    """
    from groundgrid_torch.eval.accuracy import format_accuracy_report, run_accuracy_benchmark

    device = _device(args)
    cfg = GroundGridConfig(dimension=args.dimension, resolution=args.resolution,
                           max_points=args.max_points, sorted_scans=_sorted_mode(args))
    result = run_accuracy_benchmark(
        cfg, n_scans=args.scans, seed=args.seed, n_beams=args.beams,
        n_azimuth=args.azimuth, step_m=args.step, adversarial=not args.benign,
        progress=lambda s: print(s, file=sys.stderr, flush=True),
        chaos_control=(args.chaos_mode if args.chaos_control else False),
        world=args.world, variant=args.variant, rain_rate=args.rain, device=device,
    )
    report = format_accuracy_report(result)
    if args.output:
        with open(args.output, "w") as f:
            f.write(report)
        print(f"wrote {args.output}", file=sys.stderr, flush=True)
    else:
        print(report, flush=True)
    keys = ["workload", "pipeline", "golden", "delta_pt", "max_abs_delta_pt",
            "label_mismatch_rate"]
    if "chaos_envelope_pt" in result:
        keys += ["chaos_envelope_pt", "max_abs_chaos_envelope_pt"]
    print(json.dumps({k: result[k] for k in keys}), flush=True)
    ok = result["max_abs_delta_pt"] < args.budget_pt or (
        "max_abs_chaos_envelope_pt" in result
        and result["max_abs_delta_pt"] <= result["max_abs_chaos_envelope_pt"])
    return 0 if ok else 1


def cmd_bench(args) -> int:
    from groundgrid_torch.runtime.bench import run_benchmark

    result = run_benchmark(n_scans=args.scans, batch=args.batch, resolution=args.resolution,
                           dimension=args.dimension, device=args.device)
    print(json.dumps(result), flush=True)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="groundgrid-torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p_eval = sub.add_parser("evaluate", help="lock-step sequence evaluation")
    p_eval.add_argument("--directory", required=True, help="SemanticKITTI root")
    p_eval.add_argument("--sequence", default="00", help="'00', '00-10' or '00,05'")
    p_eval.add_argument("--on-device-eval", action="store_true",
                        help="score on device (no per-scan host fetch)")
    _add_common(p_eval)
    p_eval.set_defaults(func=cmd_evaluate)

    p_play = sub.add_parser("playback", help="stream a sequence, log timing")
    p_play.add_argument("--directory", required=True)
    p_play.add_argument("--sequence", default="00")
    p_play.add_argument("--export-layers", default="", help="dir for layer PNGs")
    p_play.add_argument("--export-terrain", default="", help="dir for terrain artifacts")
    p_play.add_argument("--export-every", type=int, default=100)
    p_play.add_argument("--export-html", default="",
                        help="write an interactive HTML sequence player (RViz "
                             "playback substitute) to this path")
    p_play.add_argument("--html-every", type=int, default=5,
                        help="record every Nth scan into the HTML player")
    p_play.add_argument("--html-max-frames", type=int, default=400)
    p_play.add_argument("--html-3d-every", type=int, default=0,
                        help="embed a packed 3-D cloud for every Nth RECORDED "
                             "frame in the HTML player (0 = off; ~0.7 MB each, "
                             "capped at 40)")
    p_play.add_argument("--serve", type=int, default=None, metavar="PORT",
                        help="serve a LIVE browser viewer of the running "
                             "sequence on this port (0 = ephemeral; every "
                             "--html-every scans)")
    p_play.add_argument("--serve-linger", type=int, default=-1,
                        help="seconds to keep the live viewer up after the "
                             "sequence ends (-1 = until Ctrl-C, 0 = exit "
                             "immediately)")
    p_play.add_argument("--rate", type=float, default=0.0,
                        help="real-time pacing factor (0 = as fast as possible)")
    _add_common(p_play)
    p_play.set_defaults(func=cmd_playback)

    p_acc = sub.add_parser("accuracy",
                           help="pipeline-vs-golden metric deltas on synthetic worlds")
    p_acc.add_argument("--scans", type=int, default=120)
    p_acc.add_argument("--seed", type=int, default=17)
    p_acc.add_argument("--beams", type=int, default=64)
    p_acc.add_argument("--azimuth", type=int, default=1800)
    p_acc.add_argument("--step", type=float, default=1.2, help="metres per scan")
    p_acc.add_argument("--benign", action="store_true",
                       help="use the benign scene generator instead")
    p_acc.add_argument("--world", choices=("", "kitti"), default="",
                       help="kitti: the KITTI-operating-point urban world "
                            "(data/kitti_world.py); default: the adversarial "
                            "(or --benign) world")
    p_acc.add_argument("--variant", choices=("city", "forward"), default="city",
                       help="kitti world drive plan: city = cruise + stop + reverse + "
                            "exact-half-cell + moving cars; forward = pure cruise")
    p_acc.add_argument("--rain", type=float, default=0.0,
                       help="kitti world rain rate (ring dropout + airborne clutter)")
    p_acc.add_argument("--output", default="", help="markdown report path")
    p_acc.add_argument("--budget-pt", type=float, default=0.1,
                       help="max |delta| in percentage points for exit code 0")
    p_acc.add_argument("--chaos-control", action="store_true",
                       help="also run a perturbed golden to measure the scene's "
                            "intrinsic metric sensitivity (see --chaos-mode); deltas "
                            "within that envelope also exit 0")
    p_acc.add_argument("--chaos-mode", choices=("ulp", "perm"), default="ulp",
                       help="ulp: +-1-ulp variance nudge; perm: point-order permutation")
    p_acc.add_argument("--dimension", type=float, default=120.0)
    p_acc.add_argument("--resolution", type=float, default=0.33)
    p_acc.add_argument("--max-points", type=int, default=131072)
    _add_sorted(p_acc)
    _add_device(p_acc)
    p_acc.set_defaults(func=cmd_accuracy)

    p_bench = sub.add_parser("bench", help="synthetic throughput benchmark (CUDA only)")
    p_bench.add_argument("--scans", type=int, default=64)
    p_bench.add_argument("--batch", type=int, default=1)
    p_bench.add_argument("--dimension", type=float, default=120.0)
    p_bench.add_argument("--resolution", type=float, default=0.33)
    _add_device(p_bench)
    p_bench.set_defaults(func=cmd_bench)

    args = parser.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
