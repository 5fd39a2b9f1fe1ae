"""Phase 2 of ``chip_smoke.py`` in several source trees, in turns, on one card.

    python3 kernel_turns.py _archive/parent .                  # parent, tree, tree, parent
    python3 kernel_turns.py _archive/parent . --kernels spiral
    python3 kernel_turns.py _archive/parent . --kernels step lookup
    python3 kernel_turns.py _archive/parent . --kernels binning raster_stage step
    python3 kernel_turns.py _archive/parent . --kernels march select move step

Each tree is the repository root or an unpacked ``git archive`` of a commit
(``_archive/`` is gitignored). The trees run in the given order, then in
reverse. Each turn is its own process, started in the tree's root, so it
imports that tree's ``chip_smoke`` and ``groundgrid_torch`` and builds that
tree's kernels; it renders five synthetic scans, warms a driver on four and
calls the tree's own phase-2 checks (``check_raster`` .. ``check_detect``),
which hold each kernel against its plain version, then time it (a check
that takes a fourth argument, as ``check_detect`` does for its 1200^2
case, gets the five rendered scans). With
``lookup``, every turn also times its tree's K2 on the march lattice of a
warm scan by this script's own ``chip_smoke.check_lookup_march`` (the
same measurement in every tree whose plain march takes the moved layers
and K6's directions, as this one does); with ``detect_stage``, its tree's
K8 on a batch of 64 grids at 364^2 by this script's own
``chip_smoke.stage_batch`` (``detect_stage_b64``); with ``binning``, its
tree's K5 on a batch of 64 prepared scans by ``chip_smoke.bin_batch``
(``binning_b64``); with ``select``, its tree's K11 on 64 warm scans'
budgets and keys by ``chip_smoke.select_batch`` (``select_b64``); with
``move``, its tree's K12 on 64 grids by ``chip_smoke.move_batch``
(``move_b64``) and at 1200^2 by ``chip_smoke.move_highres``
(``move_1200``). A turn prints the
tree's environment lines and, last, one JSON line with what each check
returned; this script echoes them and ends with one JSON line of all turns.
It fails if a turn fails. ``binning``, ``march`` (K5-K7), ``detect_stage``
(K8), ``raster_stage`` (K9, K10), ``select`` (K11) and ``move`` (K12)
exist only in trees that have them: a tree without the check records null
for it. ``step`` times the whole step in each tree
on 32 rendered scans: the streaming bench's device ms a scan (the captured
step), ``bench --profile``'s busy ms and device activities a step (and,
where the tree has them, the eager step's stages and the raster stage's
parts), K1's device ms inside the eager and the captured step (by this
script's own ``chip_smoke.k1_in_step``), and the unsorted fleet
of 64's device ms a tick; it also digests the captured step's outputs on
those scans, sorted and unsorted (labels, outlier flags, marchable counts,
the last state), and the last line says whether every turn's digest is
the same (``same_outputs``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

KERNELS = ("raster", "lookup", "spiral", "detect", "binning", "march", "detect_stage",
           "raster_stage", "select", "move", "step")

# run with the tree's root as the working directory: ``python -c`` puts it
# first on sys.path
_TURN = """
import importlib.util, inspect, json, sys
import torch
import chip_smoke as cs
from groundgrid_torch.config import GroundGridConfig
from groundgrid_torch.runtime.bench import synthetic_records

cs.phase_environment()
device = torch.device("cuda", 0)
config = GroundGridConfig(sorted_scans=True)
records = synthetic_records(config, 32 if "step" in sys.argv[2:] else 5)
driver = cs.warm_driver(config, records, device)


def outputs_digest():
    # sha256 of what the captured step gives over the rendered scans, sorted
    # and unsorted: labels, outlier flags and marchable counts a scan, the
    # last state's layers
    import hashlib
    from groundgrid_torch.runtime.driver import StreamingDriver

    h = hashlib.sha256()
    for cfg in (config, GroundGridConfig()):
        d = StreamingDriver(cfg, device)
        for rec in records:
            res = d.process(rec)
            h.update(res.labels.tobytes() + res.outlier.tobytes())
            h.update(str(d.step.marchable).encode())
        h.update(d.state.ground.cpu().numpy().tobytes())
        h.update(d.state.groundpatch.cpu().numpy().tobytes())
    return h.hexdigest()


def step_turn():
    # the step end to end: the streaming bench's device ms a scan (the
    # captured step), bench --profile's summary lines, K1's device ms inside
    # the eager and the captured step (by the calling tree's probe), the
    # unsorted fleet of 64's device ms a tick (one batched step) and the
    # outputs' digest
    from groundgrid_torch.runtime import bench
    from groundgrid_torch.runtime.driver import StreamingDriver

    streaming = StreamingDriver(config, device)
    for rec in records[:3]:
        streaming.process(rec)
    steps, _ = bench.device_ms_per_step(streaming, records)
    profile = bench.profile_steps(device=device).splitlines()
    keep = ("eager step", "  stage", "    part", "  outside", "device busy")
    fleet = bench.run_fleet_benchmark(GroundGridConfig(), records[:8], 64, 128, 3, device)
    return {"device_ms_per_scan": sum(steps) / len(steps),
            "profile": [line for line in profile if line.startswith(keep)],
            "k1_in_step": probe.k1_in_step(config, records, device),
            "fleet_unsorted_device_ms_per_tick": fleet["device_ms_per_tick"],
            "fleet_unsorted_batched": fleet["batched"], "outputs_digest": outputs_digest()}


def keep(result):  # a check's record, without the tensors some checks also return
    if isinstance(result, tuple):
        return [r for r in result if not isinstance(r, torch.Tensor)]
    return result


# this script's own chip_smoke: measurements made the same way in every tree
spec = importlib.util.spec_from_file_location("turns_probe", sys.argv[1])
probe = importlib.util.module_from_spec(spec)
spec.loader.exec_module(probe)
out = {}
for name in sys.argv[2:]:
    if name == "step":
        out[name] = step_turn()
    elif name == "lookup":
        cell = cs.prepared(config, driver, records[4])[-2].cell  # the binning
        extra = (records[4],) if len(inspect.signature(cs.check_lookup).parameters) > 3 else ()
        out[name] = keep(cs.check_lookup(config, driver, cell, *extra))
        # the march lattice, measured by the calling tree's probe in every tree
        out["lookup_march"] = probe.check_lookup_march(config, driver, records[4])
    elif not hasattr(cs, "check_" + name):
        out[name] = None  # the tree has no such kernel
    else:
        check = getattr(cs, "check_" + name)
        extra = (records,) if len(inspect.signature(check).parameters) > 3 else ()
        out[name] = keep(check(config, driver, records[4], *extra))
        if name == "detect_stage":  # K8 at B = 64, by the calling tree's probe
            out["detect_stage_b64"] = probe.stage_batch(config, driver, records)
        if name == "binning":  # K5 at B = 64, by the calling tree's probe
            out["binning_b64"] = probe.bin_batch(config, driver, records)
        if name == "select":  # K11 at B = 64, by the calling tree's probe
            out["select_b64"] = probe.select_batch(config, driver, records)
        if name == "move":  # K12 at B = 64 and at 1200^2, by the calling tree's probe
            out["move_b64"] = probe.move_batch(config, driver, records)
            out["move_1200"] = probe.move_highres(config, driver, records[4:5])
print(json.dumps(out))
"""

# this script's own chip_smoke.py: the probes (the march lattice, K8 at B = 64)
_PROBE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chip_smoke.py")


def turn(tree: str, kernels: list[str]) -> dict:
    root = os.path.abspath(tree)
    proc = subprocess.run([sys.executable, "-c", _TURN, _PROBE, *kernels], cwd=root,
                          capture_output=True, text=True, timeout=900)
    sys.stderr.write(proc.stderr)
    lines = proc.stdout.strip().splitlines()
    for line in lines[:-1]:
        print(f"[{tree}] {line}", flush=True)
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"turn in {tree} failed with exit code {proc.returncode}")
    return {"tree": tree, "checks": json.loads(lines[-1])}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("trees", nargs="+", help="source trees, in the order of the first pass")
    parser.add_argument("--kernels", nargs="+", choices=KERNELS, default=list(KERNELS[:4]))
    args = parser.parse_args(argv)
    for tree in args.trees:
        if not os.path.isfile(os.path.join(tree, "chip_smoke.py")):
            parser.error(f"{tree} holds no chip_smoke.py")
    turns = []
    for tree in args.trees + args.trees[::-1]:
        turns.append(turn(tree, args.kernels))
        print(json.dumps(turns[-1]), flush=True)
    digests = {t["checks"]["step"]["outputs_digest"] for t in turns if "step" in t["checks"]}
    print(json.dumps({"turns": turns, "same_outputs": len(digests) == 1 if digests else None}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
