"""Phase 2 of ``chip_smoke.py`` in several source trees, in turns, on one card.

    python3 kernel_turns.py _archive/parent .                  # parent, tree, tree, parent
    python3 kernel_turns.py _archive/parent . --kernels spiral

Each tree is the repository root or an unpacked ``git archive`` of a commit
(``_archive/`` is gitignored). The trees run in the given order, then in
reverse. Each turn is its own process, started in the tree's root, so it
imports that tree's ``chip_smoke`` and ``groundgrid_torch`` and builds that
tree's kernels; it renders five synthetic scans, warms a driver on four and
calls the tree's own phase-2 checks (``check_raster`` .. ``check_detect``),
which hold each kernel against its plain version, then time it. With
``lookup``, every turn also times its tree's K2 on the march lattice of a
warm scan by this script's own ``chip_smoke.check_lookup_march`` (the
same measurement in every tree, older trees having none). A turn prints the
tree's environment lines and, last, one JSON line with what each check
returned; this script echoes them and ends with one JSON line of all turns.
It fails if a turn fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

KERNELS = ("raster", "lookup", "spiral", "detect")

# run with the tree's root as the working directory: ``python -c`` puts it
# first on sys.path
_TURN = """
import importlib.util, inspect, json, sys
import torch
import chip_smoke as cs
from groundgrid_torch.config import GroundGridConfig
from groundgrid_torch.runtime.bench import synthetic_records

cs.phase_environment()
config = GroundGridConfig(sorted_scans=True)
records = synthetic_records(config, 5)
driver = cs.warm_driver(config, records, torch.device("cuda", 0))


def keep(result):  # a check's record, without the tensors some checks also return
    if isinstance(result, tuple):
        return [r for r in result if not isinstance(r, torch.Tensor)]
    return result


out = {}
for name in sys.argv[2:]:
    if name == "lookup":
        cell = cs.prepared(config, driver, records[4])[1].cell
        extra = (records[4],) if len(inspect.signature(cs.check_lookup).parameters) > 3 else ()
        out[name] = keep(cs.check_lookup(config, driver, cell, *extra))
        # the march lattice, measured by the calling tree's probe in every tree
        spec = importlib.util.spec_from_file_location("turns_probe", sys.argv[1])
        probe = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(probe)
        out["lookup_march"] = probe.check_lookup_march(config, driver, records[4])
    else:
        out[name] = keep(getattr(cs, "check_" + name)(config, driver, records[4]))
print(json.dumps(out))
"""

# this script's own chip_smoke.py: the probe of the march lattice
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
    parser.add_argument("--kernels", nargs="+", choices=KERNELS, default=list(KERNELS))
    args = parser.parse_args(argv)
    for tree in args.trees:
        if not os.path.isfile(os.path.join(tree, "chip_smoke.py")):
            parser.error(f"{tree} holds no chip_smoke.py")
    turns = []
    for tree in args.trees + args.trees[::-1]:
        turns.append(turn(tree, args.kernels))
        print(json.dumps(turns[-1]), flush=True)
    print(json.dumps({"turns": turns}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
