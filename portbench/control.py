"""The check's control: the reference put in the program's place, computed
a precision lower than the configuration states (bfloat16 for its f32 and
f64), must come out not correct.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...]

For each seed it draws the cell's traffic and check positions as a run
does, replays the first drive with the low-precision reference as the
system under test, keeping its outputs at the checked positions, and
compares them with the reference as a run compares the program's: one
card's block of the fleet at a time (where the cell compares the fleet
summary, the control's is its own counts over every block; a sorted-scan
cell's control takes the raw scans and counts no fallback). It
prints each number beside the cell's limit, one line a seed. Benchmark
runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import check, scenes  # noqa: E402
from portbench.bench import Cell, Context  # noqa: E402
from portbench.loops import Kept  # noqa: E402
from portbench.reference.groundgrid import GroundGridReference  # noqa: E402
from portbench.traffic import Schedule  # noqa: E402

LOW = torch.bfloat16


def control_numbers(root, workload: str, seed: int, device, low=LOW) -> dict:
    """The check's numbers with the ``low``-precision reference standing in
    for the program over the first drive of ``seed``'s traffic."""
    cell = Cell(root, workload)
    cx = Context(cell, seed, torch.device(device))
    cfg_points = int(cx.params["max_points"])
    pool = scenes.render_pool(cx.sensor, cell.traffic["scene"], int(cell.traffic["pool_scans"]),
                              float(cell.traffic["step_m"]), cfg_points, seed, cx.device)
    schedule = Schedule(cell.traffic, seed, pool.poses)
    drive_idx, drive_poses = schedule.drive_poses(0)
    tally = check.Tally()
    # one card's block of vehicles at a time, as a run's check compares them
    b = schedule.vehicles // cell.cards
    for vehicles in [slice(k * b, (k + 1) * b) for k in range(cell.cards)]:
        idx, poses = drive_idx[:, vehicles], drive_poses[:, vehicles]
        program = GroundGridReference(cx.params, idx.shape[1], cx.device, low, low)
        program.reset(poses[0])
        kept = {}
        for pos in range(max(cx.positions) + 1):
            rows = torch.as_tensor(idx[pos], device=pool.points.device)
            counts = [pool.counts[int(i)] for i in idx[pos]]
            labels, outlier = program.step(pool.points[rows], pool.rings[rows], counts,
                                           poses[pos])
            if pos in cx.positions:
                kept[pos] = Kept(labels.clone(), outlier.clone(), program.ground.float().clone(),
                                 program.groundpatch.float().clone(), program.center.copy())
        del program
        check.replay(cx.params, pool, schedule, 0, kept, cx.device, vehicles=vehicles,
                     tally=tally)
    if "summary_off" in cell.limits:
        # the summary the control hands over: its own counts over every block
        tally.summaries = {pos: c.copy() for pos, c in tally.counted.items()}
    numbers = tally.numbers()
    if "fallbacks_off" in cell.limits:
        # the control takes the raw scans: none reaches it out of order, none planted
        numbers["fallbacks_off"] = 0
    return numbers


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    root = Path(__file__).resolve().parent.parent
    limits = Cell(root, args.workload).limits
    for seed in args.seeds:
        numbers = control_numbers(root, args.workload, seed, args.device)
        verdict = check.verdict(numbers, limits)
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": verdict,
                          "numbers": numbers, "limits": limits}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
