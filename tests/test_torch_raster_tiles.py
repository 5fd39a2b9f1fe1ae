"""The split of K1's work (``ops/raster.py tile_plan``, the Python twin of the
split in ``csrc/raster.cu``), on the CPU.

Block b of the kernel takes ``tile`` items of the merged order of points
and cell ends, folds every run that starts among its points (to its end,
past its points if it goes on) and zeroes the empty cells whose ends it
holds. These tests hold the plan to the kernel's contract over cell
distributions that stress it (one cell, all overflow, runs of 1 to 5,000
points across one, two and many blocks, gaps before the first and after
the last real id, point counts that are no multiple of the tile or of 4):
no block holds more than ``tile`` points and cells; every real point is
folded once, by its run's owner, in point order; no point of the overflow
bin is folded; every cell of [0, n2) is written by exactly one block, an
empty cell known as empty from what the kernel's bitmap holds (the cells
of the block's runs, of its first point and of the point before it).
Executing the plan so is bitwise the plain version.
"""

import numpy as np
import pytest
import torch

from groundgrid_torch.ops import raster
from groundgrid_torch.ops.raster import OPS, TILE, tile_plan

N2 = 70 * 70
RUN_LENGTHS = [1, 2, 5, 255, 256, 257, 1023, 1024, 1025, 2047, 2049, 5000]


def _runs(rng, lengths, n2, first=0, last=None):
    """Sorted ids: the given run lengths in random order on distinct random
    cells of [first, last], ascending."""
    last = n2 - 1 if last is None else last
    cells = np.sort(rng.choice(np.arange(first, last + 1), len(lengths), replace=False))
    return np.repeat(cells, rng.permutation(lengths)).astype(np.int32)


def _cells(kind, seed=0, n2=N2):
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return np.sort(rng.integers(0, n2 + 1, 4097)).astype(np.int32)
    if kind == "one_cell":
        return np.full(3001, 1234 % n2, np.int32)
    if kind == "overflow":
        return np.full(2050, n2, np.int32)
    if kind == "one_long_run":  # across many tiles, then padding
        return np.concatenate([np.full(5000, 17, np.int32), np.full(3, n2, np.int32)])
    if kind == "long_runs":  # runs of 1 to 5,000 points across 1, 2 and many tiles
        return _runs(rng, RUN_LENGTHS, n2)
    if kind == "gaps":  # first id > 0, last real id < n2 - 1, an overflow tail
        edge = max(2, n2 // 10)
        ids = _runs(rng, [3, 700, 1, 1, 40, 1500, 9], n2, first=edge, last=n2 - edge)
        return np.concatenate([ids, np.full(77, n2, np.int32)])
    if kind == "tile_edges":  # runs that end exactly at and just past tile edges
        return _runs(rng, [TILE - 1, 1, TILE, TILE + 1, 2 * TILE - 1, 3], n2)
    if kind == "single":
        return np.array([n2 - 1], np.int32)
    raise KeyError(kind)


KINDS = ["uniform", "one_cell", "overflow", "one_long_run", "long_runs", "gaps", "tile_edges",
         "single"]


def _check_plan(cell, n2, tile):
    plan = tile_plan(cell, n2, tile)
    p = cell.shape[0]
    # the blocks' points and cell ends partition [0, P) and [0, n2), in order
    assert plan[0].start == 0 and plan[-1].end == p
    assert plan[0].cells[0] == 0 and plan[-1].cells[1] == n2
    for a, b in zip(plan, plan[1:]):
        assert a.end == b.start and a.cells[1] == b.cells[0]
    for b in plan:
        lo, hi = b.cells
        assert b.start <= b.end and lo <= hi
        assert (b.end - b.start) + (hi - lo) <= tile  # at most tile points and cells
    folded = np.zeros(p, np.int64)
    run_cells = []
    for b in plan:
        for c, first, stop in b.runs:
            assert b.start <= first < b.end  # owned by the block holding its first point
            assert first == 0 or cell[first - 1] != c  # a run head
            assert (cell[first:stop] == c).all() and (stop == p or cell[stop] != c)
            assert c >= b.cells[0]  # at or after the block's first cell end
            folded[first:stop] += 1
            run_cells.append(c)
    real = (cell >= 0) & (cell < n2)
    np.testing.assert_array_equal(folded, real.astype(np.int64))  # each real point once
    assert len(set(run_cells)) == len(run_cells) == len(np.unique(cell[real]))
    return plan


def _marked(b, cell):
    """The cells with points that the kernel's bitmap holds for block b."""
    marks = {c for c, _, _ in b.runs}
    if b.end > b.start:
        marks.add(int(cell[b.start]))
    if b.start > 0:
        marks.add(int(cell[b.start - 1]))
    return marks


def _execute(plan, cell, cols, ops, n2):
    """The plan carried out as the kernel does: every run folded in point
    order (sums from 0.0, extrema from the first value, the earlier value
    kept on ties), every unmarked cell whose end a block holds written 0."""
    out = np.full((len(cols), n2), np.nan, np.float32)
    written = np.zeros(n2, np.int64)
    for b in plan:
        for c, first, stop in b.runs:
            written[c] += 1
            for j, (col, op) in enumerate(zip(cols, ops)):
                acc = np.float32(0.0) if op == "sum" else col[first]
                for v in col[first if op == "sum" else first + 1:stop]:
                    if op == "sum":
                        acc = np.float32(acc + v)
                    elif op == "min":
                        acc = v if v < acc else acc
                    else:
                        acc = v if v > acc else acc
                out[j, c] = acc
        lo, hi = b.cells
        empty = [c for c in range(lo, hi) if c not in _marked(b, cell)]
        out[:, empty] = 0.0
        written[empty] += 1
    np.testing.assert_array_equal(written, np.ones(n2, np.int64))  # exactly once
    return out


@pytest.mark.parametrize("tile", [256, TILE])
@pytest.mark.parametrize("kind", KINDS)
def test_tile_plan_partitions_points_and_cells(kind, tile):
    _check_plan(_cells(kind), N2, tile)


@pytest.mark.parametrize("p", [1, 3, 255, 257, 1021, 1025, 4099])
def test_tile_plan_any_point_count(p):
    """P no multiple of the tile or of 4 (the kernel's 16 B loads)."""
    rng = np.random.default_rng(p)
    cell = np.sort(rng.integers(0, 26, p)).astype(np.int32)
    plan = _check_plan(cell, 25, 256)
    _execute(plan, cell, [np.ones(p, np.float32)], ["sum"], 25)


@pytest.mark.parametrize("kind", KINDS)
def test_tile_plan_executed_is_the_plain_version(kind):
    cell = _cells(kind, seed=1)
    rng = np.random.default_rng(2)
    p = cell.shape[0]
    cols = [rng.standard_normal(p).astype(np.float32) for _ in range(3)]
    cols.append(np.round(rng.standard_normal(p)).astype(np.float32))  # ties for min/max
    ops = ["sum", "sum", "min", "max"]
    assert set(ops) == set(OPS)
    got = _execute(_check_plan(cell, N2, 256), cell, cols, ops, N2)
    want = raster.raster_reduce_plain(torch.from_numpy(cell), [torch.from_numpy(c) for c in cols],
                                      ops, N2)
    for j, w in enumerate(want):
        np.testing.assert_array_equal(got[j], w.numpy(), err_msg=f"column {j} ({ops[j]})")
