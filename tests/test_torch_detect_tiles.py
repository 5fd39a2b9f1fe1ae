"""The split of K4's work (``ops/detect.py tile_plan``, the Python twin of the
split in ``csrc/detect.cu``), on the CPU.

Block (bx, by) of the kernel computes the interior cells of ``TILE_W``
columns and a strip of rows, staging the rows and columns their 5x5 windows
reach, and passes through the border cells of its rows and columns, widened
to the grid's edges for the first and last tiles. These tests hold the plan
to that contract for every n from 5 to 420 and for grids around the tile
width and the strip heights up to n = 2,417 (one over the spiral's band
limit): each interior cell is computed by exactly one block, each cell of
the grid written by exactly one, each computed cell's window lies inside
its block's staged rows and columns, which lie on the grid; the use3 words
of each output row stay inside the table for any alignment of its pointer;
the shared memory a block declares stays under the static limit.
"""

import numpy as np
import pytest

from groundgrid_torch.ops import detect
from groundgrid_torch.ops.detect import (SHARED_BYTES, SHARED_LIMIT, STAGED_COLS, TILE_W,
                                         strip_rows, tile_plan)

USE3_WORDS = 32  # detect.cu kUse3Words

LARGE = sorted({TILE_W * k + 4 + d for k in (4, 8, 12, 19) for d in (-1, 0, 1)}
               | {1200, 1201, 2415, 2416, 2417})


def _check_plan(n):
    plan = tile_plan(n)
    gx, gy = plan.grid
    assert len(plan.blocks) == gx * gy
    computed = np.zeros((n, n), np.int32)
    written = np.zeros((n, n), np.int32)
    for b in plan.blocks:
        assert len(b.rows) <= plan.rows and len(b.cols) <= TILE_W
        computed[b.rows.start:b.rows.stop, b.cols.start:b.cols.stop] += 1
        written[b.owned_rows.start:b.owned_rows.stop, b.owned_cols.start:b.owned_cols.stop] += 1
        # the owned ranges hold the computed cells
        assert b.owned_rows.start <= b.rows.start and b.rows.stop <= b.owned_rows.stop
        assert b.owned_cols.start <= b.cols.start and b.cols.stop <= b.owned_cols.stop
        # every computed cell's 5x5 window inside the staged rows and columns,
        # which lie on the grid and fit the block's threads
        if len(b.rows) and len(b.cols):
            assert b.staged_rows.start <= b.rows.start - 2 and b.rows.stop + 1 < b.staged_rows.stop
            assert b.staged_cols.start <= b.cols.start - 2 and b.cols.stop + 1 < b.staged_cols.stop
        assert 0 <= b.staged_rows.start and b.staged_rows.stop <= n
        assert 0 <= b.staged_cols.start and b.staged_cols.stop <= n
        assert len(b.staged_cols) <= STAGED_COLS
        # use3 of each output row as aligned 4-byte words, for a table
        # pointer at any offset mod 4: at most USE3_WORDS, all in the table
        for r in (b.rows.start, b.rows.stop - 1):
            for ptr in range(4):
                first = ptr + r * n + b.cols.start
                o = first % 4
                words = (o + len(b.cols) + 3) // 4
                assert words <= USE3_WORDS
                assert first - o >= ptr and first - o + 4 * words <= ptr + n * n
    interior = np.zeros((n, n), bool)
    interior[2:n - 2, 2:n - 2] = True
    np.testing.assert_array_equal(computed, interior.astype(np.int32))
    np.testing.assert_array_equal(written, np.ones((n, n), np.int32))
    return plan


@pytest.mark.parametrize("lo", range(5, 421, 52))
def test_plan_partitions_small_grids(lo):
    for n in range(lo, min(lo + 52, 421)):
        _check_plan(n)


@pytest.mark.parametrize("n", LARGE)
def test_plan_partitions_large_grids(n):
    _check_plan(n)


def test_shared_memory_under_static_limit():
    assert SHARED_BYTES == 26_240  # ptxas: 26240 bytes smem
    assert SHARED_BYTES <= SHARED_LIMIT


def test_strip_heights_by_grid():
    """Strips of 2 rows up to n = 599 (364^2: 540 blocks), n // 200 rows
    above (1200^2: 6 rows, 2,000 blocks), never more than 8; every block
    but the last strip's has its full height."""
    assert [strip_rows(n) for n in (5, 364, 599, 600, 1200, 1799, 2416, 20000)] == [
        2, 2, 2, 3, 6, 8, 8, 8]
    small, big = tile_plan(364), tile_plan(1200)
    assert (small.rows, small.grid) == (2, (3, 180))
    assert (big.rows, big.grid) == (6, (10, 200))
    for plan, inner in ((small, 360), (big, 1196)):
        heights = [len(b.rows) for b in plan.blocks]
        assert heights[:-plan.grid[0]] == [plan.rows] * (len(heights) - plan.grid[0])
        assert sum(heights) == inner * plan.grid[0]


def test_plan_refuses_tiny_grids():
    with pytest.raises(ValueError):
        detect.tile_plan(4)
