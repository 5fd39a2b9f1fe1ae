"""The slot map of K3's ring band (``ops/spiral.py``, the Python twin of the
slot arithmetic in ``csrc/spiral.cu``), on the CPU.

The kernel keeps the rings a 3x3 stencil of the walk reads in shared memory,
each ring stored in the order of ``ring_slot``, and addresses a stencil by
runs of slots plus six planned corner cases per segment (``stencil_slots``).
These tests hold the map to the walk of the plain version: every ring's
slots are a bijection onto its cells, the walk visits them in order with its
two double visits, every stencil address the kernel computes is the cell the
walk reads and lies in the band, the junction cache holds every ring D-1
cell that the redone junction visits read, and the band's bytes are what
the wrapper asks the launch for. Above the band's limit the wrapper picks
the global-band variant, whose launch fits a block for any n.
"""

from collections import Counter

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from groundgrid_torch.config import GroundGridConfig
from groundgrid_torch.ops import spiral
from groundgrid_torch.ops.spiral import (BAND_EXTRA, JUNCTION_KIND, MAX_PER_THREAD, MEM_THREADS,
                                         SCRATCH_FLOATS, SMEM_LIMIT, band_layout, global_layout,
                                         junction_cells, junction_visits, ring_slot, ring_walk,
                                         slot_cell, spiral_variant, stencil_slots)

SIZES = [12, 24, 45, 80, 140, 364, 1212]


def _ring(m, r, c):
    return max(abs(r - m), abs(c - m))


def _slot(m, r, c):
    return ring_slot(r - m, c - m, _ring(m, r, c))


@pytest.mark.parametrize("n", SIZES)
def test_ring_slots_biject_in_walk_order(n):
    m = n // 2 - 1
    assert [slot_cell(0, 0, m)] == [(m, m)] and _slot(m, m, m) == 0
    for d in range(1, m + 1):
        i, outer = m - d, m + d
        cells = [slot_cell(s, d, m) for s in range(8 * d)]
        assert len(set(cells)) == 8 * d
        assert all(_ring(m, r, c) == d for r, c in cells)
        assert [_slot(m, r, c) for r, c in cells] == list(range(8 * d))
        if d == m:
            continue  # ring m is read by the walk, never walked
        walk = ring_walk(m, d)
        slots = [_slot(m, r, c) for r, c in walk]
        assert len(walk) == 8 * d + 2 and sorted(set(slots)) == list(range(8 * d))
        counts = Counter(slots)
        assert sorted(s for s, k in counts.items() if k > 1) == sorted(
            [_slot(m, i, i), _slot(m, outer, outer)])
        assert max(counts.values()) == 2


def test_ring_walk_is_the_plain_versions_walk(monkeypatch):
    """``ring_walk`` visits the cells of ``spiral_interpolation_plain``'s
    segments, in its order."""
    cfg = GroundGridConfig(dimension=12.5, resolution=0.5)  # n = 25
    n, m = cfg.cell_count, cfg.center_cell
    visits = []

    def record(config, h, c, fixed, lo, hi, transposed, descending):
        ys = range(hi - 1, lo - 1, -1) if descending else range(lo, hi)
        visits.extend((y, fixed) if transposed else (fixed, y) for y in ys)

    monkeypatch.setattr(spiral, "_segment_update", record)
    spiral.spiral_interpolation_plain(cfg, torch.zeros(n, n), torch.zeros(n, n), 0.0)
    assert visits == [cell for d in range(1, m) for cell in ring_walk(m, d)]


@pytest.mark.parametrize("n", SIZES)
def test_every_stencil_lands_in_the_band(n):
    """The kernel's address of each of the nine cells every visit reads is
    the cell's (ring, slot), on rings d-1 .. d+1, inside a band buffer."""
    m = n // 2 - 1
    stride = band_layout(n).stride
    for d in range(1, m):
        walk = ring_walk(m, d)
        starts = [0, 2 * d, 4 * d, 6 * d + 1, 8 * d + 2]
        for kind in range(4):
            for k, (r, c) in enumerate(walk[starts[kind]:starts[kind + 1]]):
                transposed = kind & 1
                step = -1 if kind >= 2 else 1  # along the line, in walk order
                cells = [(r + df, c + dy * step) if not transposed else (r + dy * step, c + df)
                         for df in (-1, 0, 1) for dy in (-1, 0, 1)]
                for (ring, slot), (rr, cc) in zip(stencil_slots(d, kind, k), cells):
                    assert 0 <= rr < n and 0 <= cc < n
                    assert ring == _ring(m, rr, cc) and d - 1 <= ring <= d + 1
                    assert slot % max(8 * ring, 1) == ring_slot(rr - m, cc - m, ring)
                    assert 0 <= slot <= 8 * ring < stride


@pytest.mark.parametrize("n", SIZES + [2415])
def test_junction_cache_holds_what_the_redone_visits_read(n):
    """Ring d+2 overwrites ring d-1's buffer once the ring's coefficients
    are in: the visits warp 0 redoes after that read ring d-1 only at the
    cached cells."""
    m = n // 2 - 1
    for d in range(2, m):
        for p, kind in enumerate(JUNCTION_KIND):
            cached = junction_cells(d, p)
            assert all(0 < slot <= 8 * (d - 1) for _, slot in cached)  # 8(d-1): the corner copy
            read = {(ring, slot) for k in junction_visits(d, p)
                    for ring, slot in stencil_slots(d, kind, k) if ring == d - 1}
            assert read == set(cached)


@pytest.mark.parametrize("n", SIZES + [2415])
def test_band_bytes_are_what_the_launch_requests(n):
    m = n // 2 - 1
    layout = band_layout(n)
    largest = max(_slot(m, r, c) for r, c in (slot_cell(s, m, m) for s in range(8 * m))) + 1
    assert layout.stride == largest + 1 == 8 * m + 1  # the outer ring and its corner copy
    # 3 buffers of (height, confidence), the center and the junction cache
    # (8 pairs), then the scratch floats
    assert BAND_EXTRA == 1 + 8
    assert layout.smem_bytes == 8 * (3 * layout.stride + 9) + 4 * SCRATCH_FLOATS <= SMEM_LIMIT
    visits = 8 * (m - 1) + 2  # ring m-1, the largest walked
    walkers = layout.threads - MEM_THREADS
    assert walkers == min(1024 - MEM_THREADS, -(-visits // 32) * 32)
    assert layout.per_thread == -(-visits // walkers) <= MAX_PER_THREAD


def test_band_limit():
    assert band_layout(2415).smem_bytes <= SMEM_LIMIT
    with pytest.raises(ValueError, match="232448"):
        band_layout(2416)


@settings(max_examples=60, deadline=None)
@given(st.integers(min_value=8, max_value=2415))
def test_band_layout_fits_the_kernel(n):
    layout = band_layout(n)
    m = n // 2 - 1
    assert layout.smem_bytes == 4 * (48 * m + 6 + 18 + SCRATCH_FLOATS) <= SMEM_LIMIT
    assert layout.threads % 32 == 0 and 32 + MEM_THREADS <= layout.threads <= 1024
    assert layout.per_thread <= MAX_PER_THREAD


@pytest.mark.parametrize("n,variant", [
    (364, "band"), (2414, "band"), (2415, "band"), (2416, "global"), (20000, "global"),
])
def test_spiral_variant_by_grid_size(n, variant):
    """The band kernel up to 2415 cells a side (the 364^2 main path among
    them), the global-band kernel above, where the band does not fit."""
    assert spiral_variant(n) == variant
    if variant == "band":
        assert band_layout(n).smem_bytes <= SMEM_LIMIT
    else:
        with pytest.raises(ValueError, match="ring band"):
            band_layout(n)


@pytest.mark.parametrize("n", [2416, 2800, 18688, 18689, 20000, 60000])
def test_global_layout_fits_a_block(n):
    """3 n + 2 T floats in shared memory where they fit; beyond, the 3 n
    per-segment floats move to a global scratch buffer."""
    layout = global_layout(n)
    assert layout.threads == 1024 and layout.smem_bytes <= SMEM_LIMIT
    scan = 4 * 2 * layout.threads
    if layout.scratch_floats:
        assert n > 18688 and layout.scratch_floats == 3 * n and layout.smem_bytes == scan
    else:
        assert n <= 18688 and layout.smem_bytes == scan + 4 * 3 * n
