"""The spatial step with one shard per ``torch.distributed`` rank (gloo).

2 and 4 spawned processes, joined through a file store, each run one shard
of the port's spatial step (``parallel.spatial.GroupMesh``) over 2 scans in
both spiral modes: every rank's row blocks, labels and outliers are bitwise
those of the in-process mesh ``["cpu"] * S`` with the same S. The grid is
``tests/conftest.py``'s small_config (80^2), unsorted scans with the center
on the device. On a machine with several cards (marker ``gpu``; this file
imports no JAX, so ``--noconftest`` runs it there): the in-process mesh
across cards, and two NCCL ranks, bitwise the same shards on card 0.
"""

import multiprocessing
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from groundgrid_torch.config import GroundGridConfig
from groundgrid_torch.data.synthetic import synthetic_sequence
from groundgrid_torch.parallel import spatial
from groundgrid_torch.parallel.multihost import init_multihost
from groundgrid_torch.pipeline import init_state, pad_scan

torch.set_num_threads(1)

CONFIG = GroundGridConfig(dimension=40.0, resolution=0.5, max_points=16384, ray_steps=40,
                          max_outlier_candidates=1024)
MODES = ("replicated", "banded")
SPAWN_TIMEOUT_S = 240


def _run(mesh, device="cpu"):
    """Each spiral mode's outputs over 2 scans on ``mesh``, this process's
    shards only (scans and state made on ``device``): a dict of NumPy
    arrays."""
    scans = [(pad_scan(CONFIG, p, l, T, device), T)
             for p, l, T in synthetic_sequence(2, seed=5, n_beams=16, n_azimuth=500)]
    st = init_state(CONFIG, np.asarray(scans[0][1], np.float32), device)
    out = {}
    for mode in MODES:
        step = spatial.make_spatial_step(CONFIG, mesh, spiral_mode=mode)
        g = spatial.split_rows(st.ground, mesh)
        c = spatial.split_rows(st.groundpatch, mesh)
        center = (st.center, st.center_lo)
        for k, (scan, _) in enumerate(scans):
            g, c, center, labels, outlier = step(g, c, center, spatial.shard_scan(scan, mesh))
            for name, blocks in (("ground", g), ("groundpatch", c), ("labels", labels),
                                 ("outlier", outlier)):
                out[f"{mode}_{k}_{name}"] = torch.cat([b.cpu() for b in blocks]).numpy()
        out[f"{mode}_center"] = np.concatenate([t.numpy() for t in center])
    return out


def _rank(rank, world, store, out_dir, on_card=False):
    """One shard per rank: gloo on the CPU, or NCCL with rank r on card r."""
    torch.set_num_threads(1)
    device = torch.device("cuda", rank) if on_card else torch.device("cpu")
    assert init_multihost(store, world, rank, device=device)
    try:
        assert dist.get_backend() == ("nccl" if on_card else "gloo")
        mesh = spatial.GroupMesh(device)
        assert (mesh.size, mesh.shards) == (world, [rank])
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **_run(mesh, device))
    finally:
        dist.destroy_process_group()


def _spawn(world, tmp_path, on_card=False):
    ctx = multiprocessing.get_context("spawn")
    store = f"file://{tmp_path / 'store'}"
    procs = [ctx.Process(target=_rank, args=(rank, world, store, str(tmp_path), on_card))
             for rank in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(SPAWN_TIMEOUT_S)
        assert not any(p.is_alive() for p in procs), f"a rank ran over {SPAWN_TIMEOUT_S} s"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    assert [p.exitcode for p in procs] == [0] * world
    return [np.load(tmp_path / f"rank{rank}.npz") for rank in range(world)]


def _bits(a):
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(got, want, name):
    """``got`` bitwise ``want`` on every output (float32 compared as bits)."""
    assert sorted(got) == sorted(want)
    for key, a in want.items():
        np.testing.assert_array_equal(_bits(got[key]), _bits(a), err_msg=f"{name} {key}")


def _check_ranks(ranks, want, world):
    rows, points = CONFIG.cell_count // world, CONFIG.max_points // world
    for r, got in enumerate(ranks):
        for key, a in want.items():
            if key.endswith("center"):
                part = a
            elif key.endswith(("ground", "groundpatch")):
                part = a[r * rows:(r + 1) * rows]
            else:
                part = a[r * points:(r + 1) * points]
            assert got[key].dtype == part.dtype
            np.testing.assert_array_equal(_bits(got[key]), _bits(part), err_msg=f"rank {r} {key}")


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_match_in_process_mesh(world, tmp_path):
    want = _run(spatial.LocalMesh(["cpu"] * world))
    assert (want["replicated_1_labels"] == 99).sum() > 0
    _check_ranks(_spawn(world, tmp_path), want, world)


@pytest.fixture
def cards():
    if torch.cuda.device_count() < 2:
        pytest.skip(f"needs 2 CUDA devices ({torch.cuda.device_count()} present)")
    return torch.cuda.device_count()


@pytest.mark.gpu
def test_mesh_across_cards(cards):
    """The in-process mesh over one shard per card is bitwise the same
    shards on card 0."""
    shards = min(cards, 4)
    want = _run(spatial.LocalMesh(["cuda:0"] * shards), "cuda:0")
    _same(_run(spatial.LocalMesh([f"cuda:{k}" for k in range(shards)]), "cuda:0"), want,
          f"{shards} cards")


@pytest.mark.gpu
def test_nccl_ranks_match_in_process_mesh(cards, tmp_path):
    """Two NCCL ranks, rank r on card r, bitwise ``["cuda:0"] * 2``."""
    want = _run(spatial.LocalMesh(["cuda:0"] * 2), "cuda:0")
    _check_ranks(_spawn(2, tmp_path, on_card=True), want, 2)


def test_group_mesh_needs_a_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="torch.distributed"):
        spatial.GroupMesh("cpu")
