"""The port's multi-process fleet layer on ``torch.distributed`` (gloo).

Two spawned processes, joined through a file store, each feed 4 of 8
vehicles: their labels and fleet summary are bitwise those of one process
stepping all 8. The count reductions run over the same two processes. The
fleet is ``tests/test_multihost.py``'s: the small grid, plain kernels,
unsorted scans of one synthetic scene.
"""

import multiprocessing
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from groundgrid_torch.config import GroundGridConfig
from groundgrid_torch.data.synthetic import make_scene, render_scan, vehicle_pose
from groundgrid_torch.parallel.multihost import (
    MultiHostFleet,
    aggregate_host_counts,
    all_hosts_agree,
    init_multihost,
)
from groundgrid_torch.parallel.sharding import stack_fleet_pytree
from groundgrid_torch.pipeline import init_state, pad_scan

torch.set_num_threads(1)

N_VEHICLES = 8
N_RANKS = 2
# tests/conftest.py's small_config, plain kernels
CONFIG = GroundGridConfig(dimension=40.0, resolution=0.5, max_points=16384, ray_steps=40,
                          max_outlier_candidates=1024, use_pallas=False)
SPAWN_TIMEOUT_S = 240


def _fleet_inputs(lo, hi):
    """Stacked states and unsorted scans of vehicles ``[lo, hi)`` (vehicle k
    at scan k of one scene), on the host."""
    scene = make_scene(0, extent=60.0)
    scans, states = [], []
    for k in range(lo, hi):
        T = vehicle_pose(scene, k, step_m=1.0)
        pts, lbl = render_scan(scene, T, n_beams=12, n_azimuth=256, seed=k)
        scans.append(pad_scan(CONFIG, pts, lbl, T, "cpu"))
        states.append(init_state(CONFIG, T.astype(np.float32), "cpu"))
    return stack_fleet_pytree(states), stack_fleet_pytree(scans)


def _fleet_rank(rank, store, out_dir):
    """One rank of the 2-process fleet: 2 CPU devices x 2 vehicles each."""
    torch.set_num_threads(1)
    assert init_multihost(store, N_RANKS, rank, device="cpu")
    try:
        fleet = MultiHostFleet(CONFIG, vehicles_per_device=2, devices=["cpu"] * 2)
        info = fleet.info
        assert (info.global_batch, info.local_batch) == (N_VEHICLES, N_VEHICLES // N_RANKS)
        assert (info.process_index, info.process_count) == (rank, N_RANKS)
        lo = rank * info.local_batch
        states, scans = _fleet_inputs(lo, lo + info.local_batch)
        _, outs, summary = fleet.step(fleet.from_local(states), fleet.from_local(scans))
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), labels=fleet.to_local(outs).labels,
                 summary=np.array([int(v) for v in summary]))
    finally:
        dist.destroy_process_group()


def _counts_rank(rank, store, out_dir, on_card=False):
    """One rank of the count reductions: gloo on the CPU, or NCCL with rank
    r on card r."""
    torch.set_num_threads(1)
    device = torch.device("cuda", rank) if on_card else torch.device("cpu")
    init_multihost(store, N_RANKS, rank, device=device)
    try:
        assert dist.get_backend() == ("nccl" if on_card else "gloo")
        if on_card:
            assert torch.cuda.current_device() == rank
        counts = np.arange(12).reshape(3, 4) * (rank + 1)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), total=aggregate_host_counts(counts),
                 agree=all_hosts_agree(7), differ=all_hosts_agree(rank))
    finally:
        dist.destroy_process_group()


def _spawn(target, tmp_path, *args):
    """Run ``target(rank, store, out_dir, *args)`` in N_RANKS spawned
    processes, each within SPAWN_TIMEOUT_S; returns their saved results by
    rank."""
    ctx = multiprocessing.get_context("spawn")
    store = f"file://{tmp_path / 'store'}"
    procs = [ctx.Process(target=target, args=(rank, store, str(tmp_path), *args))
             for rank in range(N_RANKS)]
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
    assert [p.exitcode for p in procs] == [0] * N_RANKS
    return [np.load(tmp_path / f"rank{rank}.npz") for rank in range(N_RANKS)]


def test_two_ranks_match_one_process(tmp_path):
    """2 gloo ranks x 4 vehicles == 1 process x 8, bitwise; every rank holds
    the fleet-wide summary."""
    fleet = MultiHostFleet(CONFIG, vehicles_per_device=1, devices=["cpu"] * N_VEHICLES)
    states, scans = _fleet_inputs(0, N_VEHICLES)
    _, outs, summary = fleet.step(fleet.from_local(states), fleet.from_local(scans))
    labels = fleet.to_local(outs).labels
    want = np.array([int(v) for v in summary])
    assert want[0] == (labels == 49).sum() > 0 and want[1] == (labels == 99).sum() > 0

    ranks = _spawn(_fleet_rank, tmp_path)
    np.testing.assert_array_equal(np.concatenate([r["labels"] for r in ranks]), labels)
    for r in ranks:
        np.testing.assert_array_equal(r["summary"], want)


def test_host_counts_over_two_ranks(tmp_path):
    ranks = _spawn(_counts_rank, tmp_path)
    for r in ranks:
        np.testing.assert_array_equal(r["total"], np.arange(12).reshape(3, 4) * 3)
        assert r["agree"] and not r["differ"]


@pytest.mark.gpu
def test_host_counts_over_two_nccl_ranks(tmp_path):
    """Two NCCL ranks, each bound to its own card by ``init_multihost``."""
    if torch.cuda.device_count() < N_RANKS:
        pytest.skip(f"needs {N_RANKS} CUDA devices ({torch.cuda.device_count()} present)")
    ranks = _spawn(_counts_rank, tmp_path, True)
    for r in ranks:
        np.testing.assert_array_equal(r["total"], np.arange(12).reshape(3, 4) * 3)
        assert r["agree"] and not r["differ"]


def test_from_local_shape_guard():
    fleet = MultiHostFleet(CONFIG, vehicles_per_device=2, devices=["cpu"] * 2)
    states, _ = _fleet_inputs(0, 1)
    with pytest.raises(ValueError, match="local_batch"):
        fleet.from_local(states)


def test_fleet_shard_info():
    fleet = MultiHostFleet(CONFIG, vehicles_per_device=2, devices=["cpu"] * 4)
    assert fleet.info.global_batch == fleet.info.local_batch == 8
    assert (fleet.info.process_index, fleet.info.process_count) == (0, 1)
    with pytest.raises(TypeError, match="devices"):
        MultiHostFleet(CONFIG)


def test_init_multihost_noop_single_process(monkeypatch):
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    assert init_multihost() is False
    assert not dist.is_initialized()
    with pytest.raises(TypeError, match="device"):
        init_multihost("file:///nonexistent/store", 1, 0)
    assert not dist.is_initialized()


def test_host_count_aggregation_single_process():
    counts = np.arange(12).reshape(3, 4)
    np.testing.assert_array_equal(aggregate_host_counts(counts), counts)
    assert all_hosts_agree(7)
