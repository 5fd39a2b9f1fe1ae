"""A capture of the step is valid for every scan, and the captured step's
static-buffer protocol keeps every result bitwise.

``make_step`` captures the step's body as one CUDA graph on its second scan
and replays it from then on (``pipeline.CapturedStep``). A replay repeats
the captured ops with their captured arguments, so the capture is valid for
every scan only if the body runs the same ops, on the same shapes and with
the same non-tensor arguments, whatever the scan: every per-scan value must
come from a tensor (the scan scalars). A ``TorchDispatchMode`` records the
body's op sequence for scans with different poses, a still pose, a move and
a teleport; the sequences must be identical and hold no host read
(``aten::_local_scalar_dense``, or a read ``host_reads`` sees). K1's plain
version loops once per point of the longest run (a data-dependent count
that its one kernel launch on the card does not have), and K3's walks its
rings in thousands of small ops, so these runs take stand-ins for both,
with fixed op sequences over the same inputs (K3's seeds the center from
``base_z``, the value its kernel reads from device memory).

On the CPU ``CapturedStep`` runs the same static-buffer protocol, the eager
body where the card replays: layers copied in, outputs cloned out. That
protocol is held here to the lock-step run: ``pipeline_depth=2``, a
restore, a reconfigure, a checkpoint resume, and a fleet of four vehicles
against four streaming drivers, all bitwise.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from groundgrid_torch import FleetDriver, GroundGridConfig, StreamingDriver
from groundgrid_torch import pipeline as tpipe
from groundgrid_torch.runtime.checkpoint import load_state, save_state

from test_torch_step_inputs import SMALL, moving_scans, records
from test_torch_step_reads import host_reads

torch.set_num_threads(1)


class OpRecorder(TorchDispatchMode):
    """Every aten op: its name, its tensors' shapes and dtypes, and every
    other argument as it is."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.ops.append((str(func), describe(args), describe(kwargs)))
        return func(*args, **kwargs)


def describe(a):
    """A tensor as (shape, dtype, device); containers item by item."""
    if isinstance(a, torch.Tensor):
        return ("tensor", tuple(a.shape), a.dtype, a.device.type)
    if isinstance(a, (list, tuple)):
        return type(a)(describe(v) for v in a)
    if isinstance(a, dict):
        return {k: describe(v) for k, v in a.items()}
    return a


def scatter_reduce(cell, cols, ops, n2):
    """A stand-in for K1 with a fixed op sequence: one scatter per column
    (not K1's summation order; these runs compare op sequences)."""
    idx = cell.to(torch.int64)
    reduce = {"sum": "sum", "min": "amin", "max": "amax"}
    return tuple(torch.zeros(n2 + 1).scatter_reduce(0, idx, c, reduce[o], include_self=False)[:n2]
                 for c, o in zip(cols, ops))


def seed_center(config, ground, groundpatch, base_z):
    """A stand-in for K3: seeds the center as the kernel does, walks nothing."""
    c = config.center_cell
    ground[c, c] = base_z
    groundpatch[c, c] = 1.0
    return ground, groundpatch


MODES = {
    "sorted": dict(sorted_scans=True),
    "unsorted": dict(sorted_scans=False),
    "wire-fused": dict(sorted_scans=True, wire_format=True, fused_detect=True),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_body_ops_are_the_same_for_every_scan(mode):
    """Scans 2-6 of the moving sequence (a move, a still pose, a step back,
    a teleport): the same op sequence, no host read."""
    config = GroundGridConfig(**SMALL, **MODES[mode])
    driver = StreamingDriver(config, "cpu", with_aux=True)
    step = tpipe.make_step_fn(config, with_aux=True)
    step._reduce, step._spiral = scatter_reduce, seed_center
    driver.step = step
    body, sequences, reads = step.body, [], []

    def recorded_body(*args):
        with host_reads() as seen, OpRecorder() as recorder:
            out = body(*args)
        sequences.append(recorder.ops)
        reads.append(list(seen))
        return out

    step.body = recorded_body
    for rec in records(moving_scans()):
        driver.process(rec)
    # the first body does the lazy set-up (the detect tables, the fallback
    # counter); the capture is taken on the second
    first, *rest = sequences
    assert len(rest) == 5 and len(rest[0]) > 1000
    for k, ops in enumerate(rest[1:], 2):
        assert ops == rest[0], f"scan {k}: the body's ops differ from scan 1's"
    assert not any("_local_scalar_dense" in op[0] for op in first + rest[0])
    assert not any(reads), reads


def _run(driver, recs, depth=0):
    return [(r.labels, r.outlier, r.aux) for r in driver.run(recs, pipeline_depth=depth)]


def _same(a, b):
    for (la, oa, xa), (lb, ob, xb) in zip(a, b, strict=True):
        np.testing.assert_array_equal(la, lb)
        np.testing.assert_array_equal(oa, ob)
        if xa is not None:
            for name in xa:
                np.testing.assert_array_equal(xa[name], xb[name], err_msg=name)


@pytest.fixture(scope="module")
def stream():
    config = GroundGridConfig(**SMALL, sorted_scans=True)
    recs = records(moving_scans())
    lock_step = _run(StreamingDriver(config, "cpu", with_aux=True), recs)
    return config, recs, lock_step


def test_pipeline_depth_two_is_lock_step(stream):
    """Two scans in flight: the clones of the static outputs survive the
    next two calls."""
    config, recs, lock_step = stream
    driver = StreamingDriver(config, "cpu", with_aux=True)
    assert isinstance(driver.step, tpipe.CapturedStep)
    _same(_run(driver, recs, depth=2), lock_step)


def test_restore_reconfigure_and_resume(stream, tmp_path):
    """A state installed by ``restore`` (copied into the static layers), a
    ``reconfigure`` that keeps the state (a new captured step, the state
    copied into its buffers) and a checkpoint resumed in a new driver: each
    continues the stream bitwise."""
    config, recs, lock_step = stream
    half = 3
    driver = StreamingDriver(config, "cpu", with_aux=True)
    first = _run(driver, recs[:half])
    path = str(tmp_path / "state.npz")
    save_state(path, driver.state, half, config, center64=driver.center64)
    state, nxt, extra = load_state(path, config, "cpu")
    # run ahead, then restore the checkpoint into the same driver
    _run(driver, recs[half:])
    driver.restore(state, extra["center64"])
    assert driver.state.ground is driver.step.install(driver.state).ground
    _same(first + _run(driver, recs[nxt:]), lock_step)

    driver = StreamingDriver(config, "cpu", with_aux=True)
    first = _run(driver, recs[:half])
    old_step = driver.step
    driver.reconfigure(dataclasses.replace(config, outlier_tolerance=config.outlier_tolerance))
    assert driver.step is not old_step and driver.state.ground is driver.step._layers[0]
    _same(first + _run(driver, recs[half:]), lock_step)

    resumed = StreamingDriver(config, "cpu", with_aux=True)
    resumed.restore(state, extra["center64"])
    _same(_run(resumed, recs[nxt:]), lock_step[nxt:])


def test_fleet_of_four_is_four_streaming_drivers():
    """Four vehicles, two per device of a 2-entry CPU mesh, each a captured
    step's static buffers per device: bitwise four streaming drivers."""
    config = GroundGridConfig(**SMALL, sorted_scans=True)
    scans = moving_scans()
    streams = [records(scans[v:] + scans[:v])[:3] for v in range(4)]
    fleet = FleetDriver(config, batch=4, mesh=["cpu"] * 2)
    assert all(isinstance(s, tpipe.CapturedStep) for s in fleet.step.steps)
    ticks = list(fleet.run(streams))
    assert len(ticks) == 3
    for v, stream in enumerate(streams):
        driver = StreamingDriver(config, "cpu")
        for tick, rec in zip(ticks, stream):
            res = driver.process(rec)
            n = res.n_points
            np.testing.assert_array_equal(tick.labels[v][:n], res.labels)
            np.testing.assert_array_equal(tick.outlier[v][:n] > 0, res.outlier)


def test_captured_step_takes_scans_with_their_center():
    """A center-less scan raises on the captured step (its host recurrence
    belongs to the eager step); ``use_pallas=False`` gives the eager step."""
    config = GroundGridConfig(**SMALL)
    pts, lbl, T = moving_scans()[0]
    scan = tpipe.pad_scan(config, pts, lbl, T, "cpu")
    state = tpipe.init_state(config, T, "cpu")
    with pytest.raises(ValueError, match="center"):
        tpipe.make_step(config)(state, scan)
    assert isinstance(tpipe.make_step(dataclasses.replace(config, use_pallas=False)),
                      tpipe.Step)
    assert isinstance(tpipe.make_step(config), tpipe.CapturedStep)
    assert not isinstance(tpipe.make_step_fn(config), tpipe.CapturedStep)


def test_outputs_are_clones_of_the_static_buffers():
    """The tensors one call returns are not written by the next: outputs,
    aux layers and coordinates are clones."""
    config = GroundGridConfig(**SMALL, sorted_scans=True)
    step = tpipe.make_step(config, with_aux=True)
    driver = StreamingDriver(config, "cpu", with_aux=True)
    driver.step = step
    recs = records(moving_scans())
    driver.process(recs[0])
    scan, _ = driver.make_scan(recs[1])
    state, out, aux = step(driver.state, scan)
    kept = [t.clone() for t in (*out, *aux)]
    for rec in recs[2:4]:
        driver.process(rec)
    for a, b in zip((*out, *aux), kept, strict=True):
        assert torch.equal(a, b)
    assert state.ground is step._layers[0]
    assert not any(t.data_ptr() == s.data_ptr() for t in out for s in step._points)
