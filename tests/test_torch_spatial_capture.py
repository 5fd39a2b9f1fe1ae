"""The captured spatial step (``parallel/spatial.py CapturedSpatialStep``) on
the CPU: a capture is valid for every scan, and its static-buffer protocol
keeps every result bitwise.

A replay repeats the captured ops with their captured arguments, so the
spatial body must run the same ops, on the same shapes and with the same
non-tensor arguments, whatever the scan, and read nothing back to the host.
A ``TorchDispatchMode`` records the body's ops (every shard's, and the
collectives between them) for scans 2-6 of the moving sequence (a move, a
still pose, a step back, a teleport) on ``["cpu"] * 4``, in both spiral
modes; the sequences must be identical and hold no host read. K1's plain
version loops once per point of the longest run and K3's walks thousands
of small ops, so these runs take ``test_torch_capture``'s stand-ins (and,
for the band relay, a ring-range stand-in that reads ``base_z`` from the
tensor as the kernel does).

On the CPU the captured step runs the bodies where the card replays, their
outputs copied into the static tensors, with the collectives inside the
one graph or (set directly, as a mesh across devices or ranks places
them) between per-device segments: both are held bitwise to the
eager ``SpatialStep`` over the sequence (labels, outliers, layers and the
center pair), kept results are not overwritten, the captured sharded
detect is bitwise the eager one, and the captured step stays within the
bounds of ``test_torch_spatial.py``'s test against the JAX spatial step.
"""

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from groundgrid_tpu.config import GroundGridConfig as JConfig
from groundgrid_tpu.parallel.spatial import make_spatial_step as j_spatial_step
from groundgrid_tpu.parallel.spatial import spatial_sharding as j_spatial_sharding
from groundgrid_tpu.pipeline import CenterTracker as JTracker
from groundgrid_tpu.pipeline import init_state as j_init_state
from groundgrid_tpu.pipeline import prepare_scan as j_prepare_scan

from groundgrid_torch.config import GroundGridConfig
from groundgrid_torch.data.synthetic import synthetic_sequence
from groundgrid_torch.parallel import collectives, spatial
from groundgrid_torch.pipeline import CenterTracker, init_state, pad_scan, prepare_scan

from test_torch_capture import OpRecorder, scatter_reduce, seed_center
from test_torch_spatial import LABELS_MIN, MESH, SMALL_KW, _detect_inputs
from test_torch_step_inputs import moving_scans
from test_torch_step_reads import host_reads

torch.set_num_threads(1)

CONFIG = GroundGridConfig(**SMALL_KW, sorted_scans=True)
MESH4 = ["cpu"] * 4
MODES = ("replicated", "banded")
POINT_FIELDS = ("px", "py", "pz", "rings", "valid")


def _scans(config, scans, mesh):
    """The sequence prepared against the host-tracked centers, as chunks on
    ``mesh``, with the first state's row blocks and center pair."""
    T0 = np.asarray(scans[0][2], np.float64)
    tracker = CenterTracker(config, T0[:2, 3])
    chunks = []
    for p, l, T in scans:
        T = np.asarray(T, np.float64)
        scan, _ = prepare_scan(config, p, l, T, tracker.update(T[:2, 3]), "cpu")
        chunks.append(spatial.shard_scan(scan, mesh))
    st = init_state(config, T0.astype(np.float32), "cpu")
    return chunks, (spatial.split_rows(st.ground, mesh), spatial.split_rows(st.groundpatch, mesh),
                    (st.center, st.center_lo))


def _run(step, chunks, start):
    """Per scan: copies of the gathered ground, groundpatch, labels and
    outliers, and the center pair."""
    g, c, center = start
    out = []
    for chunk in chunks:
        g, c, center, labels, outlier = step(g, c, center, chunk)
        out.append([torch.cat(x).clone() for x in (g, c, labels, outlier)] + list(center))
    return out


def _same(got, want):
    assert len(got) == len(want)
    for k, (a, b) in enumerate(zip(got, want)):
        for x, y in zip(a, b, strict=True):
            if x.dtype.is_floating_point:
                x, y = x.view(torch.int32), y.view(torch.int32)
            assert torch.equal(x, y), f"scan {k + 1}"


def ring_stand_in(config, ground, groundpatch, base_z, d_first, d_last):
    """A stand-in for K3's ring range: reads ``base_z`` from the tensor into
    the band's outermost ring, walks nothing."""
    i = config.center_cell - d_last
    ground[i, i].copy_(base_z)
    return ground, groundpatch


@pytest.mark.parametrize("mode", MODES)
def test_spatial_body_ops_are_the_same_for_every_scan(mode, monkeypatch):
    """Scans 2-6 of the moving sequence: the same ops, no host read."""
    step = spatial.SpatialStep(CONFIG, MESH4, mode, with_scan_center=True)
    step._reduce, step._spiral = scatter_reduce, seed_center
    if step._band is not None:
        step._band.rings_fn = ring_stand_in
    sequences, reads = [], []
    drive = collectives.drive

    def recorded(mesh, bodies):
        with host_reads() as seen, OpRecorder() as recorder:
            out = drive(mesh, bodies)
        sequences.append(recorder.ops)
        reads.append(list(seen))
        return out

    monkeypatch.setattr(spatial, "drive", recorded)
    chunks, start = _scans(CONFIG, moving_scans(), MESH4)
    _run(step, chunks, start)
    # the first run does the lazy set-up (the detect tables, the band masks,
    # the fallback counter); the capture follows it
    first, *rest = sequences
    assert len(rest) == 5 and len(rest[0]) > 1000
    for k, ops in enumerate(rest[1:], 2):
        assert ops == rest[0], f"scan {k}: the body's ops differ from scan 1's"
    assert not any("_local_scalar_dense" in op[0] for op in first + rest[0])
    assert not any(reads), reads


@pytest.fixture(scope="module")
def moving():
    chunks, start = _scans(CONFIG, moving_scans(), MESH4)
    eager = {mode: _run(spatial.SpatialStep(CONFIG, MESH4, mode, with_scan_center=True),
                        chunks, start) for mode in MODES}
    return chunks, start, eager


def _placed(captured, collectives_at):
    """``captured`` (a step or detect on a one-device mesh, collectives
    inside) with its collectives at ``collectives_at``: ``"between"``
    segments it as a mesh across devices or ranks is."""
    if collectives_at == "between":
        captured._shards = collectives.CapturedShards(captured.mesh, "between")
    return captured


@pytest.mark.parametrize("collectives_at", ["inside", "between"])
@pytest.mark.parametrize("mode", MODES)
def test_captured_protocol_is_eager(moving, mode, collectives_at):
    """The captured step over the moving sequence, its collectives in the
    graph or between per-device segments: bitwise the eager step."""
    chunks, start, eager = moving
    step = _placed(spatial.make_spatial_step(CONFIG, MESH4, mode, with_scan_center=True),
                   collectives_at)
    assert isinstance(step, spatial.CapturedSpatialStep)
    assert step.collectives == collectives_at and not step.captured  # no graph on the CPU
    _same(_run(step, chunks, start), eager[mode])
    assert step.fallbacks == 0


def test_default_collectives():
    """Inside the graph on a one-device mesh, between the graphs across
    devices; inside refused across devices; no other placement."""
    assert spatial.make_spatial_step(CONFIG, MESH4, with_scan_center=True).collectives == "inside"
    assert spatial.default_collectives(["cpu", "cpu"]) == "inside"
    assert spatial.default_collectives(["cpu", "meta"]) == "between"
    with pytest.raises(ValueError, match="one device"):
        collectives.CapturedShards(spatial.LocalMesh(["cpu", "meta"]), "inside")
    with pytest.raises(ValueError, match="'inside' or 'between'"):
        collectives.CapturedShards(spatial.LocalMesh(MESH4), "eager")


def test_inside_refused_beyond_this_process():
    """A mesh with shards in other processes (a ``GroupMesh`` rank's view:
    one local shard of two) keeps its collectives (NCCL or gloo calls) out
    of the graphs."""
    rank = types.SimpleNamespace(devices=[torch.device("cpu")], size=2, shards=[1])
    with pytest.raises(ValueError, match="1 of 2 shards"):
        collectives.CapturedShards(rank, "inside")
    assert collectives.CapturedShards(rank, "between").collectives == "between"


def test_outputs_are_clones_and_state_is_static(moving):
    """A result kept across the next calls is unchanged; the state returned
    holds the static blocks, and a state from outside is copied in."""
    chunks, start, eager = moving
    step = spatial.make_spatial_step(CONFIG, MESH4, "banded", with_scan_center=True)
    g, c, center = start
    g, c, center, labels, outlier = step(g, c, center, chunks[0])
    out = step(g, c, center, chunks[1])
    kept = [t.clone() for t in (*out.labels, *out.outlier)]
    assert all(a is b for a, b in zip(out.ground, g))
    g2, c2, center2, _, _ = step(out.ground, out.groundpatch, out.center, chunks[2])
    step(g2, c2, center2, chunks[3])
    assert all(torch.equal(a, b) for a, b in zip((*out.labels, *out.outlier), kept))
    # a fresh start copied into the static blocks steps as the eager run did
    g0, c0 = [b.clone() for b in start[0]], [b.clone() for b in start[1]]
    rerun = _run(step, chunks[:2], (g0, c0, start[2]))
    _same(rerun, eager["banded"][:2])
    assert all(torch.equal(a, b) for a, b in zip(g0, start[0]))  # the caller's blocks: read only


def test_refusals():
    """A center-less scan raises in the captured step; without scan centers,
    with the plain kernels or uncaptured, ``make_spatial_step`` gives the
    eager step."""
    config = GroundGridConfig(**SMALL_KW)
    pts, lbl, T = moving_scans()[0]
    st = init_state(config, np.asarray(T, np.float32), "cpu")
    chunks = spatial.shard_scan(pad_scan(config, pts, lbl, T, "cpu"), MESH4)
    step = spatial.CapturedSpatialStep(config, MESH4)
    with pytest.raises(ValueError, match="center"):
        step(spatial.split_rows(st.ground, MESH4), spatial.split_rows(st.groundpatch, MESH4),
             (st.center, st.center_lo), chunks)
    assert type(spatial.make_spatial_step(config, MESH4)) is spatial.SpatialStep
    plain = dataclasses.replace(CONFIG, use_pallas=False)
    assert type(spatial.make_spatial_step(plain, MESH4, with_scan_center=True)) is \
        spatial.SpatialStep
    with pytest.raises(ValueError, match="one kind of device"):
        spatial.CapturedSpatialStep(CONFIG, spatial.LocalMesh(["cpu", "meta"]))


@pytest.mark.parametrize("collectives_at", ["inside", "between"])
def test_captured_sharded_detect_is_eager(collectives_at):
    """The captured sharded detect over three calls (new inputs each time)
    bitwise the eager one; outputs are clones."""
    cfg = GroundGridConfig(dimension=24.0, resolution=0.5, max_points=4096, ray_steps=28,
                           max_outlier_candidates=256)
    eager = spatial.ShardedDetect(cfg, MESH)
    captured = _placed(spatial.make_sharded_detect(cfg, MESH), collectives_at)
    assert isinstance(captured, spatial.CapturedDetect) and not captured.captured
    kept = None
    for seed in range(3):
        blocks = [spatial.split_rows(torch.from_numpy(a), MESH)
                  for a in _detect_inputs(cfg.cell_count, seed)]
        want = eager(*blocks)
        got = captured(*blocks)
        for a, b in zip(got, want):
            assert all(torch.equal(x, y) for x, y in zip(a, b))
        if kept is None:
            kept, first = [t.clone() for t in got[0]], got[0]
    assert all(torch.equal(a, b) for a, b in zip(first, kept))


def test_captured_step_against_jax():
    """``test_torch_spatial.py``'s comparison with the JAX spatial step, on
    sorted scans with their centers (the captured step's input): the
    captured step on ``["cpu"] * 8`` against the JAX ``make_spatial_step``
    (``with_scan_center``) on the 8-device mesh: labels >= 99.95 %, ground
    atol 2e-4 / rtol 1e-4, confidence 1e-5 / 1e-5, centers bitwise."""
    jcfg = JConfig(**SMALL_KW, sorted_scans=True)
    step = spatial.make_spatial_step(CONFIG, MESH, with_scan_center=True)
    assert isinstance(step, spatial.CapturedSpatialStep)
    mesh = Mesh(np.array(jax.devices()), ("space",))
    j_step = j_spatial_step(jcfg, mesh, with_scan_center=True)
    grid_sh, pt_sh, rep_sh = (j_spatial_sharding(mesh), NamedSharding(mesh, P("space")),
                              NamedSharding(mesh, P()))
    seq = list(synthetic_sequence(3, seed=5, n_beams=16, n_azimuth=500))
    T0 = np.asarray(seq[0][2], np.float64)
    tracker, j_tracker = CenterTracker(CONFIG, T0[:2, 3]), JTracker(jcfg, T0[:2, 3])
    jst = j_init_state(jcfg, T0.astype(np.float32))
    g, c, center = spatial.blocks_from_numpy(*[np.asarray(a) for a in jst], MESH)
    jg, jc = (jax.device_put(np.asarray(a), grid_sh) for a in (jst.ground, jst.groundpatch))
    jcenter = jax.device_put(np.asarray(jst.center), rep_sh)
    agree = total = 0
    for pts, lbl, T in seq:
        T = np.asarray(T, np.float64)
        scan, _ = prepare_scan(CONFIG, pts, lbl, T, tracker.update(T[:2, 3]), "cpu")
        jscan, _ = j_prepare_scan(jcfg, pts, lbl, T, j_tracker.update(T[:2, 3]))
        g, c, center, labels, outlier = step(g, c, center, spatial.shard_scan(scan, MESH))
        jg, jc, jcenter, jlabels, _ = j_step(jg, jc, jcenter, jscan._replace(
            **{f: jax.device_put(np.asarray(v), pt_sh if f in POINT_FIELDS else rep_sh)
               for f, v in jscan._asdict().items()}))
        np.testing.assert_array_equal(center[0].numpy(), np.asarray(jcenter))
        np.testing.assert_allclose(torch.cat(g).numpy(), np.asarray(jg), atol=2e-4, rtol=1e-4)
        np.testing.assert_allclose(torch.cat(c).numpy(), np.asarray(jc), atol=1e-5, rtol=1e-5)
        lab = torch.cat(labels).numpy()
        total += lab.size
        agree += int((lab == np.asarray(jlabels)).sum())
    assert agree / total >= LABELS_MIN, f"{agree} of {total} labels agree"
