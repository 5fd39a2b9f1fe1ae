"""The port's tracer (``groundgrid_torch/trace.py``): spans at the layer
boundaries, recorded only while tracing is on, profiler ranges whenever a
profiler runs, and the stamped twin of a captured step on the card.

The CPU runs step a captured step (``pipeline.CapturedStep``, which runs its
body where the card would replay) through ``StreamingDriver`` and a
4-vehicle ``FleetStep`` (the fleet's batched tick through ``FleetDriver``).
"""

import threading

import numpy as np
import pytest
import torch

from groundgrid_torch import FleetDriver, GroundGridConfig, ScanRecord, StreamingDriver, trace
from groundgrid_torch import pipeline as tpipe
from groundgrid_torch.data.synthetic import synthetic_sequence

torch.set_num_threads(1)

TINY = dict(dimension=24.0, resolution=0.5, max_points=4096, ray_steps=28,
            max_outlier_candidates=256)
DRIVER_SPANS = ("runtime.dispatch", "runtime.prep", "step.scalars", "step.replay",
                "runtime.fetch", "runtime.fetch.wait")
FLEET_SPANS = ("fleet.tick", "fleet.scalars", "fleet.copy", "step.replay")
PARENT = {"runtime.prep": "runtime.dispatch", "step.scalars": "runtime.dispatch",
          "runtime.fetch.wait": "runtime.fetch", "fleet.scalars": "fleet.tick",
          "fleet.copy": "fleet.tick", "runtime.dispatch": None, "runtime.fetch": None,
          "fleet.tick": None}


@pytest.fixture(autouse=True)
def tracing_off():
    trace.disable()
    yield
    trace.disable()


def _records(n: int, first: int = 0, seed: int = 3):
    return [ScanRecord(index=first + k, timestamp=0.1 * k,
                       points=np.concatenate([p, np.zeros((len(p), 1), np.float32)], 1),
                       labels=l, t_map_velo=T)
            for k, (p, l, T) in enumerate(synthetic_sequence(n, seed=seed, n_beams=8,
                                                             n_azimuth=128, step_m=1.5))]


def _drive(n_scans: int = 3, ticks: int = 2):
    """A streaming driver over ``n_scans`` records (indices 10, 11, ...),
    then a 4-vehicle fleet over ``ticks`` ticks."""
    cfg = GroundGridConfig(**TINY)
    driver = StreamingDriver(cfg, "cpu")
    assert isinstance(driver.step, tpipe.CapturedStep)
    for rec in _records(n_scans, first=10):
        driver.process(rec)
    fleet = FleetDriver(cfg, batch=4, device="cpu")
    assert fleet.step.batched
    list(fleet.run([_records(ticks, seed=s) for s in range(4)]))
    return driver, fleet


def test_tracing_off_records_nothing():
    """With tracing off a span is one shared null context, and stepping
    the captured step and a 4-vehicle fleet records nothing."""
    assert trace.span("a") is trace.span("b", id=3)
    _drive()
    snap = trace.snapshot()
    assert snap["spans"] == {} and snap["ring"] == [] and snap["overwritten"] == 0
    assert snap["stages"] == []  # no graph on the CPU
    assert set(snap["launches"]) >= {"raster", "spiral", "move"}


def _children_total(ring):
    out = {}
    for r in ring:
        out[r.parent] = out.get(r.parent, 0) + r.end_ns - r.start_ns
    return out


def test_fleet_scalars_one_span_a_block():
    """A traced fleet tick on two blocks records one ``fleet.scalars`` span
    a block (one pass over its vehicles), each inside its tick."""
    trace.enable()
    fleet = FleetDriver(GroundGridConfig(**TINY), batch=4, mesh=["cpu"] * 2)
    list(fleet.run([_records(2, seed=s) for s in range(4)]))
    ring = trace.snapshot()["ring"]
    by_seq = {r.seq: r for r in ring}
    ticks = [r for r in ring if r.name == "fleet.tick"]
    assert len(ticks) == 2
    for tick in ticks:
        inside = [r for r in ring if r.name == "fleet.scalars" and r.parent == tick.seq]
        assert len(inside) == 2 and all(r.id == tick.id for r in inside)
    assert sum(r.name == "fleet.scalars" for r in ring) == 4
    assert all(by_seq[r.parent].name == "fleet.tick" for r in ring if r.name == "fleet.copy")


def test_spans_record_parent_request_id_and_self_time():
    """Each span of the runtime, the captured step and the fleet appears
    with its parent and its request id (the record's index, the fleet's
    tick), and a name's self time is its total less what its children
    cover."""
    trace.enable()
    driver, fleet = _drive(n_scans=3, ticks=2)
    snap = trace.snapshot()
    ring, spans = snap["ring"], snap["spans"]
    assert snap["overwritten"] == 0 and len(ring) == sum(s["count"] for s in spans.values())
    for name in DRIVER_SPANS[:3] + DRIVER_SPANS[4:]:
        assert spans[name]["count"] == 3, name
    assert spans["fleet.tick"]["count"] == spans["fleet.scalars"]["count"] == 2
    assert spans["fleet.copy"]["count"] == 2
    assert spans["step.replay"]["count"] == 3 + 2
    by_seq = {r.seq: r for r in ring}
    assert sorted(by_seq) == list(range(len(ring)))
    for r in ring:
        assert r.start_ns <= r.end_ns
        parent = by_seq.get(r.parent)
        if r.name in PARENT:
            assert (parent.name if parent else None) == PARENT[r.name], r
        elif r.name == "step.replay":
            assert parent.name in ("runtime.dispatch", "fleet.tick"), r
        elif r.name in tpipe.RASTER_PARTS:
            assert parent.name == "raster", r
        else:  # the body's stages: the CPU runs the body where the card replays
            assert r.name in tpipe.STAGES and parent.name == "step.replay", r
        if parent is not None:
            assert parent.start_ns <= r.start_ns and r.end_ns <= parent.end_ns
            assert r.id == parent.id
    ids = sorted({r.id for r in ring if r.name.startswith("runtime.")})
    assert ids == [10, 11, 12]
    assert sorted(r.id for r in ring if r.name == "fleet.tick") == [0, 1]
    assert fleet.step.ticks == 2
    children = _children_total(ring)
    for name, sums in spans.items():
        mine = [r for r in ring if r.name == name]
        total = sum(r.end_ns - r.start_ns for r in mine)
        assert sums["total_ns"] == total
        assert sums["self_ns"] == total - sum(children.get(r.seq, 0) for r in mine), name
        assert 0 <= sums["self_ns"] <= sums["total_ns"]


@pytest.mark.parametrize("tracing", [False, True])
def test_profiler_window_has_a_range_for_each_span(monkeypatch, tracing):
    """Under ``torch.profiler`` every span is a ``record_function`` range,
    whether tracing is on or off; tracing off still records nothing. (K3's
    plain ring walk, thousands of small ops a scan that make the profile
    slow to read, stands in as a copy of the layers.)"""
    def copy_layers(config, ground, groundpatch, base_z):
        return ground.clone(), groundpatch.clone()

    copy_layers.launches = copy_layers.global_launches = 0  # ops' counters read them
    monkeypatch.setattr(tpipe.spiralops, "spiral_interpolation", copy_layers)
    if tracing:
        trace.enable()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _drive(n_scans=2, ticks=1)
    names = [e.name for e in prof.events() if e.is_user_annotation]
    for name in DRIVER_SPANS + FLEET_SPANS:
        assert name in names, name
    assert names.count("runtime.dispatch") == 2 and names.count("fleet.tick") == 1
    assert {"move", "raster.sums", "spiral"} <= set(names)
    recorded = trace.snapshot()["spans"]
    if tracing:
        assert recorded["runtime.dispatch"]["count"] == 2
    else:
        assert recorded == {}


def test_reset_and_the_rings_overwrite_count():
    """The ring keeps the last ``CAPACITY`` spans and counts the rest as
    overwritten; the sums by name cover every span; ``reset`` drops all."""
    trace.enable()
    extra = 5
    for k in range(trace.CAPACITY + extra):
        with trace.span("tick", id=k):
            pass
    snap = trace.snapshot()
    assert snap["overwritten"] == extra and len(snap["ring"]) == trace.CAPACITY
    assert snap["ring"][0].seq == extra and snap["ring"][-1].id == trace.CAPACITY + extra - 1
    assert snap["spans"]["tick"]["count"] == trace.CAPACITY + extra
    trace.reset()
    assert trace.enabled()
    snap = trace.snapshot()
    assert snap["spans"] == {} and snap["ring"] == [] and snap["overwritten"] == 0
    with trace.span("after"):
        pass
    (r,) = trace.snapshot()["ring"]
    assert r.name == "after" and r.seq == 0 and r.parent == -1 and r.id is None
    trace.disable()
    assert not trace.enabled() and trace.snapshot()["spans"] == {}


def test_spans_on_another_thread_are_not_recorded():
    trace.enable()
    with trace.span("main", id=1):
        worker = threading.Thread(target=lambda: trace.span("worker").__enter__().__exit__())
        worker.start()
        worker.join(timeout=30)
        assert not worker.is_alive()
    assert set(trace.snapshot()["spans"]) == {"main"}


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_stamped_twin_stamps_each_stage_and_rows_do_not_collide():
    """On the card, tracing on replays a stamped twin: S + 1 increasing
    stamps a replay for the S innermost stages that run; two replays in
    flight write rows of their own; its outputs and launch counts are the
    plain graph's, which holds no stamp."""
    from groundgrid_torch import ops

    device = _cuda()
    cfg = GroundGridConfig(**TINY)
    recs = _records(6, seed=5)
    drivers = [StreamingDriver(cfg, device) for _ in range(2)]
    for d in drivers:
        d.process(recs[0])
        d.process(recs[1])  # captured, then replayed: the plain graph
        assert d.step.captured and d.step._twin is None
    ops.reset_launch_counts()
    plain = [drivers[0].process(rec) for rec in recs[2:]]
    torch.cuda.synchronize()
    plain_launches = ops.launch_counts()
    ops.reset_launch_counts()
    trace.enable()
    stamped = list(drivers[1].run(recs[2:], pipeline_depth=2))
    torch.cuda.synchronize()
    assert ops.launch_counts() == plain_launches
    for a, b in zip(plain, stamped):
        assert np.array_equal(a.labels, b.labels) and np.array_equal(a.outlier, b.outlier)
    step = drivers[1].step
    stages = ["transform", "move", "bin", "march", "raster.sort", "raster.columns",
              "raster.sums", "raster.finish", "detect", "spiral", "classify"]
    assert step._stamps.stages == stages
    assert int(step._stamps.count) == 4
    ring = step._stamps.ring[:4, :len(stages) + 1].cpu()
    assert bool((ring[:, 1:] >= ring[:, :-1]).all()) and bool((ring[:, -1] > ring[:, 0]).all())
    assert bool((ring[1:, 0] >= ring[:-1, -1]).all())  # one replay after the other
    snap = trace.snapshot()
    (read,) = snap["stages"]
    assert read["replays"] == 4 and read["batch"] == 1 and read["overwritten"] == 0
    assert list(read["ns"]) == stages and read["ns"]["spiral"] > 0
    assert sum(read["ns"].values()) == int((ring[:, -1] - ring[:, 0]).sum())
    trace.reset()
    assert trace.snapshot()["stages"] == []
    trace.disable()
    assert drivers[1].process(recs[2]) is not None and step._graph is not step._twin
