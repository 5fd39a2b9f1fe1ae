"""On-device scoring of the port: ``DeviceEvaluator`` and ``evaluate_records``.

Mirrors ``tests/test_eval.py``'s device-evaluator cases on the CPU: the
port's ``DeviceEvaluator`` gives, count for count, the host ``Evaluator``'s
table and the JAX ``DeviceEvaluator``'s on the same labels; drains preserve
the counts; aggregates past 2^31 stay exact; ``evaluate_records`` scores a
stream bitwise as the host scorer does over the driver's labels.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from groundgrid_tpu.eval.device import DeviceEvaluator as JaxDeviceEvaluator

from groundgrid_torch.config import GroundGridConfig
from groundgrid_torch.data.semantickitti import ScanRecord
from groundgrid_torch.data.synthetic import synthetic_sequence
from groundgrid_torch.eval.device import DeviceEvaluator, safe_drain_interval
from groundgrid_torch.eval.metrics import Evaluator
from groundgrid_torch.runtime.driver import StreamingDriver
from groundgrid_torch.runtime.evaluate import evaluate_records

CPU = torch.device("cpu")
TABLES = ("nonground_count", "true_positive", "false_positive", "total")


def _clouds(seed, n_clouds, n, ids=(0, 10, 40, 44, 48, 50, 70, 72, 252, 400)):
    rng = np.random.default_rng(seed)
    return [(rng.choice([0, 49, 99], n, p=[0.05, 0.8, 0.15]).astype(np.int32),
             rng.choice(ids, n).astype(np.int32)) for _ in range(n_clouds)]


def _assert_same_counts(got, want):
    for name in TABLES:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    assert got.clouds == want.clouds
    assert got.compute().as_dict() == want.compute().as_dict()


def test_device_evaluator_matches_host_and_jax():
    """Ids beyond the table (400) are clipped, as the host scorer clips them."""
    host, jdev = Evaluator("09"), JaxDeviceEvaluator("09")
    dev = DeviceEvaluator("09", CPU)
    for pred, gt in _clouds(4, 3, 4000):
        host.add_cloud(pred, gt)
        jdev.add_cloud_device(jnp.asarray(pred), jnp.asarray(gt))
        dev.add_cloud_device(torch.from_numpy(pred), torch.from_numpy(gt))
    got = dev.to_host()
    _assert_same_counts(got, host)
    _assert_same_counts(got, jdev.to_host())
    assert got.format_statistics() == host.format_statistics()


def test_device_evaluator_int16_rings():
    """The wire format's int16 ring channel scores like int32 labels."""
    host, dev = Evaluator(), DeviceEvaluator(device=CPU)
    for pred, gt in _clouds(6, 2, 3000):
        host.add_cloud(pred, gt)
        dev.add_cloud_device(torch.from_numpy(pred), torch.from_numpy(gt.astype(np.int16)))
    _assert_same_counts(dev.to_host(), host)


def test_device_evaluator_drain_preserves_counts():
    host, dev = Evaluator("05"), DeviceEvaluator("05", CPU, drain_every=2)
    for pred, gt in _clouds(11, 7, 3000):  # odd count: the last drain is mid-interval
        host.add_cloud(pred, gt)
        dev.add_cloud_device(torch.from_numpy(pred), torch.from_numpy(gt))
    _assert_same_counts(dev.to_host(), host)
    # to_host is a non-destructive snapshot: counting goes on
    pred, gt = np.full(100, 49, np.int32), np.full(100, 40, np.int32)
    dev.add_cloud_device(torch.from_numpy(pred), torch.from_numpy(gt))
    host.add_cloud(pred, gt)
    _assert_same_counts(dev.to_host(), host)


def test_device_evaluator_beyond_int32():
    """Host counts preloaded near 2^31 carry over drains exactly (int64)."""
    dev = DeviceEvaluator("00-10", CPU, drain_every=1)
    near = 2**31 - 1000
    dev.host_counts[40, 3] = near  # total[road]
    dev.host_counts[40, 1] = near  # tp[road]
    for _ in range(3):
        dev.add_cloud_device(torch.full((2000,), 49, dtype=torch.int32),
                             torch.full((2000,), 40, dtype=torch.int32))
    got = dev.to_host()
    assert int(got.total[40]) == int(got.true_positive[40]) == near + 6000 > 2**31
    assert got.total.dtype == np.int64
    for mp in (4096, 131072, 10**6):
        assert 1 <= safe_drain_interval(mp) and safe_drain_interval(mp) * mp * 8 <= 2**31 - 1


def test_device_evaluator_needs_device():
    with pytest.raises(TypeError):
        DeviceEvaluator("00")


@pytest.fixture(scope="module")
def records():
    scans = synthetic_sequence(4, seed=7, n_beams=24, n_azimuth=720, step_m=1.5)
    return [ScanRecord(index=k, timestamp=0.1 * k, points=p, labels=l, t_map_velo=T)
            for k, (p, l, T) in enumerate(scans)]


SMALL = GroundGridConfig(dimension=40.0, resolution=0.5, max_points=16384, ray_steps=40,
                         max_outlier_candidates=1024, sorted_scans=True)


@pytest.mark.parametrize("config", [SMALL, dataclasses.replace(SMALL, wire_format=True),
                                    dataclasses.replace(SMALL, max_points=8192)],
                         ids=["f32", "wire", "overflow"])
def test_evaluate_records_matches_host_scoring(records, config):
    """On-device scoring of the stream == the host scorer over the driver's
    labels; ``overflow``: scans beyond ``max_points`` (their overflow points
    are unscored on both sides)."""
    ev, stats = evaluate_records(config, records, "00", CPU, progress_every=0)
    driver, host = StreamingDriver(config, CPU), Evaluator("00")
    for rec in records:
        host.add_cloud(driver.process(rec).labels, rec.labels)
    _assert_same_counts(ev, host)
    assert ev.clouds == len(records) and stats.scans == len(records) - 1
    assert ev.compute().recall > 0.9


def test_evaluate_records_progress_and_dropped_pose(records):
    """A non-finite pose is dropped; the 500-cloud print fires at its cadence."""
    bad = dataclasses.replace(records[2], t_map_velo=np.full((4, 4), np.nan))
    lines = []
    ev, _ = evaluate_records(SMALL, [records[0], records[1], bad, records[3]], "00", CPU,
                             progress_every=2, progress=lines.append)
    assert ev.clouds == 3
    assert len(lines) == 1 and "Received 2 point clouds" in lines[0]
