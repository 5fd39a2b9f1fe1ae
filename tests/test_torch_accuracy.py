"""The port's evidence tooling: accuracy harness, config fuzz, ``accuracy`` CLI.

The port (plain kernel versions on CPU tensors) is the pipeline under test
against its copy of the golden oracle, at the sizes the JAX package's own
tests use (``tests/test_accuracy.py``, ``tests/test_config_fuzz.py``) and
within their bounds: max |metric delta| < 0.1 pt and label disagreement
< 2e-3 per run (wire rows: < 1 pt). The default config runs unsorted mode.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from groundgrid_torch.config import GroundGridConfig
from groundgrid_torch.eval import fuzz
from groundgrid_torch.eval.accuracy import (
    HEADLINE,
    format_accuracy_report,
    run_accuracy_benchmark,
)
from groundgrid_torch.runtime.cli import main

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def result():
    cfg = GroundGridConfig(dimension=60.0, resolution=0.5, max_points=32768)
    assert not cfg.sorted_scans
    return run_accuracy_benchmark(cfg, n_scans=10, seed=23, n_beams=32, n_azimuth=900,
                                  step_m=2.0, adversarial=True, device="cpu")


def test_headline_deltas_within_budget(result):
    assert result["max_abs_delta_pt"] < 0.1, result["delta_pt"]
    assert result["pipeline"]["clouds"] == result["golden"]["clouds"] == 10
    assert result["workload"]["total_points"] > 100_000
    assert result["workload"]["backend"] == "cpu"


def test_f1_ioug_deltas_and_mismatch(result):
    assert abs(result["delta_pt"]["f1"]) < 0.1, result["delta_pt"]
    assert abs(result["delta_pt"]["ioug"]) < 0.1, result["delta_pt"]
    assert result["label_mismatch_rate"] < 2e-3


def test_metrics_finite_and_report(result):
    for eng in ("pipeline", "golden"):
        for k in HEADLINE:
            v = result[eng][k]
            assert np.isfinite(v) and 0.0 <= v <= 1.0, (eng, k, v)
    assert result["golden"]["precision"] > 0.9
    report = format_accuracy_report(result)
    assert "python -m groundgrid_torch accuracy" in report
    assert f"{result['max_abs_delta_pt']:.4f} pt" in report


def test_kitti_world_and_chaos_control():
    """The KITTI-operating-point world through the same harness, sorted mode,
    with the ulp chaos control's envelope reported."""
    cfg = GroundGridConfig(dimension=60.0, resolution=0.5, max_points=32768,
                           sorted_scans=True)
    r = run_accuracy_benchmark(cfg, n_scans=6, seed=1, n_beams=32, n_azimuth=900, step_m=1.2,
                               world="kitti", variant="city", chaos_control="ulp",
                               device="cpu")
    assert (r["workload"]["world"], r["workload"]["variant"]) == ("kitti", "city")
    assert r["pipeline"]["clouds"] == r["golden"]["clouds"] == 6
    assert r["max_abs_delta_pt"] < 0.1, r["delta_pt"]
    assert r["chaos_mode"] == "ulp" and np.isfinite(r["max_abs_chaos_envelope_pt"])


def test_pipeline_config_must_share_the_geometry():
    cfg = GroundGridConfig(dimension=40.0, resolution=0.5, max_points=16384)
    for change in ({"resolution": 0.4}, {"dimension": 44.0}):
        with pytest.raises(ValueError, match="pipeline_config"):
            run_accuracy_benchmark(cfg, n_scans=1, pipeline_config=dataclasses.replace(
                cfg, **change), device="cpu")


def _assert_row(r, wire=False):
    summary = (r["config"], r["delta_pt"], r["label_mismatch_rate"])
    assert fuzz.row_ok(r, wire), summary
    assert r["workload"]["total_points"] > 5000, summary


@pytest.mark.parametrize("row", range(len(fuzz.boundary_configs())))
def test_fuzz_boundary_configs(row):
    runs = fuzz.campaign(0)
    name, cfg, seed = runs[row]
    _assert_row(fuzz.fuzz_one(cfg, seed=seed, device="cpu"))


@pytest.mark.parametrize("seed", range(3))
def test_fuzz_random_configs(seed):
    """As drawn: ``random_config`` leaves ``sorted_scans`` False."""
    cfg = fuzz.random_config(np.random.default_rng(1000 + seed))
    assert not cfg.sorted_scans
    _assert_row(fuzz.fuzz_one(cfg, seed=40 + seed, device="cpu"))


@pytest.mark.parametrize("mode", ["fused", "wire"])
def test_fuzz_fused_and_wire_rows(mode):
    cfg = fuzz.random_config(np.random.default_rng(1003))
    if mode == "fused":
        cfg = dataclasses.replace(cfg, fused_detect=True)
    _assert_row(fuzz.fuzz_one(cfg, seed=43, wire=mode == "wire", device="cpu"),
                wire=mode == "wire")


def test_fuzz_runner(tmp_path, capsys):
    out = tmp_path / "fuzz.md"
    rc = fuzz.main(["--n", "1", "--device", "cpu", "--out", str(out)])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and summary["failures"] == 0 and summary["configs"] == 6
    table = out.read_text()
    assert table.count("| ok |") == 6 and "u32-sort ceiling exact" in table


def test_accuracy_cli(tmp_path, capsys):
    args = ["accuracy", "--device", "cpu", "--scans", "3", "--beams", "32", "--azimuth", "600",
            "--step", "2.0", "--dimension", "40", "--resolution", "0.5", "--max-points",
            "16384", "--no-sorted"]
    out = tmp_path / "acc.md"
    assert main(args + ["--output", str(out)]) == 0
    payload = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert payload["max_abs_delta_pt"] < 0.1
    assert payload["workload"]["n_scans"] == 3 and payload["workload"]["cells"] == 80
    assert "| f1 |" in out.read_text()
    # the exit code follows --budget-pt: nothing is within a zero budget
    assert main(args + ["--budget-pt", "0", "--output", str(out)]) == 1
