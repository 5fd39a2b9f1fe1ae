"""The check can fail. Its control, the reference computed in bfloat16 in
the program's place, comes out not correct; so does a run whose timed path
is broken underneath: a step that returns its state unchanged, half of the
fleet's batch left out, an answer altered where it is produced. A sound run
of the same tiny cells comes out correct. (The cells take one card, so no
exchange between cards can be left out.)"""

import pytest
import torch

import groundgrid_torch.core.classify as classifylib
from groundgrid_torch import pipeline
from portbench import check
from portbench.bench import Cell, run_cell
from portbench.control import control_numbers
from portbench.tests import tiny


def run(root, workload, seed=5):
    return run_cell(root, workload, seed, 3.0, False, "cpu", log=lambda line: None)


@pytest.mark.parametrize("workload", ["tinylive.tiny", "tinyfleet.tiny"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_is_not_correct(tmp_path, workload, seed):
    root = tiny.write(tmp_path)
    numbers = control_numbers(root, workload, seed, "cpu")
    assert not check.verdict(numbers, Cell(root, workload).limits), numbers


@pytest.mark.parametrize("workload", ["tinylive.tiny", "tinyfleet.tiny", "tinyreplay.tiny"])
def test_sound_run_is_correct(tmp_path, workload):
    assert run(tiny.write(tmp_path), workload)["correct"] is True


@pytest.mark.parametrize("workload", ["tinylive.tiny", "tinyfleet.tiny", "tinyreplay.tiny"])
def test_state_left_unchanged_is_not_correct(tmp_path, monkeypatch, workload):
    body = pipeline.Step.body

    def unchanged(self, ground, groundpatch, points, scalars):
        _, _, out, aux = body(self, ground, groundpatch, points, scalars)
        return ground.clone(), groundpatch.clone(), out, aux

    monkeypatch.setattr(pipeline.Step, "body", unchanged)
    result = run(tiny.write(tmp_path), workload)
    assert result["correct"] is False
    assert result["checks"]["layer_mismatch"]["value"] > result["checks"]["layer_mismatch"]["limit"]


def test_half_the_fleet_left_out_is_not_correct(tmp_path, monkeypatch):
    body = pipeline.Step.body

    def half(self, ground, groundpatch, points, scalars):
        g, c, out, aux = body(self, ground, groundpatch, points, scalars)
        keep = ground.shape[0] // 2
        g, c = g.clone(), c.clone()
        g[keep:], c[keep:] = ground[keep:], groundpatch[keep:]
        labels = out.labels.clone()
        labels[keep:] = 0
        return g, c, out._replace(labels=labels), aux

    monkeypatch.setattr(pipeline.Step, "body", half)
    result = run(tiny.write(tmp_path), "tinyfleet.tiny")
    assert result["correct"] is False
    assert result["checks"]["point_mismatch"]["value"] > 0.25


@pytest.mark.parametrize("workload", ["tinylive.tiny", "tinyfleet.tiny", "tinyreplay.tiny"])
def test_altered_answer_is_not_correct(tmp_path, monkeypatch, workload):
    classify = classifylib.classify

    def altered(*args, **kwargs):
        labels = classify(*args, **kwargs)
        flip = torch.zeros_like(labels, dtype=torch.bool)
        flip[..., ::16] = True
        swapped = torch.where(labels == classifylib.LABEL_GROUND, classifylib.LABEL_NONGROUND,
                              classifylib.LABEL_GROUND).to(labels.dtype)
        return torch.where(flip & (labels > 0), swapped, labels)

    monkeypatch.setattr(classifylib, "classify", altered)
    result = run(tiny.write(tmp_path), workload)
    assert result["correct"] is False
    assert result["checks"]["point_mismatch"]["value"] > result["checks"]["point_mismatch"]["limit"]
