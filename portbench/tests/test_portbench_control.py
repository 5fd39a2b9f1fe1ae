"""The check can fail. Its control, the reference computed in bfloat16 in
the program's place, comes out not correct; so does a run whose timed path
is broken underneath: a step that returns its state unchanged, half of the
fleet's batch left out, an answer altered where it is produced, on the
sorted-scan fleet too. A sound run
of the same tiny cells comes out correct. On the fleet over two (CPU)
cards, so does one card's block left unchanged or left out (the check
compares every card's vehicles), and the exchange between the cards left
out of the fleet summary (the check holds the summary to every card's
kept outputs)."""

import pytest
import torch

import groundgrid_torch.core.classify as classifylib
from groundgrid_torch import pipeline
from groundgrid_torch.parallel import sharding
from portbench import check
from portbench.bench import Cell, run_cell
from portbench.control import control_numbers
from portbench.tests import tiny


SORTED = "tinyfleet-sorted.tiny-sorted"


def run(root, workload, seed=5):
    return run_cell(root, workload, seed, 3.0, False, "cpu", log=lambda line: None)


@pytest.mark.parametrize("workload", ["tinylive.tiny", "tinyfleet.tiny", "tinyfleet2.tiny",
                                      SORTED])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_is_not_correct(tmp_path, workload, seed):
    root = tiny.write(tmp_path)
    numbers = control_numbers(root, workload, seed, "cpu")
    assert not check.verdict(numbers, Cell(root, workload).limits), numbers


@pytest.mark.parametrize("workload", ["tinylive.tiny", "tinyfleet.tiny", "tinyreplay.tiny",
                                      "tinyfleet2.tiny", SORTED])
def test_sound_run_is_correct(tmp_path, workload):
    assert run(tiny.write(tmp_path), workload)["correct"] is True


@pytest.mark.parametrize("workload", ["tinylive.tiny", "tinyfleet.tiny", "tinyreplay.tiny",
                                      "tinyfleet2.tiny", SORTED])
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


def test_half_the_sorted_fleet_left_out_is_not_correct(tmp_path, monkeypatch):
    vehicles = sharding.FleetStep._vehicles

    def half(step, block, scan, scalars, center, center_lo):
        # the block's second half of vehicles never stepped: state as it was, labels 0
        keep = block.ground.shape[0] // 2
        g, c = block.ground[keep:].clone(), block.groundpatch[keep:].clone()
        out = vehicles(step, block, scan, scalars, center, center_lo)
        block.ground[keep:], block.groundpatch[keep:] = g, c
        labels = out.labels.clone()
        labels[keep:] = 0
        return out._replace(labels=labels)

    monkeypatch.setattr(sharding.FleetStep, "_vehicles", staticmethod(half))
    result = run(tiny.write(tmp_path), SORTED)
    assert result["correct"] is False
    assert result["checks"]["point_mismatch"]["value"] > 0.25


def _on_second_card(fault):
    """``pipeline.Step.body`` with ``fault`` in place of it on the second
    card's step alone: the fleet's steps, one a card, first run in block
    order."""
    body = pipeline.Step.body
    seen = []

    def on_card(self, ground, groundpatch, points, scalars):
        if self not in seen:
            seen.append(self)
        if seen.index(self) == 1:
            return fault(body, self, ground, groundpatch, points, scalars)
        return body(self, ground, groundpatch, points, scalars)

    return on_card


def _unchanged(body, self, ground, groundpatch, points, scalars):
    _, _, out, aux = body(self, ground, groundpatch, points, scalars)
    return ground.clone(), groundpatch.clone(), out, aux


def _left_out(body, self, ground, groundpatch, points, scalars):
    _, _, out, aux = body(self, ground, groundpatch, points, scalars)
    return (ground.clone(), groundpatch.clone(),
            out._replace(labels=torch.zeros_like(out.labels)), aux)


@pytest.mark.parametrize("fault, number", [(_unchanged, "layer_mismatch"),
                                           (_left_out, "point_mismatch")])
def test_one_cards_block_faulted_is_not_correct(tmp_path, monkeypatch, fault, number):
    monkeypatch.setattr(pipeline.Step, "body", _on_second_card(fault))
    result = run(tiny.write(tmp_path), "tinyfleet2.tiny")
    assert result["correct"] is False
    assert result["checks"][number]["value"] > result["checks"][number]["limit"]


def test_exchange_between_cards_left_out_is_not_correct(tmp_path, monkeypatch):
    call = sharding.FleetStep.__call__

    def first_card_only(self, states, scans):
        # the summary as the first card's block alone counts it
        states, outs, _ = call(self, states, scans)
        out = outs[0]
        return states, outs, sharding.FleetSummary(
            (out.labels == classifylib.LABEL_GROUND).sum(),
            (out.labels == classifylib.LABEL_NONGROUND).sum(), out.outlier.sum(dtype=torch.int64))

    root = tiny.write(tmp_path)
    sound = run(root, "tinyfleet2.tiny")
    assert sound["checks"]["summary_off"] == {"value": 0, "limit": 0}
    monkeypatch.setattr(sharding.FleetStep, "__call__", first_card_only)
    result = run(root, "tinyfleet2.tiny")
    assert result["correct"] is False
    assert result["checks"]["summary_off"]["value"] > 0
    # the labels are sound: only the summary gives the fault away
    points = result["checks"]["point_mismatch"]
    assert points["value"] <= points["limit"]


@pytest.mark.parametrize("workload", ["tinylive.tiny", "tinyfleet.tiny", "tinyreplay.tiny",
                                      SORTED])
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
