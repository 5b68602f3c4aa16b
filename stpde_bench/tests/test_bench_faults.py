"""A run with its timed path broken underneath comes out not correct:
past the look for a card, at tiny widths on the CPU, each fault the
cells can have planted in the program as the run drives it.

- a step that returns its state unchanged (training);
- half of the batch left out, the mean taken over the rest (training);
- every dispatch after the first reading the first one's batch again,
  as a graph replaying from a stale static buffer would (training);
- an answer altered where it is produced (one decoded value, decode).

The cells run on one chip, so no exchange between chips can be left out.
"""

import pytest
import torch

import space_time_pde_torch.inference as inference
from space_time_pde_torch.data.device_pipeline import DeviceSampler
from space_time_pde_torch.parallel.layout import Layout
from space_time_pde_torch.train.optim import Optimizer
from stpde_bench.tests import tiny


def _unchanged(self, params, grads, state):
    return torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))


def _half_batch(orig):
    def batch_fn(self, origins, pts):
        keep = max(1, len(origins) // 2)
        return orig(self, origins[:keep], pts[:keep])
    return batch_fn


def _stale(orig):
    def make_step(self, *a, **k):
        step, first = orig(self, *a, **k), {}

        def stale(state, batch):
            first.setdefault("batch", batch)
            return step(state, first["batch"])
        return stale
    return make_step


def _altered(orig):
    def decode(*a, **k):
        out = orig(*a, **k).clone()
        out.view(-1)[0] += 1.0
        return out
    return decode


def _sound(workload):
    return tiny.run_cpu(tiny.tiny_cell(workload))[1]


@pytest.mark.parametrize("workload", tiny.TRAIN)
def test_state_left_unchanged(workload, monkeypatch):
    sound = _sound(workload)
    monkeypatch.setattr(Optimizer, "step", _unchanged)
    result, numbers = tiny.run_cpu(tiny.tiny_cell(workload))
    assert result["correct"] is False
    assert numbers["change_gap"] > 10 * sound["change_gap"]
    assert numbers["replay_change_median_gap"] > 10 * sound[
        "replay_change_median_gap"]


@pytest.mark.parametrize("workload", tiny.TRAIN)
def test_half_batch(workload, monkeypatch):
    sound = _sound(workload)
    monkeypatch.setattr(DeviceSampler, "batch_fn",
                        _half_batch(DeviceSampler.batch_fn))
    result, numbers = tiny.run_cpu(tiny.tiny_cell(workload))
    assert result["correct"] is False
    assert numbers["loss_gap"] > 10 * sound["loss_gap"]


@pytest.mark.parametrize("workload", tiny.TRAIN)
def test_stale_batch_after_the_first_dispatch(workload, monkeypatch):
    sound = _sound(workload)
    monkeypatch.setattr(Layout, "make_step", _stale(Layout.make_step))
    result, numbers = tiny.run_cpu(tiny.tiny_cell(workload))
    assert result["correct"] is False
    assert numbers["loss_gap"] < 10 * sound["loss_gap"] + 1e-6
    assert numbers["replay_loss_gap"] > 10 * sound["replay_loss_gap"]


@pytest.mark.parametrize("workload", tiny.DECODE)
def test_answer_altered(workload, monkeypatch):
    sound = _sound(workload)
    monkeypatch.setattr(inference, "decode_blend_gather",
                        _altered(inference.decode_blend_gather))
    result, numbers = tiny.run_cpu(tiny.tiny_cell(workload))
    assert result["correct"] is False
    assert numbers["max_gap"] > 10 * sound["max_gap"]
