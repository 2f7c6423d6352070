"""The check that decides ``correct`` fails a broken timed path: a tiny run of
each cell on the CPU (past the harness's look for a card), once sound and
once with a fault planted in the program underneath, of each kind the cell
can have. The cells run their fp32 configuration here, where the program's
CPU path and the reference agree to round-off, so that every fault stands
out of the limits whatever the precision of the cell on the card."""

import pytest
import torch

from cwdm_bench.tests import tiny

torch.set_num_threads(2)


def _altered_volume(monkeypatch):
    """The answer altered where it is produced: the volume 10 % too dark."""
    from fast_cwdm_tpu_torch.cli import common

    real = common.make_synthesis_fn

    def make(*a, **kw):
        run = real(*a, **kw)
        return lambda *x, **y: 0.9 * run(*x, **y)

    monkeypatch.setattr(common, "make_synthesis_fn", make)


def _step_returns_its_input(monkeypatch):
    """One reverse step (t = 0) returns its latent unchanged."""
    from fast_cwdm_tpu_torch.diffusion.gaussian import GaussianDiffusion

    real = GaussianDiffusion.p_sample

    def p_sample(self, model_fn, x, t, noise, **kw):
        out = real(self, model_fn, x, t, noise, **kw)
        return {**out, "sample": x} if int(t[0]) == 0 else out

    monkeypatch.setattr(GaussianDiffusion, "p_sample", p_sample)


def _state_unchanged(monkeypatch):
    """The optimizer step leaves the parameters and its moments as they were."""
    from fast_cwdm_tpu_torch.training import train

    def update_(self, params, grads, state):
        state["count"] += 1

    monkeypatch.setattr(train.AdamW, "update_", update_)


def _leaf_unmoved(monkeypatch):
    """One leaf that the reference moves gets no gradient: the output conv's bias."""
    from fast_cwdm_tpu_torch.training import train

    real = train.AdamW.update_

    def update_(self, params, grads, state):
        grads = dict(grads, **{"out.2.bias": torch.zeros_like(grads["out.2.bias"])})
        real(self, params, grads, state)

    monkeypatch.setattr(train.AdamW, "update_", update_)


def _nan_after_checked_steps(monkeypatch):
    """Every step after the three checked ones reports a non-finite loss:
    the window's own steps fail where the check does not look."""
    from fast_cwdm_tpu_torch.training import train

    real = train.make_train_step

    def make(*a, **kw):
        step, calls = real(*a, **kw), [0]

        def nan_later(*x, **y):
            state, metrics = step(*x, **y)
            calls[0] += 1
            if calls[0] > 3:
                metrics = dict(metrics, loss=metrics["loss"] * float("nan"))
            return state, metrics

        return nan_later

    monkeypatch.setattr(train, "make_train_step", make)


@pytest.mark.parametrize("fault", [None, _altered_volume, _step_returns_its_input])
def test_synthesis(monkeypatch, fault):
    if fault:
        fault(monkeypatch)
    out = tiny.run("synth10.fp32", "cwdm-fp32")
    assert out["attempted"] > 0
    assert out["correct"] is (fault is None), out["limits"]


@pytest.mark.parametrize("fault", [None, _state_unchanged, _leaf_unmoved,
                                   _nan_after_checked_steps])
def test_training(monkeypatch, fault):
    if fault:
        fault(monkeypatch)
    out = tiny.run("train.bf16", "cwdm-fp32")
    assert out["attempted"] > 0
    assert out["correct"] is (fault is None), out["limits"]
    assert (out["failed"] > 0) is (fault is _nan_after_checked_steps)
