"""`correct` comes out false when the timed path is broken underneath, and
the control (the reference in fp8 put in the program's place) fails the
cell's limits: tiny cells on the CPU, driven past the harness's look for
a card, with each fault a cell can have planted in the port.

Faults: a training step that returns its state unchanged; half of the
batch left out, the mean taken over the rest; a served token altered where
it is produced. (One chip: no exchange between chips to leave out.)"""

from __future__ import annotations

import pytest
import torch

from benchmark import calibrate
from benchmark.drivers import serve_backlog, train_synth
from benchmark.tests import tiny


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _unchanged(monkeypatch):
    from adt_str_tpu_torch.parallel import train_step

    def update(state, opt, wavs, tokens, lengths, site_keys, dp):
        with torch.no_grad():
            loss = state.model.forward_loss(wavs, tokens, lengths, keys=site_keys, train=True)
        return train_step.TrainState(state.model, state.opt_state, state.step + 1), {"loss": loss,
                                                                                      "grad_norm": loss * 0}

    monkeypatch.setattr(train_step, "_update", update)


def _half_batch(monkeypatch):
    from adt_str_tpu_torch.models.adt import ADTModel

    whole = ADTModel.forward_loss

    def half(self, wave, tokens, lengths, *args, **kwargs):
        n = wave.shape[0] // 2
        return whole(self, wave[:n], tokens[:n], None if lengths is None else lengths[:n], *args, **kwargs)

    monkeypatch.setattr(ADTModel, "forward_loss", half)


def _altered_token(monkeypatch):
    from adt_str_tpu_torch.models import decode

    served = decode.greedy_decode

    def altered(model, wave, *args, **kwargs):
        out = served(model, wave, *args, **kwargs).clone()
        mid = out.shape[1] // 2
        out[:, mid] = (out[:, mid] + 1) % model.config.tgt_vocab_size
        return out

    monkeypatch.setattr(decode, "greedy_decode", altered)


def test_a_sound_tiny_training_run_is_correct():
    assert train_synth.run(tiny.train_context(seconds=0.5))["correct"]


@pytest.mark.parametrize("fault", [_unchanged, _half_batch], ids=["state-unchanged", "half-batch"])
def test_a_training_fault_reads_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    out = train_synth.run(tiny.train_context(seconds=0.5))
    assert not out["correct"], out["checks"]


def test_a_sound_tiny_served_run_is_correct():
    assert serve_backlog.run(tiny.serve_context(seconds=1.5))["correct"]


def test_an_altered_served_token_reads_not_correct(monkeypatch):
    _altered_token(monkeypatch)
    out = serve_backlog.run(tiny.serve_context(seconds=1.5))
    assert not out["correct"], out["checks"]


def test_the_training_control_fails_a_limit():
    ctx = tiny.train_context(seed=11)
    got = calibrate.train_seed(ctx, control=True)["control_fp8"]
    assert any(got[k] > ctx.mix["limits"][k] for k in ctx.mix["limits"]), got


def test_the_serving_control_fails_its_limit():
    ctx = tiny.serve_context(seed=11)
    got = calibrate.serve_seed(ctx, control=True)["control_fp8"]
    assert any(got[k] > ctx.mix["limits"][k] for k in ctx.mix["limits"]), got
