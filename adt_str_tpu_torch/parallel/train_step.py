"""Training and eval steps on one device.

Port of `adt_str_tpu/parallel/train_step.py:make_train_step`,
`make_synth_train_step`, `make_eval_step` and `make_synth_eval_step`
without a mesh: [synthesis of the batch's audio ->] forward in train mode
(the compute dtype) -> fp32 loss -> backward -> global-norm clip -> AdamW,
eagerly in PyTorch.
The model is the state's parameters, updated in place; `TrainState` holds
it with the optimizer state and the step count, like the JAX `TrainState`.

Dropout keys are data (`models/adt.py:dropout_sites`): each step takes the
(n_sites, 2) key words of its sites, which a trainer draws from a
`torch.Generator` (`draw_site_keys`) and a parity test replays from a JAX
rng. The synthesis draws are data too (`synth/render.py:RenderDraws`).
Multi-GPU data parallelism (the JAX `mesh` option) is ROADMAP's
multi-GPU DDP item; passing a mesh raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from adt_str_tpu_torch import resolve_device
from adt_str_tpu_torch.config import ModelConfig, SynthConfig
from adt_str_tpu_torch.models.adt import ADTModel
from adt_str_tpu_torch.synth.render import RenderDraws, SynthStatics, check_bins_loaded, render_batch
from adt_str_tpu_torch.training.optimizer import OptState, Optimizer, apply_updates, global_norm


@dataclass
class TrainState:
    model: ADTModel
    opt_state: OptState
    step: int = 0


def init_train_state(model: ADTModel, opt: Optimizer) -> TrainState:
    return TrainState(model, opt.init(dict(model.named_parameters())), 0)


def _tokens_on(batch: dict, device: torch.device) -> tuple[torch.Tensor, Any]:
    """`batch`'s "tokens": (B, T) int and "token_lengths": (B,) int
    (collated) or None, on `device`."""
    lengths = batch.get("token_lengths")
    return batch["tokens"].to(device), None if lengths is None else lengths.to(device)


def _check(model: ADTModel, config: ModelConfig, device: torch.device) -> None:
    if model.config != config:
        raise ValueError("the state's model was built from another ModelConfig")
    if next(model.parameters()).device.type != device.type:
        raise ValueError(f"the model lies on {next(model.parameters()).device}, the step runs on {device}")


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError("no mesh yet: multi-GPU data parallelism is ROADMAP's multi-GPU DDP item")


def _update(state: TrainState, opt: Optimizer, wavs, tokens, lengths, site_keys) -> tuple[TrainState, dict]:
    """Loss and gradients of the state's model on one batch, then the
    optimizer's update in place."""
    model = state.model
    params = dict(model.named_parameters())
    loss = model.forward_loss(wavs, tokens, lengths, keys=site_keys, train=True)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    updates, opt_state = opt.update(grads, state.opt_state, params)
    apply_updates(params, updates)
    metrics = {"loss": loss.detach(), "grad_norm": global_norm(grads.values())}
    if opt.skip_nonfinite > 0:
        metrics["notfinite_total"] = opt_state.total_notfinite
    return TrainState(model, opt_state, state.step + 1), metrics


def make_train_step(config: ModelConfig, opt: Optimizer, device=None, mesh=None):
    """-> `step(state, batch, site_keys) -> (state, metrics)` for `batch`
    {"wavs": (B, samples) f32, "tokens", "token_lengths"}; metrics hold the
    loss, the global norm of the gradients before clipping, and with the
    non-finite guard on, the count of skipped steps. Runs on `device`
    (None: cuda)."""
    _no_mesh(mesh)
    device = resolve_device(device)

    def step(state: TrainState, batch: dict, site_keys) -> tuple[TrainState, dict]:
        _check(state.model, config, device)
        return _update(state, opt, batch["wavs"].to(device), *_tokens_on(batch, device), site_keys)

    return step


def make_synth_train_step(config: ModelConfig, synth_config: SynthConfig, statics: SynthStatics, opt: Optimizer,
                          device=None, mesh=None):
    """-> `step(state, batch, draws, site_keys) -> (state, metrics)`: the
    training step with the batch's audio synthesised on the device from its
    note lists (`synth/render.py:render_batch`, no gradient), then as
    `make_train_step`. `batch`: {"notes": (B, MAX_NOTES, 4), "note_mask":
    (B, MAX_NOTES), "tokens": (B, T), "token_lengths": (B,)}; `draws` the
    batch's `RenderDraws`. The bank's loaded bins are checked here too."""
    _no_mesh(mesh)
    device = resolve_device(device)
    _synth_statics_on(statics, synth_config, device)

    def step(state: TrainState, batch: dict, draws: RenderDraws, site_keys) -> tuple[TrainState, dict]:
        _check(state.model, config, device)
        with torch.no_grad():
            wavs = render_batch(statics, batch["notes"], batch["note_mask"], draws, synth_config)
        return _update(state, opt, wavs, *_tokens_on(batch, device), site_keys)

    return step


def _synth_statics_on(statics: SynthStatics, synth_config: SynthConfig, device: torch.device) -> None:
    check_bins_loaded(statics, synth_config.similarity_threshold)
    if statics.waveforms.device.type != device.type:
        raise ValueError(f"the bank lies on {statics.waveforms.device}, the step runs on {device}")


def make_eval_step(config: ModelConfig, device=None, mesh=None):
    """-> `step(model, batch) -> loss`: the teacher-forced loss without
    dropout or gradients."""
    _no_mesh(mesh)
    device = resolve_device(device)

    def step(model: ADTModel, batch: dict) -> torch.Tensor:
        _check(model, config, device)
        with torch.no_grad():
            return model.forward_loss(batch["wavs"].to(device), *_tokens_on(batch, device), train=False)

    return step


def make_synth_eval_step(config: ModelConfig, synth_config: SynthConfig, statics: SynthStatics, device=None,
                         mesh=None):
    """-> `step(model, batch, draws) -> loss`: the teacher-forced loss of a
    note-list batch (as `make_synth_train_step` takes it) whose audio is
    rendered under the caller's fixed `draws`, so an eval stream gives the
    same audio at every call; no dropout, no gradients."""
    _no_mesh(mesh)
    device = resolve_device(device)
    _synth_statics_on(statics, synth_config, device)

    def step(model: ADTModel, batch: dict, draws: RenderDraws) -> torch.Tensor:
        _check(model, config, device)
        with torch.no_grad():
            wavs = render_batch(statics, batch["notes"], batch["note_mask"], draws, synth_config)
            return model.forward_loss(wavs, *_tokens_on(batch, device), train=False)

    return step
