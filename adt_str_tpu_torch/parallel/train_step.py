"""Training and eval steps on one device.

Port of `adt_str_tpu/parallel/train_step.py:make_train_step` /
`make_eval_step` without a mesh: forward in train mode (the compute dtype)
-> fp32 loss -> backward -> global-norm clip -> AdamW, eagerly in PyTorch.
The model is the state's parameters, updated in place; `TrainState` holds
it with the optimizer state and the step count, like the JAX `TrainState`.

Dropout keys are data (`models/adt.py:dropout_sites`): each step takes the
(n_sites, 2) key words of its sites, which a trainer draws from a
`torch.Generator` (`draw_site_keys`) and a parity test replays from a JAX
rng. Multi-GPU data parallelism (the JAX `mesh` option) is ROADMAP's
multi-GPU DDP item; passing a mesh raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from adt_str_tpu_torch import resolve_device
from adt_str_tpu_torch.config import ModelConfig
from adt_str_tpu_torch.models.adt import ADTModel
from adt_str_tpu_torch.training.optimizer import OptState, Optimizer, apply_updates, global_norm


@dataclass
class TrainState:
    model: ADTModel
    opt_state: OptState
    step: int = 0


def init_train_state(model: ADTModel, opt: Optimizer) -> TrainState:
    return TrainState(model, opt.init(dict(model.named_parameters())), 0)


def _batch_on(batch: dict, device: torch.device) -> tuple[torch.Tensor, torch.Tensor, Any]:
    """`batch`: {"wavs": (B, samples) f32, "tokens": (B, T) int,
    "token_lengths": (B,) int (collated) or None}."""
    lengths = batch.get("token_lengths")
    return (batch["wavs"].to(device), batch["tokens"].to(device),
            None if lengths is None else lengths.to(device))


def _check(model: ADTModel, config: ModelConfig, device: torch.device) -> None:
    if model.config != config:
        raise ValueError("the state's model was built from another ModelConfig")
    if next(model.parameters()).device.type != device.type:
        raise ValueError(f"the model lies on {next(model.parameters()).device}, the step runs on {device}")


def make_train_step(config: ModelConfig, opt: Optimizer, device=None, mesh=None):
    """-> `step(state, batch, site_keys) -> (state, metrics)`; metrics hold
    the loss, the global norm of the gradients before clipping, and with the
    non-finite guard on, the count of skipped steps. Runs on `device`
    (None: cuda)."""
    if mesh is not None:
        raise NotImplementedError("no mesh yet: multi-GPU data parallelism is ROADMAP's multi-GPU DDP item")
    device = resolve_device(device)

    def step(state: TrainState, batch: dict, site_keys) -> tuple[TrainState, dict]:
        model = state.model
        _check(model, config, device)
        wavs, tokens, lengths = _batch_on(batch, device)
        params = dict(model.named_parameters())
        loss = model.forward_loss(wavs, tokens, lengths, keys=site_keys, train=True)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        updates, opt_state = opt.update(grads, state.opt_state, params)
        apply_updates(params, updates)
        metrics = {"loss": loss.detach(), "grad_norm": global_norm(grads.values())}
        if opt.skip_nonfinite > 0:
            metrics["notfinite_total"] = opt_state.total_notfinite
        return TrainState(model, opt_state, state.step + 1), metrics

    return step


def make_eval_step(config: ModelConfig, device=None, mesh=None):
    """-> `step(model, batch) -> loss`: the teacher-forced loss without
    dropout or gradients."""
    if mesh is not None:
        raise NotImplementedError("no mesh yet: multi-GPU data parallelism is ROADMAP's multi-GPU DDP item")
    device = resolve_device(device)

    def step(model: ADTModel, batch: dict) -> torch.Tensor:
        _check(model, config, device)
        wavs, tokens, lengths = _batch_on(batch, device)
        with torch.no_grad():
            return model.forward_loss(wavs, tokens, lengths, train=False)

    return step
