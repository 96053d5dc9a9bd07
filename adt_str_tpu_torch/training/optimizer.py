"""Optimizer + LR schedule.

Port of `adt_str_tpu/training/optimizer.py`, which chains optax transforms;
here the same arithmetic is written as plain tensor ops over a
{name: parameter} dict, in optax's order:

- `apply_if_finite` (outermost, when `skip_nonfinite_updates > 0`): a step
  whose raw gradients hold NaN/Inf returns zero updates and leaves every
  other state untouched, until `N` consecutive such steps let one through;
- `MultiSteps` (when `gradient_accumulation_steps = k > 1`): the running
  mean `acc + (g - acc) / (i + 1)` of a window's gradients; the inner
  update runs on the last micro-step of the window, the others return zero
  updates. The schedule therefore advances once per window (update space);
- the inner update: `clip_by_global_norm` (`g` if `|g| < max`, else
  `(g / |g|) * max`, with no epsilon), then AdamW with torch's defaults
  (b1 0.9, b2 0.999, eps 1e-8): `mu = (1 - b1) g + b1 mu`,
  `nu = (1 - b2) g^2 + b2 nu`, bias-corrected with the incremented count,
  `u = mu_hat / (sqrt(nu_hat) + eps)`, `u += wd * p` where the decay mask
  allows, `u *= -lr` with `lr = schedule(count)` read BEFORE the count
  advances (so a warmup's first update has lr 0).

The HF Trainer decay rule excludes biases and LayerNorm parameters; in the
port LayerNorm's scale is called `weight`, so `decay_mask` goes by module
type, not by name.

A tensor-parallel model's optimizer (`make_optimizer` reads the model's
`tp`) updates the rank's shard elementwise as above; the clip's global
norm and the non-finite guard span the model group
(`parallel/tensor_parallel.py:global_norm`, `all_finite`), so every rank of
it clips by the whole model's norm and skips the same steps.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch
from torch import nn

from adt_str_tpu_torch.config import TrainingConfig
from adt_str_tpu_torch.parallel import tensor_parallel as tp_lib

Schedule = Callable[[int], float]
Params = dict[str, torch.Tensor]


def warmup_cosine_schedule(
    base_lr: float, total_steps: int, warmup_ratio: float = 0.1, min_lr: Optional[float] = None
) -> Schedule:
    """Linear warmup over ceil(total * ratio) steps, then cosine decay: to 0
    at `total_steps` (HF `get_cosine_schedule_with_warmup`), or, with a
    positive `min_lr`, to `min_lr` exactly at the last step `total_steps - 1`
    (the reference's `cosine_warmup_with_min_lr`)."""
    warmup_steps = math.ceil(total_steps * warmup_ratio)
    floor = float(min_lr) if (min_lr is not None and min_lr > 0) else 0.0
    denom = max(total_steps - (1 if floor > 0.0 else 0) - warmup_steps, 1)

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return base_lr * step / max(warmup_steps, 1)
        progress = min(max((step - warmup_steps) / denom, 0.0), 1.0)
        return floor + (base_lr - floor) * 0.5 * (1.0 + math.cos(math.pi * progress))

    return schedule


def make_schedule(config: TrainingConfig, total_steps: int) -> Schedule:
    """`lr_scheduler_type`: `cosine` (with the min-LR floor when
    `min_learning_rate > 0`), `linear` (to 0 at total_steps),
    `constant_with_warmup`, `constant`."""
    t = (config.lr_scheduler_type or "cosine").lower()
    base_lr = float(config.learning_rate)
    warmup_steps = math.ceil(total_steps * config.warmup_ratio)
    if t in ("cosine", "cosine_warmup_with_min_lr", "cosine_with_min_lr"):
        return warmup_cosine_schedule(base_lr, total_steps, config.warmup_ratio, config.min_learning_rate)
    if t == "linear":
        def linear(step: int) -> float:
            if step < warmup_steps:
                return base_lr * step / max(warmup_steps, 1)
            return base_lr * min(max((total_steps - step) / max(total_steps - warmup_steps, 1), 0.0), 1.0)

        return linear
    if t in ("constant", "constant_with_warmup"):
        w = warmup_steps if t == "constant_with_warmup" else 0

        def const(step: int) -> float:
            return base_lr * step / max(w, 1) if step < w else base_lr

        return const
    raise ValueError(f"unsupported lr_scheduler_type: {config.lr_scheduler_type}")


def decay_mask(model: nn.Module) -> dict[str, bool]:
    """{parameter name: decays}: every bias (including `in_proj_bias`) and
    every LayerNorm parameter is excluded; weights and embeddings decay."""
    mask = {}
    for mod_name, mod in model.named_modules():
        for p_name, _ in mod.named_parameters(recurse=False):
            name = f"{mod_name}.{p_name}" if mod_name else p_name
            mask[name] = not (isinstance(mod, nn.LayerNorm) or p_name.endswith("bias"))
    return mask


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32."""
    return torch.sqrt(sum(torch.sum(t.float() * t.float()) for t in tensors))


@dataclass
class OptState:
    count: int = 0  # AdamW updates applied; the schedule reads it before it advances
    mu: Params = field(default_factory=dict)
    nu: Params = field(default_factory=dict)
    mini_step: int = 0  # position in the accumulation window
    acc: Params = field(default_factory=dict)  # running mean of the window's gradients
    notfinite_count: int = 0  # consecutive non-finite steps
    total_notfinite: int = 0


class Optimizer:
    """clip + AdamW (+ accumulation, + the non-finite guard) over
    {name: tensor} dicts, as `optax.chain(clip_by_global_norm, adamw)`
    wrapped in `MultiSteps` and `apply_if_finite`."""

    def __init__(self, schedule: Schedule, *, max_grad_norm: float, weight_decay: float,
                 decay: dict[str, bool], accum_steps: int = 1, skip_nonfinite: int = 0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 model_axis: Optional[tp_lib.ModelAxis] = None):
        self.schedule, self.max_grad_norm, self.weight_decay = schedule, float(max_grad_norm), float(weight_decay)
        self.decay, self.accum_steps, self.skip_nonfinite = decay, max(1, int(accum_steps)), int(skip_nonfinite)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.model_axis = model_axis
        self.sharded = tp_lib.sharded_names(decay) if model_axis is not None else frozenset()

    def grad_norm(self, grads: Params) -> torch.Tensor:
        """The global norm of `grads` (the whole model's, under a model axis)."""
        if self.model_axis is None:
            return global_norm(grads.values())
        return tp_lib.global_norm(grads, self.model_axis, self.sharded)

    def _all_finite(self, grads: Params) -> bool:
        if self.model_axis is None:
            return all(bool(torch.isfinite(g).all()) for g in grads.values())
        return tp_lib.all_finite(grads, self.model_axis)

    def init(self, params: Params) -> OptState:
        zeros = lambda: {n: torch.zeros_like(p) for n, p in params.items()}  # noqa: E731
        return OptState(mu=zeros(), nu=zeros(), acc=zeros() if self.accum_steps > 1 else {})

    def update(self, grads: Params, state: OptState, params: Params) -> tuple[Params, OptState]:
        """-> (updates to add to the params, new state)."""
        if self.skip_nonfinite > 0:
            finite = self._all_finite(grads)
            count = 0 if finite else state.notfinite_count + 1
            state = dataclasses.replace(state, notfinite_count=count,
                                        total_notfinite=state.total_notfinite + (not finite))
            if not finite and count <= self.skip_nonfinite:
                return {n: torch.zeros_like(g) for n, g in grads.items()}, state
        if self.accum_steps > 1:
            i = state.mini_step
            acc = {n: state.acc[n] + (g - state.acc[n]) / (i + 1) for n, g in grads.items()}
            if i < self.accum_steps - 1:
                return {n: torch.zeros_like(g) for n, g in grads.items()}, dataclasses.replace(
                    state, mini_step=i + 1, acc=acc)
            updates, state = self._inner(acc, state, params)
            return updates, dataclasses.replace(state, mini_step=0, acc={n: torch.zeros_like(a) for n, a in acc.items()})
        return self._inner(grads, state, params)

    def _inner(self, grads: Params, state: OptState, params: Params) -> tuple[Params, OptState]:
        g_norm = self.grad_norm(grads)
        trigger = g_norm < self.max_grad_norm
        b1, b2 = self.b1, self.b2
        count = state.count + 1
        bc1, bc2 = 1.0 - b1**count, 1.0 - b2**count
        lr = self.schedule(state.count)
        mu, nu, updates = {}, {}, {}
        for n, g in grads.items():
            g = torch.where(trigger, g, (g / g_norm) * self.max_grad_norm)
            mu[n] = (1 - b1) * g + b1 * state.mu[n]
            nu[n] = (1 - b2) * (g * g) + b2 * state.nu[n]
            u = (mu[n] / bc1) / (torch.sqrt(nu[n] / bc2) + self.eps)
            if self.decay[n]:
                u = u + self.weight_decay * params[n]
            updates[n] = u * -lr
        return updates, dataclasses.replace(state, count=count, mu=mu, nu=nu)


def apply_updates(params: Params, updates: Params) -> None:
    """params += updates, in place."""
    with torch.no_grad():
        for n, p in params.items():
            p.add_(updates[n])


def make_optimizer(config: TrainingConfig, total_steps: int, model: nn.Module) -> tuple[Optimizer, Schedule]:
    """`total_steps` counts micro-steps (one per batch); the schedule runs in
    update space (one step per accumulation window), and the returned
    schedule maps a micro-step to the learning rate it applies."""
    if config.optim not in ("adamw", "adamw_torch", "adamw_hf", "adamw_torch_fused"):
        raise ValueError(f"unsupported optim: {config.optim!r} (AdamW variants only)")
    accum = max(1, int(config.gradient_accumulation_steps))
    schedule = make_schedule(config, max(1, total_steps // accum))
    opt = Optimizer(schedule, max_grad_norm=config.max_grad_norm, weight_decay=config.weight_decay,
                    decay=decay_mask(model), accum_steps=accum, skip_nonfinite=config.skip_nonfinite_updates,
                    model_axis=getattr(model, "tp", None))
    return opt, (lambda step: schedule(step // accum))
