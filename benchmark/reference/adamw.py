"""AdamW as the configuration states it, in fp32: clip by the global norm
(`g` below the limit, else `g / |g| * limit`), then Adam with torch's
defaults (b1 0.9, b2 0.999, eps 1e-8) bias-corrected by the incremented
count, decoupled weight decay on every weight but biases and LayerNorm
parameters, and the learning rate of the schedule at the count before it
advances: a linear warm-up over ceil(total * ratio) steps, then a cosine
to 0 at `total` steps."""

from __future__ import annotations

import math

import torch


def cosine_lr(base: float, total: int, warmup_ratio: float, count: int) -> float:
    warm = math.ceil(total * warmup_ratio)
    if count < warm:
        return base * count / max(warm, 1)
    progress = min(max((count - warm) / max(total - warm, 1), 0.0), 1.0)
    return base * 0.5 * (1.0 + math.cos(math.pi * progress))


def decays(name: str) -> bool:
    """Weights and the embedding decay; biases and LayerNorm scales do not."""
    return not (name.endswith("bias") or ".norm" in name or name.endswith("layer_norm.weight"))


class AdamW:
    def __init__(self, params: dict, lr: float, total: int, warmup_ratio: float, weight_decay: float,
                 max_grad_norm: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.total, self.warmup_ratio = lr, total, warmup_ratio
        self.wd, self.max_norm, self.b1, self.b2, self.eps = weight_decay, max_grad_norm, b1, b2, eps
        self.count = 0
        self.mu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in params.items()}

    def clipped(self, grads: dict) -> dict:
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        return {n: torch.where(norm < self.max_norm, g, g / norm * self.max_norm) for n, g in grads.items()}

    def step(self, params: dict, grads: dict) -> dict:
        """Updates `params` in place; -> the clipped gradients it applied."""
        g = self.clipped(grads)
        lr = cosine_lr(self.lr, self.total, self.warmup_ratio, self.count)
        self.count += 1
        bc1, bc2 = 1.0 - self.b1 ** self.count, 1.0 - self.b2 ** self.count
        with torch.no_grad():
            for n, p in params.items():
                self.mu[n] = (1 - self.b1) * g[n] + self.b1 * self.mu[n]
                self.nu[n] = (1 - self.b2) * g[n] * g[n] + self.b2 * self.nu[n]
                u = (self.mu[n] / bc1) / (torch.sqrt(self.nu[n] / bc2) + self.eps)
                if decays(n):
                    u = u + self.wd * p
                p.add_(u * -lr)
        return g
