"""The numbers that decide `correct`, each a reading of the program's
output against the reference's.

Training (`leaf_gaps`): for each leaf, the gap between the program's norm
and the reference's, over the larger of the reference's norm of that leaf
and of the median leaf; the worst leaf counts. Leaves whose reference
gradient is under a thousandth of the median leaf's (a key's bias under
softmax: nought to rounding) move under Adam by round-off alone and are
left out, by that rule and not by name.

Serving (`served_gap`): a beam of width K keeps only children that rank
within their parent's K best tokens (K of them from that parent would
otherwise outrank it), and greedy is K = 1. So at each position of a
served row, the gap by which the served token's reference logit lies
below the reference's K-th best logit there is rounding for a sound
program; the widest gap counts.
"""

from __future__ import annotations

import torch

SKIP_BELOW = 1e-3  # of the median leaf's reference gradient norm


def kept_leaves(ref_grads: dict) -> list[str]:
    norms = {n: float(g.norm()) for n, g in ref_grads.items()}
    med = float(torch.tensor(list(norms.values())).median())
    return [n for n, v in norms.items() if v >= SKIP_BELOW * med]


def leaf_gaps(prog: dict, ref: dict, names: list[str]) -> tuple[float, str]:
    """-> (the worst leaf's gap, its name) of the per-leaf norms."""
    ref_norms = {n: float(ref[n].norm()) for n in names}
    med = float(torch.tensor(list(ref_norms.values())).median())
    worst, where = 0.0, ""
    for n in names:
        gap = abs(float(prog[n].float().norm()) - ref_norms[n]) / max(ref_norms[n], med)
        if gap > worst:
            worst, where = gap, n
    return worst, where


def kth_best(logits: torch.Tensor, k: int) -> torch.Tensor:
    return torch.topk(logits, k, dim=-1).values[..., -1]


def served_gap(ref_logits: torch.Tensor, served: torch.Tensor, k: int) -> torch.Tensor:
    """(B, T, V) reference logits and the (B, T) tokens served at those
    positions -> (B,) each row's widest gap below the K-th best."""
    chosen = torch.gather(ref_logits, -1, served[..., None])[..., 0]
    return torch.clamp(kth_best(ref_logits, k) - chosen, min=0.0).amax(-1)
