"""Tensor parallelism over the mesh's `model` axis: the Megatron layout.

Port of what `adt_str_tpu/parallel/mesh.py:97-191` (`param_partition_specs`)
gives the JAX trainer at `model_axis > 1`. There GSPMD partitions the
products and inserts the collectives; here they are stated:

- `ModelAxis` is one rank's place on the axis: the model group (the
  `n_model` consecutive ranks that share one data index), the rank's index
  in it and the axis size.
- The region operators of Megatron: `copy_to_region` (identity forward,
  the gradient all-reduced over the group backward) enters a
  column-parallel product; `reduce_from_region` (all-reduce forward,
  identity backward) leaves a row-parallel one. A residual branch holds one
  of each, so one all-reduce forward and one backward.
- `row_parallel_linear`: a rank's partial `x W_shard^T` in fp32, all-reduced
  in fp32 and rounded to the compute dtype once, after the sum (as the
  one-process product rounds its fp32 accumulator once), then the
  replicated bias.
- The layout (`split_of`, `shard`, `unshard`) over the port's state-dict
  names (`models/convert.py`):

  | parameter | split |
  |---|---|
  | `in_proj_weight`, `in_proj_bias` | by heads within each of q, k, v (`qkv`) |
  | `out_proj.weight`, `linear2.weight` | by columns (`cols`) |
  | `linear1.weight`, `linear1.bias`, the generator | by rows (`rows`) |
  | everything else | replicated |

  JAX names `in_proj` `P(None, "model")`, which GSPMD may cut anywhere; a
  rank's attention needs whole heads, so rank r holds rows
  [r dl, (r + 1) dl) of each of the three d-row blocks (dl = d / n_model).
- `shard_model_` cuts a model built whole into this rank's shard in place;
  `gather_state_dict` (over the group) and `unshard_state_dicts` put the
  shards back together into the one-process state dict, which a
  checkpoint holds; `shard_state_dict` cuts one again.
- `global_norm` and `all_finite`: the clip's norm and the non-finite guard
  over the whole model (sharded parameters' squares summed over the group,
  replicated ones counted once).
- `vocab_parallel_cross_entropy`: the fp32 CE of vocabulary-sharded logits
  (the max, the sum of exps and the target's logit all-reduced).

A gloo group reduces on the host: CUDA tensors are staged through host
memory.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Mapping, Optional

import torch
import torch.distributed as dist

QKV, ROWS, COLS = "qkv", "rows", "cols"


@dataclasses.dataclass(frozen=True, eq=False)
class ModelAxis:
    """This rank's place on the model axis: `group` its model group, `rank`
    its index there, `size` the axis size."""

    group: Any
    rank: int
    size: int

    def __deepcopy__(self, memo) -> "ModelAxis":  # a module copied with its axis keeps the group
        return self

    @property
    def comm_device(self) -> torch.device:
        """Where the backend reduces: the host for gloo, the current card for NCCL."""
        if dist.get_backend(self.group) == "gloo":
            return torch.device("cpu")
        return torch.device("cuda", torch.cuda.current_device())

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """The reduction of `t` over the group, on `t`'s device and dtype (no
        autograd; `t` itself is left as it was)."""
        buf = t.detach().to(self.comm_device, copy=True).contiguous()
        dist.all_reduce(buf, op=op, group=self.group)
        return buf.to(t.device)

    def all_gather(self, t: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's `t` (equal shapes), in rank order, where the backend gathers."""
        buf = t.detach().to(self.comm_device).contiguous()
        parts = [torch.empty_like(buf) for _ in range(self.size)]
        dist.all_gather(parts, buf, group=self.group)
        return parts


class _CopyToRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis: ModelAxis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_reduce(g.float()).to(g.dtype), None


class _ReduceFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis: ModelAxis):
        return axis.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_region(x: torch.Tensor, axis: Optional[ModelAxis]) -> torch.Tensor:
    """Identity forward; the gradient summed over the model group backward."""
    return x if axis is None else _CopyToRegion.apply(x, axis)


def reduce_from_region(x: torch.Tensor, axis: Optional[ModelAxis]) -> torch.Tensor:
    """The sum over the model group forward; identity backward."""
    return x if axis is None else _ReduceFromRegion.apply(x, axis)


def row_parallel_linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                        axis: ModelAxis) -> torch.Tensor:
    """`x W^T + b` of a row-parallel product: this rank's columns of x against
    its columns of W in fp32 (the weight rounded to x's dtype first, as the
    one-process product takes it), summed over the group in fp32, rounded to
    x's dtype once, then the replicated bias in x's dtype."""
    partial = torch.matmul(x.float(), weight.to(x.dtype).float().T)
    y = reduce_from_region(partial, axis).to(x.dtype)
    return y if bias is None else y + bias.to(x.dtype)


# ------------------------------------------------------------------ the layout


def split_of(name: str) -> Optional[str]:
    """How the state-dict entry `name` is split over the model axis (None: replicated)."""
    if name.endswith(("in_proj_weight", "in_proj_bias")):
        return QKV
    if name.endswith(("out_proj.weight", "linear2.weight")):
        return COLS
    if name.endswith(("linear1.weight", "linear1.bias")) or name in ("decoder.generator.weight",
                                                                       "decoder.generator.bias"):
        return ROWS
    return None


def shard(t: torch.Tensor, kind: Optional[str], rank: int, size: int, name: str = "") -> torch.Tensor:
    """Rank `rank`'s part of `t` under `kind`; a split that does not divide raises."""
    if kind is None:
        return t
    dim = 1 if kind == COLS else 0
    n = t.shape[dim] // 3 if kind == QKV else t.shape[dim]
    if n % size:
        raise ValueError(f"{name or 'tensor'} {tuple(t.shape)}: {n} {'rows a q/k/v block' if kind == QKV else kind} "
                         f"do not divide over a model axis of {size}")
    if kind == QKV:
        return torch.cat([block.chunk(size, 0)[rank] for block in t.chunk(3, 0)], 0)
    return t.chunk(size, dim)[rank]


def unshard(parts: list[torch.Tensor], kind: Optional[str]) -> torch.Tensor:
    """The whole tensor from every rank's part (rank order)."""
    if kind is None:
        return parts[0]
    if kind == QKV:
        return torch.cat([torch.cat([p.chunk(3, 0)[i] for p in parts], 0) for i in range(3)], 0)
    return torch.cat(parts, 1 if kind == COLS else 0)


def shard_state_dict(sd: Mapping[str, torch.Tensor], rank: int, size: int) -> dict[str, torch.Tensor]:
    """A one-process state dict (or a dict of per-parameter optimizer
    moments) -> rank `rank`'s shard of it, the same names."""
    return {k: shard(v, split_of(k), rank, size, k).contiguous() for k, v in sd.items()}


def unshard_state_dicts(sds: list[Mapping[str, torch.Tensor]]) -> dict[str, torch.Tensor]:
    """Every rank's shard (rank order) -> the one-process state dict."""
    return {k: unshard([sd[k] for sd in sds], split_of(k)) for k in sds[0]}


def gather_state_dict(sd: Mapping[str, torch.Tensor], axis: ModelAxis) -> dict[str, torch.Tensor]:
    """This rank's shard -> the one-process state dict, gathered over the
    model group (every rank of the group calls it; on the host for gloo)."""
    return {k: unshard(axis.all_gather(v), split_of(k)) if split_of(k) else v for k, v in sd.items()}


def check_divisible(nhead: int, d_ff: int, vocab: int, size: int) -> None:
    bad = {n: v for n, v in (("nhead", nhead), ("d_ff", d_ff), ("tgt_vocab_size", vocab)) if v % size}
    if bad:
        raise ValueError(f"a model axis of {size} needs nhead, d_ff and the vocabulary divisible by it; {bad} are not")


def shard_model_(model: torch.nn.Module, axis: ModelAxis) -> None:
    """Cut a model built whole into this rank's shard, in place: the split
    parameters become their parts, each attention keeps nhead / size heads,
    and every module that runs a region operator holds the axis (`tp`)."""
    from adt_str_tpu_torch.models import transformer as T

    cfg = model.config
    check_divisible(cfg.nhead, cfg.ffn_dim, cfg.tgt_vocab_size, axis.size)
    with torch.no_grad():
        for name, p in list(model.named_parameters()):
            kind = split_of(name)
            if kind is None:
                continue
            owner, _, attr = name.rpartition(".")
            setattr(model.get_submodule(owner), attr,
                    torch.nn.Parameter(shard(p.data, kind, axis.rank, axis.size, name).clone()))
    for mod in model.modules():
        if isinstance(mod, T.MultiheadAttention):
            mod.nhead //= axis.size
        if isinstance(mod, (T.MultiheadAttention, T.EncoderLayer, T.DecoderLayer)):
            mod.tp = axis
    model.tp = axis


def sharded_names(names: Iterable[str]) -> frozenset[str]:
    return frozenset(n for n in names if split_of(n) is not None)


# ------------------------------------------------------------------ norm, guard, loss


def global_norm(grads: Mapping[str, torch.Tensor], axis: ModelAxis, sharded: frozenset) -> torch.Tensor:
    """sqrt of the sum of squares over the whole model, in fp32: the sharded
    entries' squares summed over the group, the replicated ones once."""
    def squares(names):
        return sum((torch.sum(grads[n].float() * grads[n].float()) for n in names),
                   torch.zeros((), device=next(iter(grads.values())).device))

    return torch.sqrt(axis.all_reduce(squares([n for n in grads if n in sharded]))
                      + squares([n for n in grads if n not in sharded]))


def all_finite(grads: Mapping[str, torch.Tensor], axis: ModelAxis) -> bool:
    """Whether every rank's every gradient is finite."""
    bad = sum(int((~torch.isfinite(g)).any()) for g in grads.values())
    return int(axis.all_reduce(torch.tensor([bad], device=axis.comm_device)).item()) == 0


def vocab_parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """Per-token fp32 NLL of this rank's vocabulary columns of the logits
    (nan_to_num'd, as the one-process loss) against the global labels:
    log(sum of exps) - the target's logit, each term all-reduced over the
    group after the max is."""
    logits = torch.nan_to_num(logits.float(), nan=0.0, posinf=1e4, neginf=-1e4)
    v_local = logits.shape[-1]
    with torch.no_grad():
        m = axis.all_reduce(logits.max(dim=-1).values, op=dist.ReduceOp.MAX)
    shifted = logits - m[..., None]
    sum_exp = reduce_from_region(torch.exp(shifted).sum(dim=-1), axis)
    local = labels.long() - axis.rank * v_local
    inside = (local >= 0) & (local < v_local)
    target = torch.gather(shifted, -1, local.clamp(0, v_local - 1)[..., None])[..., 0]
    target = reduce_from_region(torch.where(inside, target, 0.0), axis)
    return torch.log(sum_exp) - target
