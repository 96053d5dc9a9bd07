"""Fully sharded data parallelism (FSDP) over the mesh's data axis.

Port of what `adt_str_tpu/parallel/mesh.py:_fsdp_extend` and
`fsdp_partition_specs` give the JAX trainer at `mesh.fsdp: true`. There the
parameters and Adam's moments are laid out sharded over `data` and XLA
inserts the collectives: the data-manual step takes the weights whole
(`in_specs` P() over `data`), so they are all-gathered at its entry, and
the optimizer updates sharded parameters and moments. Here that is stated:

- The layout (`data_dim`): for each state-dict name and global (whole)
  shape, the torch dimension JAX shards over `data`, or None. JAX's rule:
  a leaf under `MIN_SIZE` elements stays replicated; a dimension the
  tensor-parallel spec names (`parallel/tensor_parallel.py:split_of`) is
  never free, even on a model axis of 1 (`P(None, "model")` occupies it at
  any axis size), so every `P("model")` bias stays replicated; of the free
  dimensions that `n_data` divides the largest is taken, the first in
  JAX's `(in, out)` orientation on a tie; a leaf with none stays
  replicated. Torch's linear weights are `(out, in)`, so the choice goes
  through the transpose (the embedding is stored alike in both).
- At rest each rank holds its shard (`chunk(n_data, dim)[data index]`) of
  every data-sharded parameter (`shard_model_`), and the optimizer's `mu`,
  `nu` and `acc` follow it; replicated leaves stay whole. Under a model
  axis the shard is a slice of the rank's tensor-parallel shard along the
  other dimension.
- A step gathers the whole weights once (`gathered`: one flat all-gather
  over the data group, rows packed as (n_data, per-rank elements)) for the
  forward and backward passes, then puts the shards back; the gradients of
  the data-sharded leaves leave by one flat reduce-scatter
  (`FsdpLayout.reduce_grads`), the replicated leaves' by DDP's all-reduce.
- `gather_state_dict` and `shard_state_dict` do the same for checkpoints,
  whose files hold the whole model.
"""

from __future__ import annotations

import contextlib
import math
from typing import Mapping, Optional

import torch

from adt_str_tpu_torch.parallel import tensor_parallel as tp_lib

MIN_SIZE = 1024  # JAX's fsdp_partition_specs min_size: smaller leaves stay replicated
EMBEDDING = "decoder.tgt_tok_emb.embedding.weight"  # (vocab, d) in both packages: not transposed


def tp_dim(name: str) -> Optional[int]:
    """The torch dimension the tensor-parallel spec names for `name`, or None."""
    kind = tp_lib.split_of(name)
    return None if kind is None else (1 if kind == tp_lib.COLS else 0)


def global_shape(name: str, shape, n_model: int) -> tuple[int, ...]:
    """A model-axis rank's shape of `name` -> the whole model's."""
    shape, dim = list(shape), tp_dim(name)
    if dim is not None:
        shape[dim] *= n_model
    return tuple(shape)


def data_dim(name: str, shape, n_data: int, min_size: int = MIN_SIZE) -> Optional[int]:
    """The torch dimension of the whole-model leaf `name` of `shape` that
    JAX's `fsdp_partition_specs` shards over a data axis of `n_data`, or None."""
    if n_data <= 1 or math.prod(shape) < min_size:
        return None
    occupied = tp_dim(name)
    jax_order = range(len(shape) - 1, -1, -1) if len(shape) == 2 and name != EMBEDDING else range(len(shape))
    best, best_size = None, 0
    for d in jax_order:
        if d != occupied and shape[d] % n_data == 0 and shape[d] > best_size:
            best, best_size = d, shape[d]
    return best


def data_dims(shapes: Mapping[str, tuple], n_data: int, n_model: int = 1) -> dict[str, Optional[int]]:
    """{name: data dimension or None} for a model-axis rank's `shapes`."""
    return {n: data_dim(n, global_shape(n, s, n_model), n_data) for n, s in shapes.items()}


def shard(t: torch.Tensor, dim: Optional[int], rank: int, n: int) -> torch.Tensor:
    """Data index `rank`'s part of `t` (all of it when `dim` is None)."""
    return t if dim is None else t.chunk(n, dim)[rank].contiguous()


def shard_state_dict(sd: Mapping[str, torch.Tensor], dims: Mapping[str, Optional[int]], rank: int,
                     n: int) -> dict[str, torch.Tensor]:
    """A state dict whole over the data axis (or one of per-parameter
    moments) -> data index `rank`'s shard of it, the same names."""
    return {k: shard(v, dims[k], rank, n) for k, v in sd.items()}


class FsdpLayout:
    """The data-sharded leaves of one rank's model: their dimensions, whole
    (over the data axis) shapes and places in the flat per-rank buffer.
    `mesh` is the rank's `parallel/mesh.py:DataMesh`."""

    def __init__(self, shapes: Mapping[str, tuple], mesh):
        self.mesh = mesh
        self.n, self.rank = mesh.n_data, mesh.rank
        self.dims = data_dims(shapes, self.n, mesh.n_model)
        self.whole = {k: tuple(s) for k, s in shapes.items()}
        self.sharded = [k for k in shapes if self.dims[k] is not None]
        self.replicated = [k for k in shapes if self.dims[k] is None]
        self.shard_shapes = {k: tuple(shard(torch.empty(self.whole[k], device="meta"), self.dims[k], 0, self.n).shape)
                             for k in self.sharded}

    def __deepcopy__(self, memo) -> "FsdpLayout":  # a copied model keeps its mesh
        return self

    def _pack(self, parts: Mapping[str, torch.Tensor]) -> torch.Tensor:
        return torch.cat([parts[k].reshape(-1) for k in self.sharded])

    def _split(self, flat: torch.Tensor, names: list[str]) -> list[torch.Tensor]:
        """Rows of (n_data, per-rank elements) -> each leaf's (n_data, its elements) block."""
        sizes = [math.prod(self.shard_shapes[k]) for k in names]
        return list(flat.split(sizes, dim=-1))

    def gather(self, shards: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """This rank's shards of the data-sharded leaves (a name missing: the
        dict holds none) -> the whole leaves, by one flat all-gather over the
        data group (every rank of it calls it)."""
        names = [k for k in self.sharded if k in shards]
        if not names:
            return {}
        if len(names) != len(self.sharded):
            raise ValueError(f"a partial state dict: {sorted(set(self.sharded) - set(names))} missing")
        rows = self.mesh.all_gather_flat(self._pack(shards))  # (n_data, per-rank elements)
        return {k: torch.cat([r.reshape(self.shard_shapes[k]) for r in block], self.dims[k])
                for k, block in zip(names, self._split(rows, names))}

    def gather_state_dict(self, sd: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """A rank's state dict (or moments) at rest -> whole over the data axis."""
        whole = self.gather(sd)
        return {k: whole.get(k, v) for k, v in sd.items()}

    def shard_state_dict(self, sd: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """A state dict whole over the data axis -> this rank's shard of it."""
        return shard_state_dict(sd, self.dims, self.rank, self.n)

    def reduce_grads(self, grads: Mapping[str, torch.Tensor], comm_dtype: Optional[torch.dtype],
                     scale: Optional[float], allreduce) -> dict[str, torch.Tensor]:
        """Whole gradients -> their sum over the data group (times `scale`):
        this rank's shard of each data-sharded leaf by one flat
        reduce-scatter, the replicated leaves whole by `allreduce(mesh,
        grads, comm_dtype, scale)` (DDP's); cast to `comm_dtype` for the
        transport when given."""
        out = {}
        if self.sharded:
            buf = torch.cat([torch.stack([c.reshape(-1) for c in grads[k].chunk(self.n, self.dims[k])])
                             for k in self.sharded], dim=1)  # (n_data, per-rank elements)
            dtype = buf.dtype
            mine = self.mesh.reduce_scatter_flat(buf if comm_dtype is None else buf.to(comm_dtype)).to(dtype)
            if scale is not None:
                mine = mine * scale
            out.update({k: part.view(self.shard_shapes[k]) for k, part in zip(self.sharded,
                                                                                self._split(mine, self.sharded))})
        if self.replicated:
            out.update(zip(self.replicated, allreduce(self.mesh, [grads[k] for k in self.replicated], comm_dtype,
                                                      scale)))
        return {k: out[k] for k in grads}


def shard_model_(model: torch.nn.Module, mesh) -> FsdpLayout:
    """Cut the data-sharded parameters of `model` (whole over the data axis;
    a model-axis rank's shard under tensor parallelism) to this rank's
    shards in place -> the layout, kept as `model.fsdp`."""
    params = dict(model.named_parameters())
    layout = FsdpLayout({k: tuple(p.shape) for k, p in params.items()}, mesh)
    with torch.no_grad():
        for k in layout.sharded:
            params[k].data = shard(params[k].data, layout.dims[k], layout.rank, layout.n).clone()
    model.fsdp = layout
    return layout


@contextlib.contextmanager
def gathered(model: torch.nn.Module):
    """The model's data-sharded parameters whole inside the block (one flat
    all-gather), their shards again after it: the gathered copy is freed
    with the last reference to it (the autograd graph's). No-op for a model
    without FSDP."""
    layout = getattr(model, "fsdp", None)
    if layout is None or not layout.sharded:
        yield model
        return
    params = dict(model.named_parameters())
    shards = {k: params[k].data for k in layout.sharded}
    for k, whole in layout.gather(shards).items():
        params[k].data = whole
    try:
        yield model
    finally:
        for k, s in shards.items():
            params[k].data = s
