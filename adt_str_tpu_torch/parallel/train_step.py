"""Training and eval steps, on one device or data-parallel over ranks.

Port of `adt_str_tpu/parallel/train_step.py:make_train_step`,
`make_synth_train_step`, `make_eval_step` and `make_synth_eval_step`:
[synthesis of the batch's audio ->] forward in train mode (the compute
dtype) -> fp32 loss -> backward -> global-norm clip -> AdamW, eagerly in
PyTorch. The model is the state's parameters, updated in place;
`TrainState` holds it with the optimizer state and the step count, like
the JAX `TrainState`.

Dropout keys are data (`models/adt.py:dropout_sites`): each step takes the
(n_sites, 2) key words of its sites, which a trainer draws from a
`torch.Generator` (`draw_site_keys`) and a parity test replays from a JAX
rng. The synthesis draws are data too (`synth/render.py:RenderDraws`).

With a `mesh` (`parallel/mesh.py:DataMesh` over a process group), each
rank runs the step on its own rows with its own keys and draws (JAX folds
the rank into the step's rng), and the ranks reduce as JAX's data-manual
`shard_map` does (`_manual_loss_and_grads`):

- by default the exact global token-weighted mean: each rank's masked NLL
  sum and valid-token count, the counts all-reduced before the backward
  pass, the rank's loss `sum / global_count`, its gradients then summed
  over ranks, so loss and gradients equal one process over the global
  batch up to the order of the fp32 sums;
- `ddp_loss_weighting`: each rank's masked mean weighs equally (the
  gradients' sum over ranks divided by the world);
- the gradients travel as one flat buffer and one explicit all-reduce
  after the backward pass (JAX's single `psum`), in fp32 or, with
  `comm_dtype` "bf16", cast to bf16 for the transport and back; clip,
  grad norm, the non-finite guard and the update read the reduced
  gradients, so the ranks' weights stay bit-equal.

The eval steps return the global token-weighted loss under a mesh.

Under a model axis (`DataMesh.model`, a mesh of `n_data x n_model` ranks)
the state's model is this rank's tensor-parallel shard
(`ADTModel(..., tp=mesh.model)`): the forward and backward run the region
operators of `parallel/tensor_parallel.py`, the loss is the
vocabulary-parallel CE, the data-axis reductions above run over the data
group (the ranks of one model index), and the optimizer's clip norm and
non-finite guard span the model group (`training/optimizer.py`). The ranks
of one model group take the same batch, keys and draws.

Under FSDP (the state's model cut by `parallel/fsdp.py:shard_model_`, on a
mesh made with `fsdp=True`) each rank holds its shards of the data-sharded
parameters and moments. A step gathers the whole weights once (one flat
all-gather over the data group), runs the forward and backward passes on
them, puts the shards back, and reduce-scatters the gradients of the
data-sharded leaves (one flat reduce-scatter, the same scaling and
transport dtype as the all-reduce above, which the replicated leaves keep);
the optimizer then updates the shards. The eval steps gather too.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from adt_str_tpu_torch import resolve_device
from adt_str_tpu_torch.config import ModelConfig, SynthConfig
from adt_str_tpu_torch.models.adt import ADTModel
from adt_str_tpu_torch.parallel import fsdp as fsdp_lib
from adt_str_tpu_torch.parallel.mesh import DataMesh
from adt_str_tpu_torch.synth.render import RenderDraws, SynthStatics, check_bins_loaded, render_batch
from adt_str_tpu_torch.training.optimizer import OptState, Optimizer, apply_updates


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


def _check(model: ADTModel, config: ModelConfig, device: torch.device, mesh: Optional[DataMesh] = None) -> None:
    if model.config != config:
        raise ValueError("the state's model was built from another ModelConfig")
    if next(model.parameters()).device.type != device.type:
        raise ValueError(f"the model lies on {next(model.parameters()).device}, the step runs on {device}")
    if (None if mesh is None else mesh.model) is not model.tp:
        raise ValueError("the model's tensor-parallel axis is not the mesh's: build it with "
                         "ADTModel(..., tp=mesh.model)")
    layout = getattr(model, "fsdp", None)
    if mesh is not None and mesh.fsdp and layout is None:
        raise ValueError("the mesh shards the parameters (fsdp=True) but the model is whole: cut it with "
                         "parallel.fsdp.shard_model_(model, mesh)")
    if layout is not None and layout.sharded and layout.mesh is not mesh:
        raise ValueError("the model's FSDP shards were cut for another mesh")


def normalize_comm_dtype(comm_dtype) -> Optional[torch.dtype]:
    """`training.grad_allreduce_dtype`: None/f32 -> the exact fp32
    all-reduce (None), bf16 -> bf16 transport."""
    if comm_dtype in (None, "f32", "fp32", "float32"):
        return None
    if comm_dtype in ("bf16", "bfloat16"):
        return torch.bfloat16
    raise ValueError(f"unsupported grad_allreduce_dtype: {comm_dtype!r} (use 'bf16' or 'f32')")


def _data_parallel(mesh, device) -> tuple[Optional[DataMesh], torch.device]:
    """-> (the mesh a step reduces over, or None; the step's device). A
    step runs one process a rank: a single-process mesh of more than one
    entry raises, one of one entry is no mesh."""
    if mesh is None:
        return None, resolve_device(device)
    if not isinstance(mesh, DataMesh):
        raise TypeError(f"mesh must be a parallel.mesh.DataMesh, got {type(mesh).__name__}")
    if mesh.group is None:
        if mesh.n_data > 1:
            raise ValueError(f"a training or eval step over {mesh.n_data} mesh entries runs one process a rank: "
                             "build the mesh inside a process group (torchrun)")
        return None, resolve_device(mesh.device if device is None else device)
    if device is not None and torch.device(device) != mesh.device:
        raise ValueError(f"the step's device {device} is not the rank's mesh device {mesh.device}")
    return mesh, mesh.device


def _global_mean(mesh: DataMesh, loss_fn, ddp: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (the loss this rank differentiates, the global loss, detached).
    `loss_fn(reduction)` is the rank's forward loss."""
    if ddp:
        mean = loss_fn("mean")
        return mean, mesh.all_reduce(mean.detach().reshape(1))[0] / mesh.world
    s, n = loss_fn("sum")
    total = mesh.all_reduce(torch.stack([s.detach(), n.to(s.dtype)]))
    count = torch.clamp(total[1], min=1.0)
    return s / count, total[0] / count


def allreduce_grads(mesh: DataMesh, grads: list[torch.Tensor], comm_dtype: Optional[torch.dtype],
                    scale: Optional[float] = None) -> list[torch.Tensor]:
    """The gradients summed over the ranks (times `scale`): one flat buffer
    and one all-reduce, cast to `comm_dtype` for the transport when given
    (parameters, moments and the update stay fp32)."""
    if mesh.world == 1:
        return grads if scale is None else [g * scale for g in grads]
    flat = torch.cat([g.reshape(-1) for g in grads])
    if comm_dtype is None:
        flat = mesh.all_reduce(flat)
    else:
        flat = mesh.all_reduce(flat.to(comm_dtype)).to(flat.dtype)
    if scale is not None:
        flat = flat * scale
    return [part.view_as(g) for part, g in zip(flat.split([g.numel() for g in grads]), grads)]


def _update(state: TrainState, opt: Optimizer, wavs, tokens, lengths, site_keys,
            dp: Optional[tuple]) -> tuple[TrainState, dict]:
    """Loss and gradients of the state's model on one batch (reduced over
    the ranks when `dp` = (mesh, transport dtype, ddp weighting)), then the
    optimizer's update in place."""
    model = state.model
    params = dict(model.named_parameters())

    def loss_fn(reduction: str):
        return model.forward_loss(wavs, tokens, lengths, keys=site_keys, train=True, reduction=reduction)

    layout = getattr(model, "fsdp", None)
    with fsdp_lib.gathered(model):  # the whole weights for the forward and backward passes
        if dp is None:
            loss = loss_fn("mean")
            reported = loss.detach()
        else:
            mesh, comm_dtype, ddp = dp
            loss, reported = _global_mean(mesh, loss_fn, ddp)
        grads = torch.autograd.grad(loss, list(params.values()))
        del loss
    if dp is not None:
        scale = 1.0 / mesh.world if ddp else None
        if layout is not None and layout.sharded:
            grads = list(layout.reduce_grads(dict(zip(params, grads)), comm_dtype, scale, allreduce_grads).values())
        else:
            grads = allreduce_grads(mesh, list(grads), comm_dtype, scale)
    grads = dict(zip(params, grads))
    updates, opt_state = opt.update(grads, state.opt_state, params)
    apply_updates(params, updates)
    metrics = {"loss": reported, "grad_norm": opt.grad_norm(grads)}
    if opt.skip_nonfinite > 0:
        metrics["notfinite_total"] = opt_state.total_notfinite
    return TrainState(model, opt_state, state.step + 1), metrics


def make_train_step(config: ModelConfig, opt: Optimizer, device=None, mesh=None, comm_dtype=None,
                    ddp_loss_weighting: bool = False):
    """-> `step(state, batch, site_keys) -> (state, metrics)` for `batch`
    {"wavs": (B, samples) f32, "tokens", "token_lengths"}; metrics hold the
    loss, the global norm of the gradients before clipping, and with the
    non-finite guard on, the count of skipped steps. Runs on `device`
    (None: cuda, or the rank's mesh device). With a process-group `mesh`,
    `batch` and `site_keys` are this rank's; see the module docstring for
    `comm_dtype` and `ddp_loss_weighting`."""
    mesh, device = _data_parallel(mesh, device)
    dp = None if mesh is None else (mesh, normalize_comm_dtype(comm_dtype), bool(ddp_loss_weighting))

    def step(state: TrainState, batch: dict, site_keys) -> tuple[TrainState, dict]:
        _check(state.model, config, device, mesh)
        return _update(state, opt, batch["wavs"].to(device), *_tokens_on(batch, device), site_keys, dp)

    return step


def make_synth_train_step(config: ModelConfig, synth_config: SynthConfig, statics: SynthStatics, opt: Optimizer,
                          device=None, mesh=None, comm_dtype=None, ddp_loss_weighting: bool = False):
    """-> `step(state, batch, draws, site_keys) -> (state, metrics)`: the
    training step with the batch's audio synthesised on the device from its
    note lists (`synth/render.py:render_batch`, no gradient), then as
    `make_train_step`. `batch`: {"notes": (B, MAX_NOTES, 4), "note_mask":
    (B, MAX_NOTES), "tokens": (B, T), "token_lengths": (B,)}; `draws` the
    batch's `RenderDraws` (a rank's own under a mesh). The bank's loaded
    bins are checked here too."""
    mesh, device = _data_parallel(mesh, device)
    dp = None if mesh is None else (mesh, normalize_comm_dtype(comm_dtype), bool(ddp_loss_weighting))
    _synth_statics_on(statics, synth_config, device)

    def step(state: TrainState, batch: dict, draws: RenderDraws, site_keys) -> tuple[TrainState, dict]:
        _check(state.model, config, device, mesh)
        with torch.no_grad():
            wavs = render_batch(statics, batch["notes"], batch["note_mask"], draws, synth_config)
        return _update(state, opt, wavs, *_tokens_on(batch, device), site_keys, dp)

    return step


def _synth_statics_on(statics: SynthStatics, synth_config: SynthConfig, device: torch.device) -> None:
    check_bins_loaded(statics, synth_config.similarity_threshold)
    if statics.waveforms.device.type != device.type:
        raise ValueError(f"the bank lies on {statics.waveforms.device}, the step runs on {device}")


def _eval_loss(model: ADTModel, mesh: Optional[DataMesh], wavs, tokens, lengths) -> torch.Tensor:
    """The teacher-forced loss without dropout; under a mesh the global
    token-weighted mean over the ranks' rows."""
    if mesh is None:
        with fsdp_lib.gathered(model):
            return model.forward_loss(wavs, tokens, lengths, train=False)
    with fsdp_lib.gathered(model):
        s, n = model.forward_loss(wavs, tokens, lengths, train=False, reduction="sum")
    total = mesh.all_reduce(torch.stack([s, n.to(s.dtype)]))
    return total[0] / torch.clamp(total[1], min=1.0)


def make_eval_step(config: ModelConfig, device=None, mesh=None):
    """-> `step(model, batch) -> loss`: the teacher-forced loss without
    dropout or gradients (the global loss under a mesh)."""
    mesh, device = _data_parallel(mesh, device)

    def step(model: ADTModel, batch: dict) -> torch.Tensor:
        _check(model, config, device, mesh)
        with torch.no_grad():
            return _eval_loss(model, mesh, batch["wavs"].to(device), *_tokens_on(batch, device))

    return step


def make_synth_eval_step(config: ModelConfig, synth_config: SynthConfig, statics: SynthStatics, device=None,
                         mesh=None):
    """-> `step(model, batch, draws) -> loss`: the teacher-forced loss of a
    note-list batch (as `make_synth_train_step` takes it) whose audio is
    rendered under the caller's fixed `draws`, so an eval stream gives the
    same audio at every call; no dropout, no gradients (the global loss
    under a mesh)."""
    mesh, device = _data_parallel(mesh, device)
    _synth_statics_on(statics, synth_config, device)

    def step(model: ADTModel, batch: dict, draws: RenderDraws) -> torch.Tensor:
        _check(model, config, device, mesh)
        with torch.no_grad():
            wavs = render_batch(statics, batch["notes"], batch["note_mask"], draws, synth_config)
            return _eval_loss(model, mesh, wavs, *_tokens_on(batch, device))

    return step
