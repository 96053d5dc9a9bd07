"""Checkpoints of a training run: save, restore, auto-resume, GC.

Port of `adt_str_tpu/training/checkpoint.py`. A checkpoint is a directory
`checkpoint-epoch-E-step-S/` (the reference's HF-Trainer pattern) holding

- `state.pt`: `torch.save` of plain dicts of tensors and ints (the model's
  state dict, the optimizer state's fields, step and epoch), read back with
  `torch.load(weights_only=True)`; the `OptState` dataclass itself stays out
  of the pickle, which `weights_only` would refuse;
- `meta.json`: {"step", "epoch"};
- `model.safetensors`: the model in the reference state-dict naming, written
  by the port's own writer (`models/convert.py:write_safetensors`), which
  the JAX package and the reference load.

Each file is written under a temporary name and renamed into place, and a
second save of a step overwrites it. In a data-parallel run (`mesh` a
process-group `DataMesh`) every rank calls the save: rank 0 alone writes
and collects garbage, and a barrier follows, so no rank reads a
half-written checkpoint; every rank restores the same files onto its own
device. A tensor-parallel model (`model.tp`) saves the whole model: the
model group of data index 0 gathers its shards of the weights and of
Adam's moments (`parallel/tensor_parallel.py:gather_state_dict`), so the
files are those of a one-process run and eval, serving and a one-process
resume read them; a tensor-parallel restore cuts its shard out of them
again. `gc_checkpoints` keeps the newest
`max_checkpoints` by mtime; `latest_checkpoint` is the newest (auto-resume).
A checkpoint whose `meta.json` was lost (a preemption between the two
writes) restores with step and epoch read from its directory name. The JAX
package's orbax `state/` is not read; its `model.safetensors` loads into
the port through `models/convert.py:load_reference_checkpoint`.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from pathlib import Path
from typing import Optional

import torch

from adt_str_tpu_torch.models.convert import write_safetensors
from adt_str_tpu_torch.parallel import tensor_parallel as tp_lib
from adt_str_tpu_torch.parallel.mesh import DataMesh
from adt_str_tpu_torch.training.optimizer import OptState

_CKPT_RE = re.compile(r"checkpoint-epoch-(\d+)-step-(\d+)$")


def checkpoint_name(epoch: int, step: int) -> str:
    return f"checkpoint-epoch-{epoch}-step-{step}"


def _replace_into(path: Path, write) -> None:
    """`write(tmp_path)`, then rename the result onto `path`."""
    tmp = path.with_name(path.name + ".tmp")
    write(tmp)
    os.replace(tmp, path)


def save_checkpoint(output_dir: str | Path, model: torch.nn.Module, opt_state: OptState, step: int, epoch: int = 0,
                    max_checkpoints: Optional[int] = None, mesh: Optional[DataMesh] = None) -> str:
    """Write `output_dir/checkpoint-epoch-{epoch}-step-{step}` (overwriting
    it if it exists), then GC to the newest `max_checkpoints`. -> its path.
    Under a process-group `mesh`: rank 0 writes (a tensor-parallel model's
    shards gathered first), then every rank waits."""
    output_dir = Path(output_dir)
    path = output_dir / checkpoint_name(epoch, step)
    axis = getattr(model, "tp", None)
    if axis is not None and mesh is None:
        raise ValueError("a tensor-parallel model saves with its mesh: every rank calls the save")
    weights, opt = model.state_dict(), dict(vars(opt_state))
    if axis is not None and mesh.rank == 0:  # the model group of data index 0 gathers
        weights = tp_lib.gather_state_dict(weights, axis)
        opt.update({k: tp_lib.gather_state_dict(opt[k], axis) for k in ("mu", "nu", "acc")})
    if mesh is None or mesh.global_rank == 0:
        path.mkdir(parents=True, exist_ok=True)
        state = {"model": weights, "opt_state": opt, "step": int(step), "epoch": int(epoch)}
        _replace_into(path / "state.pt", lambda p: torch.save(state, p))
        _replace_into(path / "meta.json",
                      lambda p: p.write_text(json.dumps({"step": int(step), "epoch": int(epoch)})))
        _replace_into(path / "model.safetensors", lambda p: write_safetensors(weights, p))
        if max_checkpoints:
            gc_checkpoints(output_dir, max_checkpoints)
    if mesh is not None:
        mesh.barrier()
    return str(path)


def _checkpoints(output_dir: str | Path) -> list[Path]:
    return [p for p in Path(output_dir).glob("checkpoint-epoch-*-step-*") if _CKPT_RE.search(p.name)]


def gc_checkpoints(output_dir: str | Path, keep: int) -> None:
    """Delete all but the newest `keep` checkpoints (by mtime)."""
    ckpts = sorted(_checkpoints(output_dir), key=lambda p: p.stat().st_mtime)
    for p in ckpts[:-keep] if keep > 0 else []:
        shutil.rmtree(p, ignore_errors=True)


def latest_checkpoint(output_dir: str | Path) -> Optional[str]:
    """The newest checkpoint directory by mtime, or None."""
    ckpts = _checkpoints(output_dir)
    return str(max(ckpts, key=lambda p: p.stat().st_mtime)) if ckpts else None


def restore_checkpoint(path: str | Path, model: torch.nn.Module, device=None) -> tuple[OptState, int, int]:
    """Load the checkpoint's weights into `model` (strict; a tensor-parallel
    model takes its shard) -> (its optimizer state on `device`, step,
    epoch). `device` None: the model's device."""
    path = Path(path)
    device = next(model.parameters()).device if device is None else torch.device(device)
    state = torch.load(path / "state.pt", map_location=device, weights_only=True)
    weights, opt = state["model"], state["opt_state"]
    if getattr(model, "tp", None) is not None:
        rank, size = model.tp.rank, model.tp.size
        weights = tp_lib.shard_state_dict(weights, rank, size)
        opt.update({k: tp_lib.shard_state_dict(opt[k], rank, size) for k in ("mu", "nu", "acc")})
    model.load_state_dict(weights, strict=True)
    opt_state = OptState(**opt)
    meta_path = path / "meta.json"
    if meta_path.exists():
        meta = json.loads(meta_path.read_text())
        return opt_state, int(meta["step"]), int(meta["epoch"])
    m = _CKPT_RE.search(path.name)
    if m is None:
        raise FileNotFoundError(f"{meta_path} missing and {path.name!r} does not follow the "
                                "checkpoint-epoch-E-step-S naming")
    return opt_state, int(m.group(2)), int(m.group(1))
