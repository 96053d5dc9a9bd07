"""Data- and tensor-parallel layout over torch devices and processes.

Port of `adt_str_tpu/parallel/mesh.py:33-95, 205-237` (`maybe_initialize_distributed`,
`make_mesh`, the batch's row placement):

- `maybe_initialize_distributed(device)` reads `torchrun`'s environment
  (`MASTER_ADDR`, `MASTER_PORT`, `RANK`, `WORLD_SIZE`, `LOCAL_RANK`) and
  joins the process group. Without that environment nothing happens; a
  partial one raises (never a silent single-process job: every rank would
  train the same job alone and overwrite the others' checkpoints), and so
  does a failed init. The backend and the rank's device follow the
  topology, never a fallback (`placement`): each local rank on a card of
  its own (`cuda:{LOCAL_RANK}`) with NCCL; every rank on the one device
  the caller names (`cuda:0`) with gloo, since NCCL cannot hold two ranks
  on one card; the CPU with gloo.
- `DataMesh` is the data axis: the process group (or none), this process's
  index on the axis and the axis size, and the local devices this process
  decodes on. In a process group of `n_data x n_model` ranks it is the 2-D
  mesh of JAX's grid (`devices.reshape(n_data, n_model)`): the ranks of
  one model group are consecutive, rank = data index * n_model + model
  index; `group` is then this rank's data group (the ranks of its model
  index), `model` its `parallel/tensor_parallel.py:ModelAxis` (None at
  n_model 1), `global_rank` its rank in the job. A
  multi-process mesh holds one device a rank; a single-process mesh may
  hold several, and may repeat one (`["cpu", "cpu"]`, `["cuda:0",
  "cuda:0"]`), as JAX's virtual CPU devices do, to exercise the row split
  on one device. `local_rows` is a rank's contiguous stripe of a global
  batch (JAX's `shard_batch` places each process's rows the same way); a
  trainer rank loads its own stride instead (`data/datasets.py`).
- Collectives on a gloo group stage CUDA tensors through host memory:
  gloo reduces and gathers on the CPU.
- FSDP (`make_mesh(..., fsdp=True)`, `mesh.fsdp: true`): the mesh records
  the flag; `all_gather_flat` and `reduce_scatter_flat` move the flat
  buffers of `parallel/fsdp.py` over the data group.
"""

from __future__ import annotations

import copy
import dataclasses
import logging
import os
import weakref
from typing import Any, Optional

import torch
import torch.distributed as dist

from adt_str_tpu_torch import resolve_device
from adt_str_tpu_torch.parallel.tensor_parallel import ModelAxis

logger = logging.getLogger(__name__)

TORCHRUN_VARS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK")


def check_layout(n_model: int = 1) -> None:
    """Raise for a model axis below 1."""
    if n_model < 1:
        raise ValueError(f"model axis {n_model}: the axis holds one rank or more")


def torchrun_env() -> Optional[dict]:
    """torchrun's rank variables as ints and strings, or None when none is
    set. A partial set raises."""
    present = [v for v in TORCHRUN_VARS if v in os.environ]
    if not present:
        return None
    missing = [v for v in TORCHRUN_VARS if v not in os.environ]
    if missing:
        raise RuntimeError(f"partial torchrun environment: {present} set but {missing} missing; a multi-process "
                           "job never degrades to a single-process one (launch with torchrun or unset them)")
    env = {v: os.environ[v] for v in TORCHRUN_VARS}
    env["LOCAL_WORLD_SIZE"] = os.environ.get("LOCAL_WORLD_SIZE", env["WORLD_SIZE"])
    return env


def placement(device, local_rank: int, local_world: int) -> tuple[torch.device, str, str]:
    """-> (this rank's device, backend, why) by topology. `device` None or
    an unindexed "cuda": one card per local rank with NCCL, raising when
    the host has fewer cards than local ranks; a named card: every rank on
    it with gloo; the CPU: gloo."""
    dev = None if device is None else torch.device(device)
    if dev is None or (dev.type == "cuda" and dev.index is None):
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to run the ranks on the CPU")
        cards = torch.cuda.device_count()
        if cards < local_world:
            raise RuntimeError(f"{local_world} local ranks but {cards} cards: name one device (--device cuda:0) "
                               "to put every rank on it over gloo")
        why = f"one card a rank ({cards} cards, {local_world} local ranks)"
        return torch.device("cuda", local_rank), "nccl", why
    if dev.type == "cuda":
        return dev, "gloo", f"every rank on the named {dev} (NCCL cannot hold two ranks on one card)"
    return dev, "gloo", f"the {dev.type} device"


def maybe_initialize_distributed(device=None) -> Optional[torch.device]:
    """Join the process group that torchrun's environment describes ->
    this rank's device (`placement`), or None when there is no such
    environment or the group already exists (the caller made it). The
    caller that got a device destroys the group (`destroy`)."""
    if dist.is_initialized():
        return None
    env = torchrun_env()
    if env is None:
        return None
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    local_rank, local_world = int(env["LOCAL_RANK"]), int(env["LOCAL_WORLD_SIZE"])
    dev, backend, why = placement(device, local_rank, local_world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    try:
        dist.init_process_group(backend, init_method=f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
                                rank=rank, world_size=world)
    except Exception as e:  # a cluster that fails to form must not become `world` single-process jobs
        raise RuntimeError(f"init_process_group({backend!r}) failed for rank {rank} of {world} at "
                           f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}: {e}") from e
    logger.info("distributed: rank %d of %d (local %d of %d), backend %s on %s: %s", rank, world, local_rank,
                local_world, backend, dev, why)
    return dev


def destroy() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


@dataclasses.dataclass(frozen=True, eq=False)
class DataMesh:
    """The data axis: `group` the process group of the axis (None: one
    process), `rank` and `world` this process's place on it, `devices` the
    local devices it holds (one a rank when `group` is set). Entries are
    ordered by rank, then by local device; `n_data` counts them. `model`:
    the tensor-parallel axis (None: none), `global_rank` the rank in the job.
    `fsdp`: the parameters are sharded over the data axis (`parallel/fsdp.py`)."""

    devices: tuple[torch.device, ...]
    group: Any = None
    rank: int = 0
    world: int = 1
    model: Optional[ModelAxis] = None
    global_rank: int = 0
    fsdp: bool = False
    _replicas: Any = dataclasses.field(default_factory=weakref.WeakKeyDictionary, repr=False)

    @property
    def n_data(self) -> int:
        return self.world * len(self.devices)

    @property
    def n_model(self) -> int:
        return 1 if self.model is None else self.model.size

    @property
    def device(self) -> torch.device:
        """The first local device: where a caller's results gather."""
        return self.devices[0]

    @property
    def backend(self) -> Optional[str]:
        return None if self.group is None else dist.get_backend(self.group)

    def _staged(self, t: torch.Tensor) -> torch.Tensor:
        """`t` where the backend reduces it: gloo takes host tensors."""
        return t.cpu() if self.backend == "gloo" else t

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """The reduction of `t` over the data axis, on `t`'s device and
        dtype: in place where the backend takes `t` (NCCL; gloo and a host
        tensor), else through a host copy."""
        if self.group is None or self.world == 1:
            return t
        buf = self._staged(t).contiguous()
        dist.all_reduce(buf, op=op, group=self.group)
        return buf.to(t.device)

    def all_reduce_job(self, t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """As `all_reduce`, over every rank of the job (both axes)."""
        if self.group is None:
            return t
        buf = self._staged(t).contiguous()
        dist.all_reduce(buf, op=op, group=dist.group.WORLD)
        return buf.to(t.device)

    def all_gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's `t` (equal shapes) concatenated along dim 0 in rank
        order, on `t`'s device."""
        if self.group is None:
            return t
        buf = self._staged(t).contiguous()
        parts = [torch.empty_like(buf) for _ in range(self.world)]
        dist.all_gather(parts, buf, group=self.group)
        return torch.cat(parts).to(t.device)

    def all_gather_flat(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's flat `t` (equal sizes) as the rows of a (world,
        size) tensor in rank order, on `t`'s device: one all-gather."""
        if self.group is None or self.world == 1:
            return t.reshape(1, -1)
        buf = self._staged(t).contiguous().reshape(-1)
        out = torch.empty(self.world * buf.numel(), dtype=buf.dtype, device=buf.device)
        dist.all_gather_into_tensor(out, buf, group=self.group)
        return out.view(self.world, -1).to(t.device)

    def reduce_scatter_flat(self, t: torch.Tensor) -> torch.Tensor:
        """Row `rank` of the sum over the ranks of their (world, size) `t`,
        on `t`'s device: one reduce-scatter."""
        if self.group is None or self.world == 1:
            return t[0]
        buf = self._staged(t).contiguous()
        out = torch.empty(buf.shape[1:], dtype=buf.dtype, device=buf.device)
        dist.reduce_scatter_tensor(out, buf.reshape(-1), op=dist.ReduceOp.SUM, group=self.group)
        return out.to(t.device)

    def barrier(self) -> None:
        """Every rank of the job waits for the others (a one-element
        all-reduce on the backend's own device, so NCCL needs no guess of
        the card)."""
        self.all_reduce_job(torch.zeros(1, device=self.device))

    def local_rows(self, n_rows: int) -> slice:
        """This rank's contiguous stripe of a global batch of `n_rows`."""
        if n_rows % self.n_data:
            raise ValueError(f"batch of {n_rows} rows not divisible by the mesh data axis ({self.n_data})")
        per_rank = n_rows // self.world
        return slice(self.rank * per_rank, (self.rank + 1) * per_rank)

    def replica(self, model: torch.nn.Module, device: torch.device) -> torch.nn.Module:
        """`model` on `device`: the model itself where it lies, else a copy,
        kept until one of the model's tensors is written in place (an
        optimizer step or `load_state_dict` bumps its version)."""
        device = torch.device(device)
        first = next(model.parameters())
        if first.device == device:
            return model
        versions = tuple(t._version for t in model.state_dict().values())
        per_model = self._replicas.setdefault(model, {})
        cached = per_model.get(device)
        if cached is None or cached[0] != versions:
            with torch.no_grad():
                per_model[device] = cached = (versions, copy.deepcopy(model).to(device).eval())
        return cached[1]


def make_mesh(n_data: int = -1, n_model: int = 1, devices: Optional[list] = None, fsdp: bool = False) -> DataMesh:
    """The mesh over `devices`. In a process group: this rank's one device
    (None: the current card, which `maybe_initialize_distributed` set) on
    the `n_data x n_model` grid of the ranks (`n_data` -1: the world over
    `n_model`; a grid that is not the world raises); every rank calls it,
    since it makes the axes' groups. In one process, the data axis alone:
    `devices` (None: every visible card), the first `n_data` of them (-1:
    all); a model axis there raises (it runs one process a rank). `fsdp`
    marks the mesh for parameters sharded over its data axis."""
    check_layout(n_model)
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        if n_data == -1:
            n_data = max(1, world // n_model)
        if n_data * n_model != world:
            raise ValueError(f"mesh {n_data} x {n_model} needs {n_data * n_model} ranks, the process group has "
                             f"{world}: one rank a mesh entry")
        if devices is None:
            devices = [torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available()
                       else resolve_device(None)]
        if len(devices) != 1:
            raise ValueError(f"a rank of a process group holds one device, got {devices}")
        device = torch.device(devices[0])
        if n_model == 1:
            return DataMesh(devices=(device,), group=dist.group.WORLD, rank=rank, world=world, global_rank=rank,
                            fsdp=fsdp)
        data_index, model_index = divmod(rank, n_model)
        # every rank makes every group, in one order (new_group's contract)
        model_groups = [dist.new_group(list(range(i * n_model, (i + 1) * n_model))) for i in range(n_data)]
        data_groups = [dist.new_group(list(range(j, world, n_model))) for j in range(n_model)]
        return DataMesh(devices=(device,), group=data_groups[model_index], rank=data_index, world=n_data,
                        model=ModelAxis(model_groups[data_index], model_index, n_model), global_rank=rank, fsdp=fsdp)
    if n_model > 1:
        raise ValueError(f"a model axis of {n_model} runs one process a rank: build the mesh inside a process "
                         "group (torchrun)")
    if devices is None:
        resolve_device(None)  # raises without CUDA
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_data == -1:
        n_data = len(devices)
    if not 1 <= n_data <= len(devices):
        raise ValueError(f"mesh of {n_data} data entries needs {n_data} devices, have {len(devices)}")
    return DataMesh(devices=tuple(devices[:n_data]), fsdp=fsdp)


def _weights_checksum(model: torch.nn.Module) -> torch.Tensor:
    """An int64 sum of every weight's bit pattern (as 32-bit words)."""
    total = torch.zeros((), dtype=torch.int64, device=next(model.parameters()).device)
    for t in model.state_dict().values():
        words = t.detach().contiguous().reshape(-1)
        if words.element_size() == 4:
            words = words.view(torch.int32)
        elif words.element_size() == 2:
            words = words.view(torch.int16)
        total += words.to(torch.int64).sum()
    return total


def broadcast_model(mesh: Optional[DataMesh], model: torch.nn.Module) -> None:
    """Copy the data axis's first rank's weights (its shard, under a model
    axis) to every rank of the axis, once at start, before FSDP cuts them. The ranks built or
    restored the same weights, so each rank's checksum must equal the
    first's: a difference raises (the ranks were not seeded alike)."""
    if mesh is None or mesh.group is None or mesh.world == 1:
        return
    src = mesh.global_rank % mesh.n_model  # the data group's first rank: data index 0, this model index
    mine = _weights_checksum(model)
    ref = mine.clone()
    buf = mesh._staged(ref.reshape(1))
    dist.broadcast(buf, src=src, group=mesh.group)
    if int(buf.item()) != int(mine.item()):
        raise RuntimeError(f"rank {mesh.rank}'s weights differ from rank 0's (checksum {int(mine.item())} vs "
                           f"{int(buf.item())}): the ranks were not seeded or restored alike")
    with torch.no_grad():
        tensors = list(model.state_dict().values())
        for t in tensors:
            staged = mesh._staged(t.detach())
            dist.broadcast(staged, src=src, group=mesh.group)
            if staged is not t:
                t.copy_(staged)
