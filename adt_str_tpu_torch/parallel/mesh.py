"""Data-parallel layout over torch devices and processes.

Port of `adt_str_tpu/parallel/mesh.py:33-95, 205-237` (`maybe_initialize_distributed`,
`make_mesh`, the batch's row placement), data axis only:

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
  rank and the world, and the local devices this process decodes on. A
  multi-process mesh holds one device a rank; a single-process mesh may
  hold several, and may repeat one (`["cpu", "cpu"]`, `["cuda:0",
  "cuda:0"]`), as JAX's virtual CPU devices do, to exercise the row split
  on one device. `local_rows` is a rank's contiguous stripe of a global
  batch (JAX's `shard_batch` places each process's rows the same way); a
  trainer rank loads its own stride instead (`data/datasets.py`).
- Collectives on a gloo group stage CUDA tensors through host memory:
  gloo reduces and gathers on the CPU.

The tensor-parallel `model` axis and FSDP are not ported
(`TENSOR_PARALLEL_ITEM`, `FSDP_ITEM`): asking for either raises.
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

logger = logging.getLogger(__name__)

TORCHRUN_VARS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK")
TENSOR_PARALLEL_ITEM = ("the tensor-parallel model axis (Megatron layout, vocab-sharded generator) is ROADMAP.md "
                        "queue 1 item 11")
FSDP_ITEM = "FSDP (parameters sharded over the data axis) is ROADMAP.md queue 1 item 12"


def check_layout(n_model: int = 1, fsdp: bool = False) -> None:
    """Raise for the layouts the port does not have: a model axis or FSDP."""
    if n_model > 1:
        raise NotImplementedError(f"model axis {n_model}: {TENSOR_PARALLEL_ITEM}")
    if fsdp:
        raise NotImplementedError(FSDP_ITEM)


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
    """The data axis: `group` the process group (None: one process),
    `rank` and `world` this process's place in it, `devices` the local
    devices it holds (one a rank when `group` is set). Entries are ordered
    by rank, then by local device; `n_data` counts them."""

    devices: tuple[torch.device, ...]
    group: Any = None
    rank: int = 0
    world: int = 1
    _replicas: Any = dataclasses.field(default_factory=weakref.WeakKeyDictionary, repr=False)

    @property
    def n_data(self) -> int:
        return self.world * len(self.devices)

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
        """The reduction of `t` over the ranks, on `t`'s device and dtype:
        in place where the backend takes `t` (NCCL; gloo and a host
        tensor), else through a host copy."""
        if self.group is None:
            return t
        buf = self._staged(t).contiguous()
        dist.all_reduce(buf, op=op, group=self.group)
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

    def barrier(self) -> None:
        """Every rank waits for the others (a one-element all-reduce on the
        backend's own device, so NCCL needs no guess of the card)."""
        if self.group is not None:
            self.all_reduce(torch.zeros(1, device=self.device))

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
    """The data axis over `devices`. In a process group: this rank's one
    device (None: the current card, which `maybe_initialize_distributed`
    set), `n_data` -1 or the world size. In one process: `devices` (None:
    every visible card), the first `n_data` of them (-1: all)."""
    check_layout(n_model, fsdp)
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        if n_data not in (-1, world):
            raise ValueError(f"n_data={n_data} but the process group has {world} ranks: one rank a data entry")
        if devices is None:
            devices = [torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available()
                       else resolve_device(None)]
        if len(devices) != 1:
            raise ValueError(f"a rank of a process group holds one device, got {devices}")
        return DataMesh(devices=(torch.device(devices[0]),), group=dist.group.WORLD, rank=rank, world=world)
    if devices is None:
        resolve_device(None)  # raises without CUDA
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_data == -1:
        n_data = len(devices)
    if not 1 <= n_data <= len(devices):
        raise ValueError(f"mesh of {n_data} data entries needs {n_data} devices, have {len(devices)}")
    return DataMesh(devices=tuple(devices[:n_data]))


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
    """Copy rank 0's weights to every rank, once at start. The ranks built
    or restored the same weights, so each rank's checksum must equal rank
    0's first: a difference raises (the ranks were not seeded alike)."""
    if mesh is None or mesh.group is None:
        return
    mine = _weights_checksum(model)
    ref = mine.clone()
    buf = mesh._staged(ref.reshape(1))
    dist.broadcast(buf, src=0, group=mesh.group)
    if int(buf.item()) != int(mine.item()):
        raise RuntimeError(f"rank {mesh.rank}'s weights differ from rank 0's (checksum {int(mine.item())} vs "
                           f"{int(buf.item())}): the ranks were not seeded or restored alike")
    with torch.no_grad():
        tensors = list(model.state_dict().values())
        for t in tensors:
            staged = mesh._staged(t.detach())
            dist.broadcast(staged, src=0, group=mesh.group)
            if staged is not t:
                t.copy_(staged)
