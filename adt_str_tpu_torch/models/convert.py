"""Weight bridge: JAX params and reference checkpoints -> port state dicts.

`state_dict_from_jax_params` is the port's side of
`adt_str_tpu/models/torch_compat.py:params_to_torch_state_dict`: it takes the
JAX params pytree as numpy arrays and emits the reference PyTorch naming,
transposing each `w` (JAX stores (d_in, d_out), PyTorch (d_out, d_in)).

`shard_state_dict_from_jax_params` takes the JAX params straight to one
rank's tensor-parallel shard (`parallel/tensor_parallel.py:shard_state_dict`),
which `ADTModel(config, tp=axis)` loads with `strict=True`;
`fsdp_shard_state_dict_from_jax_params` goes on to the rank's FSDP shard
(`parallel/fsdp.py`), which a model cut by `fsdp.shard_model_` loads.

`load_reference_checkpoint` mirrors
`adt_str_tpu/training/checkpoint.py:load_params_from_reference_checkpoint`:
`model.safetensors` (or `model.safetensor`) first, else `pytorch_model.bin`.
safetensors is read and written by the small reader and writer below (an
8-byte little-endian header length, a JSON header padded with spaces to a
multiple of 8 bytes, raw little-endian buffers in header order): the machine
with the card has no safetensors package.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

from adt_str_tpu_torch import resolve_device
from adt_str_tpu_torch.parallel import fsdp as fsdp_lib
from adt_str_tpu_torch.parallel.tensor_parallel import shard_state_dict

_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}


def state_dict_from_jax_params(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX params pytree (numpy leaves) -> reference-named CPU state dict."""
    sd: dict[str, torch.Tensor] = {}

    def t(x) -> torch.Tensor:
        return torch.from_numpy(np.array(x, order="C"))  # a writable copy

    def put_lin(prefix, p):
        sd[f"{prefix}.weight"] = t(np.asarray(p["w"]).T)
        if "b" in p:
            sd[f"{prefix}.bias"] = t(p["b"])

    def put_ln(prefix, p):
        sd[f"{prefix}.weight"] = t(p["scale"])
        sd[f"{prefix}.bias"] = t(p["bias"])

    def put_attn(prefix, p):
        sd[f"{prefix}.in_proj_weight"] = t(np.asarray(p["in_proj"]["w"]).T)
        sd[f"{prefix}.in_proj_bias"] = t(p["in_proj"]["b"])
        put_lin(f"{prefix}.out_proj", p["out_proj"])

    put_lin("project_to_mel", params["project_to_mel"])
    put_lin("encoder.dense_layer", params["encoder"]["dense"])
    put_ln("encoder.layer_norm", params["encoder"]["final_ln"])
    for i, layer in enumerate(params["encoder"]["layers"]):
        prefix = f"encoder.encoder.layers.{i}"
        put_attn(f"{prefix}.self_attn", layer["self_attn"])
        put_lin(f"{prefix}.linear1", layer["ffn"]["linear1"])
        put_lin(f"{prefix}.linear2", layer["ffn"]["linear2"])
        put_ln(f"{prefix}.norm1", layer["norm1"])
        put_ln(f"{prefix}.norm2", layer["norm2"])
    sd["decoder.tgt_tok_emb.embedding.weight"] = t(params["decoder"]["embedding"])
    put_lin("decoder.generator", params["decoder"]["generator"])
    for i, layer in enumerate(params["decoder"]["layers"]):
        prefix = f"decoder.decoder.layers.{i}"
        put_attn(f"{prefix}.self_attn", layer["self_attn"])
        put_attn(f"{prefix}.multihead_attn", layer["cross_attn"])
        put_lin(f"{prefix}.linear1", layer["ffn"]["linear1"])
        put_lin(f"{prefix}.linear2", layer["ffn"]["linear2"])
        put_ln(f"{prefix}.norm1", layer["norm1"])
        put_ln(f"{prefix}.norm2", layer["norm2"])
        put_ln(f"{prefix}.norm3", layer["norm3"])
    return sd


def shard_state_dict_from_jax_params(params: Mapping[str, Any], rank: int, size: int) -> dict[str, torch.Tensor]:
    """JAX params pytree (numpy leaves) -> rank `rank`'s shard of the
    reference-named state dict on a model axis of `size`."""
    return shard_state_dict(state_dict_from_jax_params(params), rank, size)


def fsdp_shard_state_dict_from_jax_params(params: Mapping[str, Any], data_rank: int, n_data: int,
                                          model_rank: int = 0, n_model: int = 1) -> dict[str, torch.Tensor]:
    """JAX params pytree (numpy leaves) -> the FSDP shard of the rank at
    (`data_rank`, `model_rank`) on an `n_data x n_model` mesh: its
    tensor-parallel shard, then its part of each data-sharded leaf."""
    sd = shard_state_dict_from_jax_params(params, model_rank, n_model)
    dims = fsdp_lib.data_dims({k: tuple(v.shape) for k, v in sd.items()}, n_data, n_model)
    return fsdp_lib.shard_state_dict(sd, dims, data_rank, n_data)


def read_safetensors(path: str | Path) -> dict[str, torch.Tensor]:
    """safetensors file -> {name: CPU tensor}."""
    raw = Path(path).read_bytes()
    if len(raw) < 8:
        raise ValueError(f"{path}: too short for a safetensors file")
    (n,) = struct.unpack("<Q", raw[:8])
    if 8 + n > len(raw):
        raise ValueError(f"{path}: header length {n} runs past the end of the file")
    header = json.loads(raw[8 : 8 + n])
    data = memoryview(raw)[8 + n :]
    out: dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _ST_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has unsupported dtype {info['dtype']}")
        begin, end = info["data_offsets"]
        if not 0 <= begin <= end <= len(data):
            raise ValueError(f"{path}: tensor {name!r} data offsets {begin}..{end} out of range")
        buf = bytearray(data[begin:end])  # a writable copy that the tensor owns
        flat = torch.frombuffer(buf, dtype=dtype) if buf else torch.empty(0, dtype=dtype)
        out[name] = flat.reshape(info["shape"])
    return out


def write_safetensors(tensors: Mapping[str, torch.Tensor], path: str | Path) -> None:
    """{name: tensor} -> a safetensors file, tensors in name order, each
    copied to the host as its little-endian bytes (bf16 through an int16
    view, which numpy lacks)."""
    names = {dtype: name for name, dtype in _ST_DTYPES.items()}
    header: dict = {}
    buffers = []
    offset = 0
    for name in sorted(tensors):
        t = tensors[name].detach().contiguous().cpu()
        if t.dtype not in names:
            raise ValueError(f"tensor {name!r} has a dtype safetensors does not take: {t.dtype}")
        raw = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape), "data_offsets": [offset, offset + len(raw)]}
        buffers.append(raw)
        offset += len(raw)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in buffers:
            f.write(raw)


def load_reference_checkpoint(checkpoint_path: str | Path, device=None) -> dict[str, torch.Tensor]:
    """Reference-format checkpoint directory -> state dict on `device`
    (None: cuda)."""
    device = resolve_device(device)
    checkpoint_path = Path(checkpoint_path)
    candidates = [checkpoint_path / "model.safetensors", checkpoint_path / "model.safetensor"]
    st_path = next((p for p in candidates if p.exists()), None)
    bin_path = checkpoint_path / "pytorch_model.bin"
    if st_path is not None:
        sd = read_safetensors(st_path)
    elif bin_path.exists():
        sd = torch.load(str(bin_path), map_location="cpu", weights_only=True)
        for key in ("model_state_dict", "state_dict"):
            if key in sd:
                sd = sd[key]
                break
    else:
        tried = ", ".join(str(p) for p in [*candidates, bin_path])
        raise FileNotFoundError(f"No checkpoint found at {checkpoint_path}. Looked for: {tried}")
    return {k: v.to(device) for k, v in sd.items()}
