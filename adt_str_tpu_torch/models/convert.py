"""Weight bridge: JAX params and reference checkpoints -> port state dicts.

`state_dict_from_jax_params` is the port's side of
`adt_str_tpu/models/torch_compat.py:params_to_torch_state_dict`: it takes the
JAX params pytree as numpy arrays and emits the reference PyTorch naming,
transposing each `w` (JAX stores (d_in, d_out), PyTorch (d_out, d_in)).

`load_reference_checkpoint` mirrors
`adt_str_tpu/training/checkpoint.py:load_params_from_reference_checkpoint`:
`model.safetensors` (or `model.safetensor`) first, else `pytorch_model.bin`.
safetensors is read by the small reader below (an 8-byte little-endian
header length, a JSON header, raw little-endian buffers): the machine with
the card has no safetensors package.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

from adt_str_tpu_torch import resolve_device

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
