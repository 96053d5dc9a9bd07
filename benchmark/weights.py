"""The model's weights, made by the benchmark on the device from the seed:
one fp32 normal draw over every parameter (the type the port keeps its
parameters in), cut into leaves and scaled as a trained model's scales
run (1 / sqrt(fan-in) for products and embedding rows, whose lookup the
model scales by sqrt(d), small biases, LayerNorm at one and zero). The same tensors seed the port's model and the
reference, so neither takes weights the other made."""

from __future__ import annotations

import math

import torch


def param_shapes(dims: dict) -> dict[str, tuple]:
    """{name: shape} of the ADT_STR state dict at `dims`."""
    d, ff, V, M = dims["d_model"], 4 * dims["d_model"], dims["vocab"], dims["n_mels"]
    out = {"project_to_mel.weight": (d, M), "project_to_mel.bias": (d,), "encoder.dense_layer.weight": (d, d)}

    def attention(prefix: str) -> None:
        out.update({f"{prefix}.in_proj_weight": (3 * d, d), f"{prefix}.in_proj_bias": (3 * d,),
                    f"{prefix}.out_proj.weight": (d, d), f"{prefix}.out_proj.bias": (d,)})

    def layer(prefix: str, attns: tuple, norms: int) -> None:
        for a in attns:
            attention(f"{prefix}.{a}")
        out.update({f"{prefix}.linear1.weight": (ff, d), f"{prefix}.linear1.bias": (ff,),
                    f"{prefix}.linear2.weight": (d, ff), f"{prefix}.linear2.bias": (d,)})
        for i in range(1, norms + 1):
            out.update({f"{prefix}.norm{i}.weight": (d,), f"{prefix}.norm{i}.bias": (d,)})

    for i in range(dims["enc_layers"]):
        layer(f"encoder.encoder.layers.{i}", ("self_attn",), 2)
    out.update({"encoder.layer_norm.weight": (d,), "encoder.layer_norm.bias": (d,),
                "decoder.tgt_tok_emb.embedding.weight": (V, d)})
    for i in range(dims["dec_layers"]):
        layer(f"decoder.decoder.layers.{i}", ("self_attn", "multihead_attn"), 3)
    out.update({"decoder.generator.weight": (V, d), "decoder.generator.bias": (V,)})
    return out


def make_weights(dims: dict, seed: int, device, eos_bias: float | None = None, eos: int = 3) -> dict:
    """{name: fp32 tensor} from one draw of a generator on `device` seeded
    with `seed`; `eos_bias` (when given) holds the EOS logit below every
    other, so a decode runs to its full length."""
    shapes = param_shapes(dims)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(math.prod(s) for s in shapes.values()), generator=gen, device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        t = flat[at : at + n].view(shape)
        at += n
        if ".norm" in name or name.startswith("encoder.layer_norm"):
            t = torch.ones(shape, device=device) if name.endswith("weight") else torch.zeros(shape, device=device)
        elif name.endswith("bias"):
            t = t * 0.02
        else:  # products and embedding rows: unit-scale outputs (the embedding is scaled by sqrt(d) in use)
            t = t * (1.0 / math.sqrt(shape[-1]))
        out[name] = t
    if eos_bias is not None:
        out["decoder.generator.bias"] = out["decoder.generator.bias"].clone()
        out["decoder.generator.bias"][eos] = eos_bias
    return out
