"""Greedy KV-cache decoding.

Port of `adt_str_tpu/models/decode.py` (`init_caches`, `decode_step`,
`greedy_decode`, `greedy_decode_from_memory`; beam search comes in a later
slice). The JAX `lax.while_loop` becomes a Python loop with the same
semantics:

- the self-attention cache is (L, B, H, max_len, head_dim), written in place
  at `step` before attending; cross-attention K/V are projected once;
- self-attention runs over the whole cache with -1e4 on positions > step;
- the input is `embedding * sqrt(d) + PE[step]` in the compute dtype;
- the loop runs while `step < max_length - 1` and not every row finished;
  finished rows are filled with EOS.

The decode loop runs no kernel of its own: like the JAX `decode_step`, it
calls `attention_core` directly.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from adt_str_tpu_torch.models import transformer as T
from adt_str_tpu_torch.models.adt import ADTModel


class DecoderCaches(NamedTuple):
    k_self: torch.Tensor  # (L, B, H, max_len, hd), updated in place
    v_self: torch.Tensor
    k_cross: torch.Tensor  # (L, B, H, S, hd)
    v_cross: torch.Tensor


def init_caches(model: ADTModel, memory: torch.Tensor, max_len: int) -> DecoderCaches:
    cfg, compute = model.config, model.compute_dtype
    layers = model.decoder.decoder.layers
    mem = memory.to(compute)
    d = cfg.d_model
    k_cross = torch.stack([l.multihead_attn.project(mem, slice(d, 2 * d)) for l in layers])
    v_cross = torch.stack([l.multihead_attn.project(mem, slice(2 * d, 3 * d)) for l in layers])
    shape = (len(layers), memory.shape[0], cfg.nhead, max_len, cfg.d_query)
    return DecoderCaches(
        k_self=torch.zeros(shape, dtype=compute, device=memory.device),
        v_self=torch.zeros(shape, dtype=compute, device=memory.device),
        k_cross=k_cross,
        v_cross=v_cross,
    )


def decode_step(
    model: ADTModel, token: torch.Tensor, step: int, caches: DecoderCaches
) -> torch.Tensor:
    """One incremental decoder step -> (B, vocab) logits for the next token.
    Writes this step's self-attention K/V into `caches` in place."""
    cfg, compute = model.config, model.compute_dtype
    d, H = cfg.d_model, cfg.nhead
    max_len = caches.k_self.shape[3]
    x = model.embed_tokens(token) + model.pe[step].to(compute)  # (B, d)
    x = x[:, None, :]
    pos = torch.arange(max_len, device=x.device)
    self_mask = torch.where(pos > step, T.NEG_MASK, 0.0)[None, None, None, :]

    for li, layer in enumerate(model.decoder.decoder.layers):
        sa = layer.self_attn
        # one fused (d -> 3d) projection, then split
        xw = x @ sa.in_proj_weight.to(compute).T + sa.in_proj_bias.to(compute)
        q = T.split_heads(xw[..., :d], H)
        caches.k_self[li, :, :, step] = T.split_heads(xw[..., d : 2 * d], H)[:, :, 0]
        caches.v_self[li, :, :, step] = T.split_heads(xw[..., 2 * d :], H)[:, :, 0]
        attn = T.attention_core(q, caches.k_self[li], caches.v_self[li], self_mask)
        x = T.layer_norm(layer.norm1, x + T.linear(sa.out_proj, T.merge_heads(attn)))

        ca = layer.multihead_attn
        qc = ca.project(x, slice(0, d))
        cross = T.attention_core(qc, caches.k_cross[li], caches.v_cross[li], None)
        x = T.layer_norm(layer.norm2, x + T.linear(ca.out_proj, T.merge_heads(cross)))
        x = T.layer_norm(layer.norm3, x + T.ffn(layer, x))

    return T.linear(model.decoder.generator, x)[:, 0, :]


@torch.inference_mode()
def greedy_decode_from_memory(
    model: ADTModel,
    memory: torch.Tensor,
    max_length: int,
    start_token: int = 2,
    end_token: int = 3,
) -> torch.Tensor:
    """(B, S, d) memory -> (B, max_length) int32 tokens on memory's device."""
    B = memory.shape[0]
    caches = init_caches(model, memory, max_length)
    tokens = torch.full((B, max_length), end_token, dtype=torch.long, device=memory.device)
    tokens[:, 0] = start_token
    finished = torch.zeros(B, dtype=torch.bool, device=memory.device)
    step = 0
    while step < max_length - 1 and not bool(finished.all()):
        logits = decode_step(model, tokens[:, step], step, caches)
        next_token = torch.where(finished, end_token, logits.argmax(dim=-1))
        tokens[:, step + 1] = next_token
        finished |= next_token == end_token
        step += 1
    return tokens.to(torch.int32)


@torch.inference_mode()
def greedy_decode(
    model: ADTModel,
    wave: torch.Tensor,
    max_length: int = 1000,
    start_token: int = 2,
    end_token: int = 3,
) -> torch.Tensor:
    """(B, samples) audio -> (B, max_length) int32 tokens (EOS-filled after
    each row finishes)."""
    memory = model.encode(wave)
    return greedy_decode_from_memory(model, memory, max_length, start_token, end_token)
