"""KV-cache decoding: greedy and beam search.

Port of `adt_str_tpu/models/decode.py` (`init_caches`, `decode_step`,
`greedy_decode`, `greedy_decode_from_memory`, `beam_search_decode`). The
JAX `lax.while_loop` becomes a Python loop with the same semantics:

- the self-attention cache is (L, B, H, max_len, head_dim), written in place
  at `step` before attending; cross-attention K/V are projected once;
- self-attention reads the cache's first step + 1 rows (`valid_keys`):
  the whole cache with -1e4 on positions > step, as the plain version
  computes it, in the same bits;
- the input is `embedding * sqrt(d) + PE[step]` in the compute dtype;
- the loop runs while `step < max_length - 1` and not every row finished;
  finished rows are filled with EOS.

Beam search advances the B x K hypotheses together. Cache rows are never
moved: the self caches are slot-inner, (L, B, H, max_len, K, head_dim), and
each live beam knows, per position, which slot wrote the row of its
ancestry (`anc`, (B, K, max_len) slot indices: the JAX package's one-hot
ancestor matrix held as the index of its one). `_anc_attention` gathers
each beam's rows and attends as greedy does, so the selected rows are the
cached values themselves. Cross K/V are projected once per item and shared
by its K beams. Scores are `log_prob / length ** length_penalty`; finished
beams are frozen (score and length kept, EOS appended). The candidate axis
is the K x V active block (rank-major, token-ascending) followed by the K
finished beams, and a stable sort picks the best K (`torch.topk` leaves
the order of ties unspecified; `lax.top_k` is stable), so exact ties
resolve as in the JAX package. The best beam is read back through `anc`.

The decode loop runs no kernel of its own: like the JAX `decode_step`, it
calls `attention_core` directly, and on the card the products (asked
with `fixed_order`), LayerNorms and attention of each step go to the
batch-invariance kernels.

`greedy_decode_sharded` and `beam_search_decode_sharded` (JAX's mesh
decode, `adt_str_tpu/models/decode.py:437-510`) split the batch over a
`parallel/mesh.py:DataMesh`'s local entries: each entry decodes its own
rows with the model's replica on its device, with no collective, and the
rows come back in order. Decoding is row-independent, so each entry's
tokens are the full batch's decode row for row: on the CPU, and on the
card, where the inference path's LayerNorm, the decode step's products and
the attention run kernels whose sums follow a row's shape and never the
batch (`ops/layer_norm.py`, `ops/linear.py`, `ops/attention_rows.py`), and
the encoder's products keep cuBLAS, which the batch probe finds
row-independent at the encoder's 246 rows a chunk. Distinct
devices decode at once, one host thread each; entries that repeat a device
run one after the other.
"""

from __future__ import annotations

import contextlib
import copy
import math
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import torch
from torch import nn

from adt_str_tpu_torch.models import transformer as T
from adt_str_tpu_torch.models.adt import ADTModel
from adt_str_tpu_torch.ops import attention_rows
from adt_str_tpu_torch.ops import layer_norm as ln_ops
from adt_str_tpu_torch.ops import linear as linear_ops
from adt_str_tpu_torch.ops.cuda_attention import NEG_MASK
from adt_str_tpu_torch.parallel.mesh import DataMesh


class DecoderCaches(NamedTuple):
    k_self: torch.Tensor  # greedy (L, B, H, max_len, hd); beam (L, B, H, max_len, K, hd); updated in place
    v_self: torch.Tensor
    k_cross: torch.Tensor  # (L, B, H, S, hd), one per item
    v_cross: torch.Tensor


def init_caches(model: ADTModel, memory: torch.Tensor, max_len: int, beam_size: int | None = None) -> DecoderCaches:
    """Cross K/V projected from the (B, S, d) memory; zeroed self caches,
    slot-inner with a beam's K slots when `beam_size` is given."""
    if model.tp is not None:
        raise ValueError("decoding runs a model built whole: load a tensor-parallel run's checkpoint (written whole) "
                         "into an ADTModel without tp")
    cfg, compute = model.config, model.compute_dtype
    layers = model.decoder.decoder.layers
    mem = memory.to(compute)
    d = cfg.d_model
    k_cross = torch.stack([l.multihead_attn.project(mem, slice(d, 2 * d)) for l in layers])
    v_cross = torch.stack([l.multihead_attn.project(mem, slice(2 * d, 3 * d)) for l in layers])
    shape = (len(layers), memory.shape[0], cfg.nhead, max_len, cfg.d_query)
    if beam_size is not None:
        shape = (*shape[:4], beam_size, cfg.d_query)
    return DecoderCaches(
        k_self=torch.zeros(shape, dtype=compute, device=memory.device),
        v_self=torch.zeros(shape, dtype=compute, device=memory.device),
        k_cross=k_cross,
        v_cross=v_cross,
    )


def _anc_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, anc: torch.Tensor,
                   valid_keys: int) -> torch.Tensor:
    """Self-attention of B*K beam queries (B*K, H, 1, hd) over the first
    `valid_keys` positions of the slot-inner caches k, v (B, H, T, K, hd):
    beam k's position-t row is the one slot anc[b, k, t] wrote. The rows are
    gathered, not recomputed, so each beam attends over exactly its
    history's cached values, as greedy does."""
    B, H, T_len, K, hd = k.shape
    idx = anc[:, :, None, :, None, None].expand(B, K, H, T_len, 1, hd)

    def select(c: torch.Tensor) -> torch.Tensor:
        return torch.gather(c[:, None].expand(B, K, H, T_len, K, hd), 4, idx).reshape(B * K, H, T_len, hd)

    return T.attention_core(q, select(k), select(v), None, valid_keys=valid_keys)


def decode_step(
    model: ADTModel, token: torch.Tensor, step: int, caches: DecoderCaches, anc: torch.Tensor | None = None
) -> torch.Tensor:
    """One incremental decoder step -> (B, vocab) logits for the next token.
    Writes this step's self-attention K/V into `caches` in place. With
    `anc` ((B_items, K, max_len) beam ancestry), the B = B_items * K rows are
    beams over slot-inner caches and per-item cross K/V."""
    cfg, compute = model.config, model.compute_dtype
    d, H = cfg.d_model, cfg.nhead
    K = None if anc is None else anc.shape[1]
    x = model.embed_tokens(token) + model.pe[step].to(compute)  # (B, d)
    x = x[:, None, :]

    for li, layer in enumerate(model.decoder.decoder.layers):
        sa = layer.self_attn
        # one fused (d -> 3d) projection, then split
        xw = linear_ops.linear(x, sa.in_proj_weight, sa.in_proj_bias)
        q = T.split_heads(xw[..., :d], H)
        k_new = T.split_heads(xw[..., d : 2 * d], H)[:, :, 0]  # (B, H, hd)
        v_new = T.split_heads(xw[..., 2 * d :], H)[:, :, 0]
        if anc is None:
            caches.k_self[li, :, :, step] = k_new
            caches.v_self[li, :, :, step] = v_new
            attn = T.attention_core(q, caches.k_self[li], caches.v_self[li], None, valid_keys=step + 1)
        else:  # beam rows (item, slot) -> the slot-inner (item, H, slot, hd) position
            caches.k_self[li, :, :, step] = k_new.reshape(-1, K, H, k_new.shape[-1]).transpose(1, 2)
            caches.v_self[li, :, :, step] = v_new.reshape(-1, K, H, v_new.shape[-1]).transpose(1, 2)
            attn = _anc_attention(q, caches.k_self[li], caches.v_self[li], anc, step + 1)
        x = T.layer_norm(layer.norm1, x, T.linear(sa.out_proj, T.merge_heads(attn), fixed_order=True))

        ca = layer.multihead_attn
        qc = ca.project(x, slice(0, d), fixed_order=True)
        if anc is None:
            cross = T.attention_core(qc, caches.k_cross[li], caches.v_cross[li], None)
        else:  # an item's K beam queries attend its one memory as K query rows
            hd = qc.shape[-1]
            qcb = qc[:, :, 0].reshape(-1, K, H, hd).transpose(1, 2)
            cross = T.attention_core(qcb, caches.k_cross[li], caches.v_cross[li], None)
            cross = cross.transpose(1, 2).reshape(-1, H, hd)[:, :, None, :]
        x = T.layer_norm(layer.norm2, x, T.linear(ca.out_proj, T.merge_heads(cross), fixed_order=True))
        x = T.layer_norm(layer.norm3, x, T.ffn(layer, x, fixed_order=True))

    return T.linear(model.decoder.generator, x, fixed_order=True)[:, 0, :]


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


class _Tensors(nn.Module):
    """Named tensors held as buffers."""

    def __init__(self, **tensors: torch.Tensor):
        super().__init__()
        for name, t in tensors.items():
            self.register_buffer(name, t)


def _encoder_copy(model: ADTModel) -> ADTModel:
    """A copy of `model` without its decoder, whose parameters are buffers:
    `encode` as the model runs it, with nothing for autograd to record."""
    decoder = model.decoder
    try:
        del model.decoder
        enc = copy.deepcopy(model)
    finally:
        model.decoder = decoder
    for mod in enc.modules():
        for name, p in list(mod._parameters.items()):
            del mod._parameters[name]
            mod.register_buffer(name, None if p is None else p.detach())
    return enc


class GreedyProgram(nn.Module):
    """`greedy_decode` as one program that `torch.export` traces
    (`scripts/export_serving.py`): (B, samples) audio -> (B, max_length)
    int32 tokens, the same tokens as `greedy_decode(model, ...)`.

    The loop is `torch.while_loop` with the eager loop's data-dependent exit,
    `step < max_length - 1` and not every row finished. Its carries are the
    step (a 0-d int64 tensor), the tokens, the finished rows and each
    layer's self K and V caches, written with `index_copy` (a new cache a
    step, where the eager loop writes in place). Its body is `decode_step`
    with a tensor step: the position row taken with `index_select`, and
    self-attention over the whole cache with the mask that `valid_keys =
    step + 1` stands for (`attention_rows.keys_mask`), so the kernel reads
    the masked keys too, whose probabilities are 0. The decoder's weights
    are held already cast to the compute dtype, as the eager wrappers cast
    them on each call, so the loop body casts no weight; the encoder is a
    copy of the model's. Every tensor is a buffer. The kernels are recorded
    as the custom ops of `adt_str_tpu_torch.ops`."""

    def __init__(self, model: ADTModel, max_length: int, start_token: int = 2, end_token: int = 3):
        super().__init__()
        if model.tp is not None:
            raise ValueError("decoding runs a model built whole: load a tensor-parallel run's checkpoint (written "
                             "whole) into an ADTModel without tp")
        cfg, compute = model.config, model.compute_dtype
        d = cfg.d_model
        self.max_length, self.start_token, self.end_token = int(max_length), int(start_token), int(end_token)
        self.nhead, self.compute = cfg.nhead, compute
        self.encoder = _encoder_copy(model)

        def cast(t: torch.Tensor) -> torch.Tensor:
            return t.detach().to(compute).clone(memory_format=torch.contiguous_format)

        def same(t: torch.Tensor) -> torch.Tensor:
            return t.detach().clone(memory_format=torch.contiguous_format)

        layers = model.decoder.decoder.layers
        self.layers = nn.ModuleList(_Tensors(
            in_w=cast(l.self_attn.in_proj_weight), in_b=cast(l.self_attn.in_proj_bias),
            out_w=cast(l.self_attn.out_proj.weight), out_b=cast(l.self_attn.out_proj.bias),
            q_w=cast(l.multihead_attn.in_proj_weight[:d]), q_b=cast(l.multihead_attn.in_proj_bias[:d]),
            k_w=cast(l.multihead_attn.in_proj_weight[d : 2 * d]), k_b=cast(l.multihead_attn.in_proj_bias[d : 2 * d]),
            v_w=cast(l.multihead_attn.in_proj_weight[2 * d :]), v_b=cast(l.multihead_attn.in_proj_bias[2 * d :]),
            cross_w=cast(l.multihead_attn.out_proj.weight), cross_b=cast(l.multihead_attn.out_proj.bias),
            ff1_w=cast(l.linear1.weight), ff1_b=cast(l.linear1.bias), ff2_w=cast(l.linear2.weight),
            ff2_b=cast(l.linear2.bias), n1_w=same(l.norm1.weight), n1_b=same(l.norm1.bias),
            n2_w=same(l.norm2.weight), n2_b=same(l.norm2.bias), n3_w=same(l.norm3.weight), n3_b=same(l.norm3.bias),
        ) for l in layers)
        self.eps = [(l.norm1.eps, l.norm2.eps, l.norm3.eps) for l in layers]
        self.head = _Tensors(emb=cast(model.decoder.tgt_tok_emb.embedding.weight),
                             scale=torch.tensor(math.sqrt(d), dtype=compute), pe=cast(model.pe),
                             gen_w=cast(model.decoder.generator.weight), gen_b=cast(model.decoder.generator.bias))

    def forward(self, wave: torch.Tensor) -> torch.Tensor:
        memory = self.encoder.encode(wave).to(self.compute)
        B, dev, H, n = wave.shape[0], wave.device, self.nhead, self.max_length
        cross = [T.split_heads(linear_ops.linear_plain(memory, w[0], w[1]), H).contiguous()
                 for l in self.layers for w in ((l.k_w, l.k_b), (l.v_w, l.v_b))]
        hd = cross[0].shape[-1]
        caches = [torch.zeros((B, H, n, hd), dtype=self.compute, device=dev) for _ in cross]
        tokens = torch.cat([torch.full((B, 1), self.start_token, dtype=torch.long, device=dev),
                            torch.full((B, n - 1), self.end_token, dtype=torch.long, device=dev)], dim=1)
        finished = torch.zeros(B, dtype=torch.bool, device=dev)
        step = torch.zeros((), dtype=torch.long, device=dev)
        positions = torch.arange(n, device=dev)

        def cond(step, tokens, finished, *caches):
            return (step < n - 1) & ~finished.all()

        def body(step, tokens, finished, *caches):
            at = step.view(1)
            logits, caches = self._step(tokens.index_select(1, at)[:, 0], at, caches, cross,
                                        torch.where(positions > step, NEG_MASK, 0.0)[None, None, None, :])
            next_token = torch.where(finished, self.end_token, logits.argmax(dim=-1))
            tokens = tokens.index_copy(1, at + 1, next_token[:, None])
            return (step + 1, tokens, finished | (next_token == self.end_token), *caches)

        return torch.while_loop(cond, body, (step, tokens, finished, *caches))[1].to(torch.int32)

    def _step(self, token, at, caches, cross, mask) -> tuple[torch.Tensor, list]:
        """`decode_step` at the position `at` ((1,) int64) -> (B, vocab)
        logits and the self caches with this step's K and V written in."""
        H, head = self.nhead, self.head
        x = torch.nn.functional.embedding(token, head.emb) * head.scale + head.pe.index_select(0, at)
        x = x[:, None, :]
        d = x.shape[-1]
        written = []
        for li, (w, (eps1, eps2, eps3)) in enumerate(zip(self.layers, self.eps)):
            xw = linear_ops.linear(x, w.in_w, w.in_b)
            k = caches[2 * li].index_copy(2, at, T.split_heads(xw[..., d : 2 * d], H))
            v = caches[2 * li + 1].index_copy(2, at, T.split_heads(xw[..., 2 * d :], H))
            written += [k, v]
            attn = attention_rows.attention(T.split_heads(xw[..., :d], H), k, v, mask)
            x = ln_ops.add_layer_norm(x, linear_ops.linear(T.merge_heads(attn), w.out_w, w.out_b), w.n1_w, w.n1_b, eps1)
            qc = T.split_heads(linear_ops.linear(x, w.q_w, w.q_b), H)
            c = attention_rows.attention(qc, cross[2 * li], cross[2 * li + 1], None)
            x = ln_ops.add_layer_norm(x, linear_ops.linear(T.merge_heads(c), w.cross_w, w.cross_b), w.n2_w, w.n2_b,
                                      eps2)
            h = torch.nn.functional.gelu(linear_ops.linear(x, w.ff1_w, w.ff1_b))
            x = ln_ops.add_layer_norm(x, linear_ops.linear(h, w.ff2_w, w.ff2_b), w.n3_w, w.n3_b, eps3)
        return linear_ops.linear(x, head.gen_w, head.gen_b)[:, 0, :], written


@torch.inference_mode()
def beam_search_decode(
    model: ADTModel,
    wave: torch.Tensor,
    max_length: int = 1000,
    beam_size: int = 5,
    start_token: int = 2,
    end_token: int = 3,
    length_penalty: float = 1.0,
) -> torch.Tensor:
    """(B, samples) audio -> (B, max_length) int32 tokens of each item's best
    beam (EOS-filled after it finished); see the module docstring."""
    memory = model.encode(wave)
    return beam_search_decode_from_memory(model, memory, max_length, beam_size, start_token, end_token,
                                          length_penalty)


@torch.inference_mode()
def beam_search_decode_from_memory(
    model: ADTModel,
    memory: torch.Tensor,
    max_length: int,
    beam_size: int = 5,
    start_token: int = 2,
    end_token: int = 3,
    length_penalty: float = 1.0,
) -> torch.Tensor:
    """(B, S, d) memory -> (B, max_length) int32 tokens on memory's device."""
    B, dev = memory.shape[0], memory.device
    V, K, NEG = model.config.tgt_vocab_size, beam_size, -1e9
    caches = init_caches(model, memory, max_length, beam_size=K)
    # slot-local token store: row b*K + k holds the token slot k consumed at each position
    tokens = torch.full((B * K, max_length), end_token, dtype=torch.long, device=dev)
    tokens[:, 0] = start_token
    slots = torch.arange(K, device=dev)
    anc = slots[None, :, None].expand(B, K, max_length).contiguous()  # every slot wrote its own BOS
    # only beam 0 is live at first, so the first expansion seeds K distinct hypotheses
    log_probs = torch.tensor([0.0] + [NEG] * (K - 1), dtype=torch.float32, device=dev).repeat(B)
    lengths = torch.ones(B * K, dtype=torch.long, device=dev)  # including BOS
    finished = torch.zeros(B * K, dtype=torch.bool, device=dev)
    items = torch.arange(B, device=dev)[:, None]

    def score(lp: torch.Tensor, ln: torch.Tensor) -> torch.Tensor:
        return lp if length_penalty == 0.0 else lp / torch.pow(ln.float(), length_penalty)

    step = 0
    while step < max_length - 1 and not bool(finished.all()):
        logits = decode_step(model, tokens[:, step], step, caches, anc=anc)
        cand_lp = log_probs[:, None] + torch.log_softmax(logits.float(), dim=-1)  # (B*K, V)
        act_score = torch.where(finished[:, None], NEG, score(cand_lp, (lengths + 1)[:, None]))
        fin_score = torch.where(finished, score(log_probs, lengths), NEG)
        cand_score = torch.cat([act_score.reshape(B, K * V), fin_score.reshape(B, K)], dim=1)
        top = torch.sort(cand_score, dim=-1, descending=True, stable=True).indices[:, :K]  # (B, K)
        is_fin = top >= K * V  # a finished beam carried over
        beam_idx = torch.where(is_fin, top - K * V, top // V)
        tok = torch.where(is_fin, end_token, top % V)
        src = (items * K + beam_idx).reshape(-1)
        tokens[:, step + 1] = tok.reshape(-1)
        act_lp = torch.gather(cand_lp.reshape(B, K * V), 1, torch.clamp(top, max=K * V - 1))
        log_probs = torch.where(is_fin, torch.gather(log_probs.reshape(B, K), 1, beam_idx), act_lp).reshape(-1)
        lengths = lengths[src] + (~is_fin).reshape(-1).long()
        finished = finished[src] | (tok.reshape(-1) == end_token)
        anc = torch.gather(anc, 1, beam_idx[:, :, None].expand(B, K, max_length))
        anc[:, :, step + 1] = slots  # the new position's row is the slot's own
        step += 1
    final = score(log_probs, lengths).reshape(B, K)
    best = torch.sort(final, dim=-1, descending=True, stable=True).indices[:, 0]
    path = anc[items[:, 0], best]  # (B, max_length): the slot of the best beam's row at each position
    out = torch.gather(tokens.reshape(B, K, max_length), 1, path[:, None, :])[:, 0]
    return out.to(torch.int32)


def _decode_sharded(model: ADTModel, wave: torch.Tensor, mesh: DataMesh, decode) -> torch.Tensor:
    """`decode(replica, rows)` of each local mesh entry's contiguous rows of
    `wave`, on its device -> the (B, max_length) tokens in row order, on
    the mesh's first device. Under a process group `wave` holds this
    rank's rows."""
    entries = mesh.devices
    if wave.shape[0] % len(entries):
        raise ValueError(f"batch of {wave.shape[0]} rows not divisible by the mesh data axis ({len(entries)} "
                         "local entries)")
    k = wave.shape[0] // len(entries)
    by_device: dict[torch.device, list[int]] = {}
    for i, dev in enumerate(entries):
        by_device.setdefault(dev, []).append(i)
    parts: list = [None] * len(entries)

    def run(dev: torch.device, indices: list[int]) -> None:
        replica = mesh.replica(model, dev)
        with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
            for i in indices:  # entries that share a device, one after the other
                parts[i] = decode(replica, wave[i * k : (i + 1) * k].to(dev))

    if len(by_device) == 1:
        run(*next(iter(by_device.items())))
    else:
        with ThreadPoolExecutor(max_workers=len(by_device)) as pool:
            for fut in [pool.submit(run, dev, idx) for dev, idx in by_device.items()]:
                fut.result()
    return torch.cat([p.to(mesh.device) for p in parts])


def greedy_decode_sharded(model: ADTModel, wave: torch.Tensor, mesh: DataMesh, max_length: int = 1000,
                          start_token: int = 2, end_token: int = 3) -> torch.Tensor:
    """`greedy_decode` with each mesh entry decoding its own batch rows. The
    batch must be divisible by the data axis."""
    return _decode_sharded(model, wave, mesh,
                           lambda m, w: greedy_decode(m, w, max_length, start_token, end_token))


def beam_search_decode_sharded(model: ADTModel, wave: torch.Tensor, mesh: DataMesh, beam_size: int = 5,
                               max_length: int = 1000, start_token: int = 2, end_token: int = 3,
                               length_penalty: float = 1.0) -> torch.Tensor:
    """`beam_search_decode` with each mesh entry decoding its own rows."""
    return _decode_sharded(model, wave, mesh, lambda m, w: beam_search_decode(
        m, w, max_length, beam_size, start_token, end_token, length_penalty))
