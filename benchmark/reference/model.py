"""The ADT seq2seq transcriber as plain tensor code over a {name: tensor}
dict, in fp32, with the names of the PyTorch state dict of ADT_STR's model
(`project_to_mel`, `encoder.encoder.layers.i.self_attn.in_proj_weight`,
...).

- encode: log-mel -> `project_to_mel` -> bias-free dense -> + sinusoidal
  positions -> post-norm layers (self-attention, GELU FFN) -> LayerNorm;
- decode: token embedding * sqrt(d) -> + positions -> post-norm layers
  (causal self-attention, cross-attention, FFN) -> generator;
- training dropout: inverted dropout whose keep-mask is a counter hash of
  each element's flat index under two seed words scrambled from the
  site's key (the murmur3 finaliser), at the sites and in the order the
  model lists them; attention-probability dropout on the softmax;
- loss: fp32 cross-entropy over the labels that are not PAD.

`precision="fp8"` is the control: every matrix product (projections and
both attention products, forward and backward) takes operands rounded to
e4m3 with a per-tensor scale, the step a lower-precision path would take.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from benchmark.reference.mel import log_mel

NEG_MASK = -1e4
PAD = 1
HASH_GOLDEN, HASH_M1, HASH_M2, U32 = 0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35, 0xFFFFFFFF
ENCODER_SITES = 4  # attention residual, FFN hidden, FFN output, attention probabilities
DECODER_SITES = 6  # self residual, cross residual, FFN hidden, FFN output, self probs, cross probs


def _fmix32(h: int) -> int:
    h ^= h >> 16
    h = (h * HASH_M1) & U32
    h ^= h >> 13
    h = (h * HASH_M2) & U32
    return h ^ (h >> 16)


def scrambled(key) -> tuple[int, int]:
    d0, d1 = (int(w) & U32 for w in key)
    return _fmix32((d0 * HASH_GOLDEN) & U32), _fmix32((d1 + HASH_GOLDEN) & U32)


def keep_mask(shape, key, keep: float, device) -> torch.Tensor:
    """Boolean keep-mask of `shape`: hash of each flat C-order index."""
    s0, s1 = scrambled(key)
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    h = (idx * HASH_GOLDEN + s0) & U32
    h = h ^ (h >> 16)
    h = ((h * HASH_M1) ^ s1) & U32
    h = h ^ (h >> 15)
    return (h < min(int(keep * 2**32), 2**32 - 1)).reshape(shape)


def positions(n: int, d: int) -> torch.Tensor:
    """Interleaved sin / cos table, den = exp(-2i ln(1e4) / d)."""
    den = np.exp(-np.arange(0, d, 2) * math.log(10000.0) / d)
    pos = np.arange(n)[:, None]
    table = np.zeros((n, d), np.float32)
    table[:, 0::2] = np.sin(pos * den)
    table[:, 1::2] = np.cos(pos * den)
    return torch.from_numpy(table)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to e4m3 with a per-tensor scale that maps |x|'s max to 448."""
    scale = x.abs().amax().clamp(min=1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Fp8Matmul(torch.autograd.Function):
    """a @ b with every product's operands in fp8, forward and backward:
    the gradient is rounded to e4m3 too before each of its two products."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = fp8(a.detach()), fp8(b.detach())
        ctx.save_for_backward(qa, qb)
        return torch.matmul(qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = fp8(g)
        grad_a = torch.matmul(qg, qb.transpose(-1, -2))
        if qb.dim() == 2:  # a weight: sum over the rows of every batch
            grad_b = torch.matmul(qa.reshape(-1, qa.shape[-1]).t(), qg.reshape(-1, qg.shape[-1]))
        else:
            grad_b = torch.matmul(qa.transpose(-1, -2), qg)
        return grad_a, grad_b


class Reference:
    """The model at `dims` (d_model, nhead, ffn, layers, vocab, n_mels and
    the frontend's rate, window and hop) over the parameters `p`."""

    def __init__(self, p: dict, dims: dict, precision: str = "fp32", dropout: float = 0.0):
        self.p, self.dims, self.dropout = p, dims, dropout
        self.fp8 = precision == "fp8"
        self._fp8_weights: dict = {}  # weights that take no gradient, rounded once
        device = next(iter(p.values())).device
        self.pe = positions(dims["max_positions"], dims["d_model"]).to(device)

    def _mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return Fp8Matmul.apply(a, b) if self.fp8 else torch.matmul(a, b)

    def _linear(self, x, name: str, rows: Optional[slice] = None, bias: bool = True):
        w = self.p[f"{name}.weight"] if rows is None else self.p[f"{name}_weight"][rows]
        if self.fp8 and not torch.is_grad_enabled():
            key = (name, None if rows is None else (rows.start, rows.stop))
            if key not in self._fp8_weights:
                self._fp8_weights[key] = fp8(w).t()
            y = torch.matmul(fp8(x), self._fp8_weights[key])
        else:
            y = self._mm(x, w.t())
        if bias:
            y = y + (self.p[f"{name}.bias"] if rows is None else self.p[f"{name}_bias"][rows])
        return y

    def _drop(self, x, key, train: bool):
        if not train or self.dropout == 0.0 or key is None:
            return x
        keep = 1.0 - self.dropout
        return torch.where(keep_mask(tuple(x.shape), key, keep, x.device), x * (1.0 / keep), 0.0)

    def _ln(self, x, name: str):
        return torch.nn.functional.layer_norm(x, (x.shape[-1],), self.p[f"{name}.weight"], self.p[f"{name}.bias"],
                                              1e-5)

    def _heads(self, x, name: str, part: int):
        """(B, T, d) -> (B, H, T, hd): the query (0), key (1) or value (2) projection."""
        d, H = self.dims["d_model"], self.dims["nhead"]
        B, T, _ = x.shape
        return self._linear(x, f"{name}.in_proj", slice(part * d, (part + 1) * d)).reshape(B, T, H, d // H) \
            .transpose(1, 2)

    def _attend(self, q, k, v, name: str, mask, probs_key, train: bool):
        B, H, Tq, hd = q.shape
        scores = self._mm(q, k.transpose(-1, -2)) / math.sqrt(hd)
        if mask is not None:
            scores = scores + mask
        probs = self._drop(torch.softmax(scores, dim=-1), probs_key, train)
        out = self._mm(probs, v).transpose(1, 2).reshape(B, Tq, H * hd)
        return self._linear(out, f"{name}.out_proj")

    def _attention(self, x, kv, name: str, mask, probs_key, train: bool):
        return self._attend(self._heads(x, name, 0), self._heads(kv, name, 1), self._heads(kv, name, 2), name, mask,
                            probs_key, train)

    def _ffn(self, x, name: str, key_h, key_o, train: bool):
        h = torch.nn.functional.gelu(self._linear(x, f"{name}.linear1"))
        return self._drop(self._linear(self._drop(h, key_h, train), f"{name}.linear2"), key_o, train)

    def encode(self, wave: torch.Tensor, keys=None, train: bool = False) -> torch.Tensor:
        dm = self.dims
        L = dm["enc_layers"]
        keys = keys or [None] * (ENCODER_SITES * L + 2)
        mel = log_mel(wave, dm["sample_rate"], dm["win_length"], dm["hop"], dm["n_mels"])
        x = self._linear(mel, "project_to_mel")
        x = self._linear(x, "encoder.dense_layer", bias=False)
        x = self._drop(x + self.pe[: x.shape[1]], keys[0], train)
        for i in range(L):
            k = keys[1 + ENCODER_SITES * i : 1 + ENCODER_SITES * (i + 1)]
            n = f"encoder.encoder.layers.{i}"
            a = self._attention(x, x, f"{n}.self_attn", None, k[3], train)
            x = self._ln(x + self._drop(a, k[0], train), f"{n}.norm1")
            x = self._ln(x + self._ffn(x, n, k[1], k[2], train), f"{n}.norm2")
        return self._drop(self._ln(x, "encoder.layer_norm"), keys[-1], train)

    def decode(self, tokens: torch.Tensor, memory: torch.Tensor, mask, keys=None, train: bool = False):
        """(B, T) ids over (B, S, d) memory -> (B, T, vocab) logits."""
        dm = self.dims
        L = dm["dec_layers"]
        keys = keys or [None] * (DECODER_SITES * L + 1)
        emb = self.p["decoder.tgt_tok_emb.embedding.weight"]
        x = emb[tokens] * math.sqrt(dm["d_model"])
        x = self._drop(x + self.pe[: x.shape[1]], keys[0], train)
        for i in range(L):
            k = keys[1 + DECODER_SITES * i : 1 + DECODER_SITES * (i + 1)]
            n = f"decoder.decoder.layers.{i}"
            a = self._attention(x, x, f"{n}.self_attn", mask, k[4], train)
            x = self._ln(x + self._drop(a, k[0], train), f"{n}.norm1")
            c = self._attention(x, memory, f"{n}.multihead_attn", None, k[5], train)
            x = self._ln(x + self._drop(c, k[1], train), f"{n}.norm2")
            x = self._ln(x + self._ffn(x, n, k[2], k[3], train), f"{n}.norm3")
        return self._linear(x, "decoder.generator")

    def loss(self, wave, tokens, lengths, keys=None, train: bool = False, rows: Optional[slice] = None):
        """Teacher-forced fp32 cross-entropy, the mean over non-PAD labels
        (of `rows` alone when given: the fault that leaves rows out)."""
        if rows is not None:
            wave, tokens, lengths = wave[rows], tokens[rows], lengths[rows]
        n_enc = ENCODER_SITES * self.dims["enc_layers"] + 2
        enc_keys, dec_keys = (None, None) if keys is None else (keys[:n_enc], keys[n_enc:])
        memory = self.encode(wave, enc_keys, train)
        inp, labels = tokens[:, :-1], tokens[:, 1:]
        T = inp.shape[1]
        mask = torch.triu(torch.full((T, T), NEG_MASK, device=wave.device), diagonal=1)[None, None]
        pos = torch.arange(T, device=wave.device)
        mask = mask + torch.where(pos[None, :] >= lengths[:, None], NEG_MASK, 0.0)[:, None, None, :]
        logits = self.decode(inp, memory, mask, dec_keys, train)
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
        valid = (labels != PAD).float()
        return (nll * valid).sum() / valid.sum().clamp(min=1.0)

    def start_decode(self, memory: torch.Tensor, rows_per_item: int, max_length: int) -> dict:
        """The state of an incremental decode of `rows_per_item` rows an item
        over (B, S, d) memory: each decoder layer's cross-attention keys and
        values, and room for its self-attention keys and values."""
        dm = self.dims
        R, H, hd = memory.shape[0] * rows_per_item, dm["nhead"], dm["d_model"] // dm["nhead"]
        state = {"cross": [], "self": []}
        for i in range(dm["dec_layers"]):
            n = f"decoder.decoder.layers.{i}.multihead_attn"
            state["cross"].append(tuple(self._heads(memory, n, part).repeat_interleave(rows_per_item, 0)
                                        for part in (1, 2)))
            state["self"].append(tuple(torch.zeros(R, H, max_length, hd, device=memory.device) for _ in range(2)))
        return state

    def decode_step(self, tokens: torch.Tensor, pos: int, state: dict) -> torch.Tensor:
        """(R,) ids at position `pos`, each row given its own earlier
        positions in `state` -> (R, vocab) logits; writes the position's keys
        and values into `state`."""
        dm = self.dims
        emb = self.p["decoder.tgt_tok_emb.embedding.weight"]
        x = (emb[tokens] * math.sqrt(dm["d_model"]) + self.pe[pos])[:, None]
        for i in range(dm["dec_layers"]):
            n = f"decoder.decoder.layers.{i}"
            keys, values = state["self"][i]
            keys[:, :, pos : pos + 1] = self._heads(x, f"{n}.self_attn", 1)
            values[:, :, pos : pos + 1] = self._heads(x, f"{n}.self_attn", 2)
            a = self._attend(self._heads(x, f"{n}.self_attn", 0), keys[:, :, : pos + 1], values[:, :, : pos + 1],
                             f"{n}.self_attn", None, None, False)
            x = self._ln(x + a, f"{n}.norm1")
            ck, cv = state["cross"][i]
            c = self._attend(self._heads(x, f"{n}.multihead_attn", 0), ck, cv, f"{n}.multihead_attn", None, None,
                             False)
            x = self._ln(x + c, f"{n}.norm2")
            x = self._ln(x + self._ffn(x, n, None, None, False), f"{n}.norm3")
        return self._linear(x, "decoder.generator")[:, 0]

    def reorder(self, state: dict, src: torch.Tensor, upto: int) -> None:
        """Row r of `state` takes row src[r]'s self-attention keys and values
        up to position `upto`."""
        for keys, values in state["self"]:
            keys[:, :, :upto] = keys[src, :, :upto]
            values[:, :, :upto] = values[src, :, :upto]

    def causal_logits(self, wave: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """(B, samples) chunks and (B, T) served rows (BOS first) -> the
        (B, T - 1, vocab) logits at each position given the row before it."""
        memory = self.encode(wave)
        inp = tokens[:, :-1]
        T = inp.shape[1]
        mask = torch.triu(torch.full((T, T), NEG_MASK, device=wave.device), diagonal=1)[None, None]
        return self.decode(inp, memory, mask)
