"""CLAP text tower: the RoBERTa encoder and the text projection.

Port of `adt_str_tpu/clap/text_model.py` as `nn.Module`s whose state-dict
keys are HF `ClapModel`'s (`text_model.*`, `text_projection.*`, buffers
included). Architecture (ClapTextConfig defaults: roberta-base): 12
post-LN layers (eps 1e-12), hidden 768, 12 heads, FFN 3072 with the
exact-erf GELU, learned absolute positions with RoBERTa's padding offset
(`position = cumsum(mask) * mask + pad_idx`), the `finfo.min` additive
key mask, a tanh pooler over the first token, the projection 768 -> 512 ->
512 with ReLU, L2-normalised. Inference only.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from adt_str_tpu_torch.clap.audio_model import ClapProjection, _Dense, l2_normalize


@dataclass(frozen=True)
class ClapTextArch:
    vocab_size: int = 50265
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_positions: int = 514
    pad_token_id: int = 1
    layer_norm_eps: float = 1e-12
    projection_dim: int = 512


def create_position_ids(input_ids: torch.Tensor, padding_idx: int) -> torch.Tensor:
    """RoBERTa position ids: padded tokens keep `padding_idx`, the others
    count up from padding_idx + 1."""
    mask = (input_ids != padding_idx).to(torch.int64)
    return torch.cumsum(mask, dim=1) * mask + padding_idx


class _Embeddings(nn.Module):
    def __init__(self, arch: ClapTextArch):
        super().__init__()
        d = arch.hidden_size
        self.word_embeddings = nn.Embedding(arch.vocab_size, d)
        self.position_embeddings = nn.Embedding(arch.max_positions, d)
        self.token_type_embeddings = nn.Embedding(1, d)
        self.LayerNorm = nn.LayerNorm(d, eps=arch.layer_norm_eps)
        # HF's buffers, kept so the key sets agree; the forward derives its ids
        self.register_buffer("position_ids", torch.arange(arch.max_positions)[None])
        self.register_buffer("token_type_ids", torch.zeros(1, arch.max_positions, dtype=torch.int64))


class _SelfAttention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.query = nn.Linear(d, d)
        self.key = nn.Linear(d, d)
        self.value = nn.Linear(d, d)


class _DenseLN(nn.Module):
    """dense -> + residual -> LayerNorm (`RobertaSelfOutput`, `RobertaOutput`)."""

    def __init__(self, d_in: int, d: int, eps: float):
        super().__init__()
        self.dense = nn.Linear(d_in, d)
        self.LayerNorm = nn.LayerNorm(d, eps=eps)

    def forward(self, x: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        return self.LayerNorm(residual + self.dense(x))


class _Attention(nn.Module):
    def __init__(self, arch: ClapTextArch):
        super().__init__()
        self.num_heads = arch.num_heads
        self.self = _SelfAttention(arch.hidden_size)
        self.output = _DenseLN(arch.hidden_size, arch.hidden_size, arch.layer_norm_eps)

    def forward(self, x: torch.Tensor, ext_mask: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        hd = d // self.num_heads

        def heads(y):
            return y.reshape(b, t, self.num_heads, hd).transpose(1, 2)

        sa = self.self
        q, k, v = heads(sa.query(x)), heads(sa.key(x)), heads(sa.value(x))
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd) + ext_mask
        ctx = torch.matmul(torch.softmax(scores, dim=-1), v).transpose(1, 2).reshape(b, t, d)
        return self.output(ctx, x)


class _Layer(nn.Module):
    def __init__(self, arch: ClapTextArch):
        super().__init__()
        self.attention = _Attention(arch)
        self.intermediate = _Dense(arch.hidden_size, arch.intermediate_size)
        self.output = _DenseLN(arch.intermediate_size, arch.hidden_size, arch.layer_norm_eps)

    def forward(self, x: torch.Tensor, ext_mask: torch.Tensor) -> torch.Tensor:
        x = self.attention(x, ext_mask)
        return self.output(F.gelu(self.intermediate(x)), x)


class _Encoder(nn.Module):
    def __init__(self, arch: ClapTextArch):
        super().__init__()
        self.layer = nn.ModuleList(_Layer(arch) for _ in range(arch.num_layers))


class _TextModel(nn.Module):
    """`text_model`: embeddings, encoder, pooler."""

    def __init__(self, arch: ClapTextArch):
        super().__init__()
        self.arch = arch
        self.embeddings = _Embeddings(arch)
        self.encoder = _Encoder(arch)
        self.pooler = _Dense(arch.hidden_size, arch.hidden_size)

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None):
        """-> (sequence_output (B, T, H), pooled_output (B, H))."""
        arch = self.arch
        if attention_mask is None:
            attention_mask = (input_ids != arch.pad_token_id).to(torch.float32)
        emb = self.embeddings
        x = (emb.word_embeddings(input_ids)
             + emb.position_embeddings(create_position_ids(input_ids, arch.pad_token_id))
             + emb.token_type_embeddings.weight[0][None, None, :])
        x = emb.LayerNorm(x)
        ext_mask = (1.0 - attention_mask.to(torch.float32)[:, None, None, :]) * torch.finfo(torch.float32).min
        for layer in self.encoder.layer:
            x = layer(x, ext_mask)
        return x, torch.tanh(self.pooler(x[:, 0]))


class ClapTextTower(nn.Module):
    """RoBERTa encoder + text projection; state-dict keys are HF ClapModel's
    `text_model.*` and `text_projection.*`."""

    def __init__(self, arch: ClapTextArch = ClapTextArch()):
        super().__init__()
        self.arch = arch
        self.text_model = _TextModel(arch)
        self.text_projection = ClapProjection(arch.hidden_size, arch.projection_dim)

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        _, pooled = self.text_model(input_ids, attention_mask)
        return l2_normalize(self.text_projection(pooled))


def get_text_features(model: ClapTextTower, input_ids: torch.Tensor,
                      attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """L2-normalised (B, projection_dim) text embeddings of token ids
    (`ClapModel.get_text_features`), on the tower's device."""
    device = next(model.parameters()).device
    mask = None if attention_mask is None else attention_mask.to(device)
    with torch.no_grad():
        return model(input_ids.to(device), mask)
