"""ADT seq2seq model: log-mel -> encoder -> autoregressive token decoder.

Port of `adt_str_tpu/models/adt.py` (`init_params`, `encode`,
`embed_tokens`, `decode_logits`) as one `nn.Module`. Its parameter names
are those of the reference PyTorch state dict
(`adt_str_tpu/models/torch_compat.py:params_to_torch_state_dict`), so a
reference checkpoint loads with `load_state_dict(strict=True)`; the
positional table is a non-persistent buffer.

- `encode`: waveform -> fp32 log-mel (K1 `ops/cuda_mel.py:log_mel` when
  `use_pallas_mel`, else the rfft path) -> `project_to_mel` -> bias-free
  dense -> + sinusoidal PE -> post-norm encoder layers (K5 self-attention
  when `use_flash_attention`) -> LayerNorm;
- `decode_logits`: embedding * sqrt(d_model) -> + PE -> post-norm decoder
  layers -> generator.

Parameters are fp32; activations run in `config.compute_dtype`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from adt_str_tpu_torch import resolve_device, torch_dtype
from adt_str_tpu_torch.config import ModelConfig
from adt_str_tpu_torch.models import transformer as T
from adt_str_tpu_torch.ops import cuda_mel
from adt_str_tpu_torch.ops.mel import MelFrontendParams, log_mel_spectrogram


def mel_params(config: ModelConfig) -> MelFrontendParams:
    return MelFrontendParams(
        sample_rate=config.sample_rate,
        win_length=config.win_length,
        hop_length=int(config.time_res * config.sample_rate),
        n_mels=config.n_mels,
    )


class _Stack(nn.Module):
    def __init__(self, layers: list[nn.Module]):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class Encoder(nn.Module):
    def __init__(self, config: ModelConfig):
        super().__init__()
        d, ff = config.d_model, config.ffn_dim
        self.dense_layer = nn.Linear(d, d, bias=False)
        self.encoder = _Stack([T.EncoderLayer(d, config.nhead, ff) for _ in range(config.enc_layers)])
        self.layer_norm = nn.LayerNorm(d)


class TokenEmbedding(nn.Module):
    def __init__(self, vocab: int, d_model: int):
        super().__init__()
        self.embedding = nn.Embedding(vocab, d_model)


class Decoder(nn.Module):
    def __init__(self, config: ModelConfig):
        super().__init__()
        d, ff = config.d_model, config.ffn_dim
        self.tgt_tok_emb = TokenEmbedding(config.tgt_vocab_size, d)
        self.decoder = _Stack([T.DecoderLayer(d, config.nhead, ff) for _ in range(config.dec_layers)])
        self.generator = nn.Linear(d, config.tgt_vocab_size)


def _uniform_(t: torch.Tensor, bound: float, gen: torch.Generator) -> None:
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=gen)


class ADTModel(nn.Module):
    """The 4+4-layer seq2seq transcriber; `ADTModel(config, seed=s,
    device=d)` draws seeded random weights with `adt.init_params`'
    distributions on the CPU and moves them to `device` (None: cuda)."""

    def __init__(self, config: ModelConfig, *, seed: int = 0, device=None):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.project_to_mel = nn.Linear(config.n_mels, config.d_model)
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)
        pe = T.sinusoidal_positions(config.max_positions, config.d_model)
        self.register_buffer("pe", torch.from_numpy(pe), persistent=False)
        self.init_weights(seed)
        self.to(device)

    def init_weights(self, seed: int) -> None:
        """Linear: U(+-1/sqrt(d_in)) weight and bias; attention in_proj:
        xavier-uniform weight, zero biases, out_proj U(+-1/sqrt(d)) weight;
        LayerNorm ones/zeros; embedding N(0, 1)."""
        gen = torch.Generator().manual_seed(seed)
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                bound = 1.0 / math.sqrt(mod.in_features)
                _uniform_(mod.weight, bound, gen)
                if mod.bias is not None:
                    _uniform_(mod.bias, bound, gen)
            elif isinstance(mod, nn.LayerNorm):
                nn.init.ones_(mod.weight)
                nn.init.zeros_(mod.bias)
            elif isinstance(mod, nn.Embedding):
                with torch.no_grad():
                    mod.weight.normal_(0.0, 1.0, generator=gen)
        for mod in self.modules():  # attention overrides the Linear default above
            if isinstance(mod, T.MultiheadAttention):
                d = mod.in_proj_weight.shape[1]
                _uniform_(mod.in_proj_weight, math.sqrt(6.0 / (d + 3 * d)), gen)
                with torch.no_grad():
                    mod.in_proj_bias.zero_()
                    mod.out_proj.bias.zero_()

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch_dtype(self.config.compute_dtype)

    def encode(self, wave: torch.Tensor) -> torch.Tensor:
        """(B, samples) waveform -> (B, frames, d_model) encoder memory."""
        cfg, compute = self.config, self.compute_dtype
        if cfg.use_pallas_mel:
            mel = cuda_mel.log_mel(wave, mel_params(cfg))
        else:
            mel = log_mel_spectrogram(wave, mel_params(cfg))
        x = T.linear(self.project_to_mel, mel.to(compute))
        x = T.linear(self.encoder.dense_layer, x)
        x = x + self.pe[None, : x.shape[1]].to(compute)
        for layer in self.encoder.encoder.layers:
            x = layer(x, use_flash=cfg.use_flash_attention)
        return T.layer_norm(self.encoder.layer_norm, x)

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """Embedding lookup * sqrt(d_model), in the compute dtype."""
        if not self.config.plain:
            raise NotImplementedError("plain=False (multi-hot token inputs) is not ported")
        compute = self.compute_dtype
        emb = self.decoder.tgt_tok_emb.embedding.weight.to(compute)
        scale = torch.tensor(math.sqrt(self.config.d_model), dtype=compute, device=emb.device)
        return emb[tokens] * scale

    def decode_logits(
        self,
        tgt_tokens: torch.Tensor,
        memory: torch.Tensor,
        self_mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """(B, T) tokens + (B, S, d) memory -> (B, T, vocab) logits."""
        compute = self.compute_dtype
        x = self.embed_tokens(tgt_tokens)
        x = x + self.pe[None, : x.shape[1]].to(compute)
        mem = memory.to(compute)
        for layer in self.decoder.decoder.layers:
            x = layer(x, mem, self_mask=self_mask, use_flash=self.config.use_flash_attention)
        return T.linear(self.decoder.generator, x)
