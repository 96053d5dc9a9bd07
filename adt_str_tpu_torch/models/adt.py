"""ADT seq2seq model: log-mel -> encoder -> autoregressive token decoder.

Port of `adt_str_tpu/models/adt.py` (`init_params`, `encode`,
`embed_tokens`, `decode_logits`, `forward_loss`) as one `nn.Module`. Its parameter names
are those of the reference PyTorch state dict
(`adt_str_tpu/models/torch_compat.py:params_to_torch_state_dict`), so a
reference checkpoint loads with `load_state_dict(strict=True)`; the
positional table is a non-persistent buffer.

- `encode`: waveform -> fp32 log-mel (K1 `ops/cuda_mel.py:log_mel` when
  `use_pallas_mel`, else the rfft path) -> `project_to_mel` -> bias-free
  dense -> + sinusoidal PE -> post-norm encoder layers (K5 self-attention
  when `use_flash_attention`) -> LayerNorm;
- `decode_logits`: embedding * sqrt(d_model) -> + PE -> post-norm decoder
  layers -> generator;
- `forward_loss`: teacher forcing (`tokens[:, :-1]` in, `tokens[:, 1:]` as
  labels) with causal + padding masks -> fp32 cross-entropy.

Parameters are fp32; activations run in `config.compute_dtype`. With
`config.remat`, training recomputes each layer's activations in the
backward pass.

Tensor parallelism (`tp`, a `parallel/tensor_parallel.py:ModelAxis`):
`ADTModel(config, seed=s, tp=axis)` draws the whole model's weights, then
keeps this rank's shard (`shard_model_`): each layer runs its heads, its
FFN columns and the rows of the generator that are its vocabulary
columns; `decode_logits` returns those columns and `forward_loss` takes
the vocabulary-parallel CE (`cross_entropy_loss(..., tp=)`). The embedding,
the LayerNorms, `project_to_mel`, the encoder's dense layer and the
row-parallel biases are replicated. Decoding runs a model built whole.

FSDP (`fsdp`, set by `parallel/fsdp.py:shard_model_`): at rest the model
holds this rank's shards of the data-sharded parameters; the steps of
`parallel/train_step.py` gather the whole weights around each forward
pass (`fsdp.gathered`).

Token inputs: ids (B, T) take the embedding lookup (`plain=True`, the
reference's trained path); multi-hot rows (B, T, vocab) take the
reference's `plain=False` `TokenEmbedding` product `tokens @ emb *
sqrt(d)`, as `adt_str_tpu/models/adt.py:embed_tokens` does. Ids with
`plain=False` raise, as there.

Training dropout takes its keys as data: `dropout_sites(config)` names the
sites in the order of the JAX package's `jax.random.split` tree (forward_loss
splits the rng into encoder and decoder keys; `encode` splits into input,
one key per layer and output; `decode_logits` into input and one per layer;
each layer into 4 or 6 site keys), and a (n_sites, 2) tensor of uint32
words holds one key per site. A parity test replays the JAX tree's
`key_data` into it; training draws it from a `torch.Generator`
(`draw_site_keys`).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.utils.checkpoint
from torch import nn

from adt_str_tpu_torch import resolve_device, torch_dtype
from adt_str_tpu_torch.config import ModelConfig
from adt_str_tpu_torch.models import transformer as T
from adt_str_tpu_torch.ops import cuda_mel
from adt_str_tpu_torch.ops.mel import MelFrontendParams, log_mel_spectrogram
from adt_str_tpu_torch.parallel import tensor_parallel as tp_lib


PAD_TOKEN = 1  # loss ignore_index

ENCODER_LAYER_SITES = ("attn_residual", "ffn_hidden", "ffn_output", "attn_probs")
DECODER_LAYER_SITES = ("self_residual", "cross_residual", "ffn_hidden", "ffn_output", "self_attn_probs",
                       "cross_attn_probs")


def dropout_sites(config: ModelConfig) -> list[str]:
    """The dropout sites of `forward_loss` in the JAX split order: 43 for
    4+4 layers."""
    enc = [f"encoder.layers.{i}.{s}" for i in range(config.enc_layers) for s in ENCODER_LAYER_SITES]
    dec = [f"decoder.layers.{i}.{s}" for i in range(config.dec_layers) for s in DECODER_LAYER_SITES]
    return ["encoder.input", *enc, "encoder.output", "decoder.input", *dec]


def draw_site_keys(config: ModelConfig, generator: torch.Generator) -> torch.Tensor:
    """(n_sites, 2) int64 tensor of uint32 key words drawn from `generator`
    (on the generator's device)."""
    return torch.randint(0, 2**32, (len(dropout_sites(config)), 2), generator=generator,
                         dtype=torch.int64, device=generator.device)


def _site_words(keys) -> Optional[list[tuple[int, int]]]:
    """(n, 2) tensor or nested sequence of key words -> n (w0, w1) pairs."""
    if keys is None:
        return None
    rows = keys.tolist() if isinstance(keys, torch.Tensor) else keys
    return [(int(a), int(b)) for a, b in rows]


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
    distributions on the CPU and moves them to `device` (None: cuda);
    with `tp`, this rank's tensor-parallel shard of them."""

    tp: Optional[tp_lib.ModelAxis] = None
    fsdp = None  # the parallel/fsdp.py:FsdpLayout of a model cut by fsdp.shard_model_

    def __init__(self, config: ModelConfig, *, seed: int = 0, device=None, tp: Optional[tp_lib.ModelAxis] = None):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.project_to_mel = nn.Linear(config.n_mels, config.d_model)
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)
        pe = T.sinusoidal_positions(config.max_positions, config.d_model)
        self.register_buffer("pe", torch.from_numpy(pe), persistent=False)
        self.init_weights(seed)
        if tp is not None:
            tp_lib.shard_model_(self, tp)
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

    def _layer(self, layer: nn.Module, *args, train: bool, **kw) -> torch.Tensor:
        """One encoder or decoder layer. In training with `config.remat` its
        activations are recomputed in the backward pass instead of kept
        (`torch.utils.checkpoint`, as `jax.checkpoint` per layer in the JAX
        package); the dropout keys are data, so the recomputation is exact."""
        if train and self.config.remat:
            return torch.utils.checkpoint.checkpoint(layer, *args, train=train, use_reentrant=False, **kw)
        return layer(*args, train=train, **kw)

    def encode(self, wave: torch.Tensor, keys: Optional[Sequence] = None, train: bool = False) -> torch.Tensor:
        """(B, samples) waveform -> (B, frames, d_model) encoder memory.
        `keys`: the encoder's `4 * enc_layers + 2` site keys (None: no dropout)."""
        cfg, compute = self.config, self.compute_dtype
        n_layers = cfg.enc_layers
        keys = _site_words(keys) or [None] * (4 * n_layers + 2)
        if len(keys) != 4 * n_layers + 2:
            raise ValueError(f"encode takes {4 * n_layers + 2} site keys, got {len(keys)}")
        if cfg.use_pallas_mel:
            mel = cuda_mel.log_mel(wave, mel_params(cfg))
        else:
            mel = log_mel_spectrogram(wave, mel_params(cfg))
        x = T.linear(self.project_to_mel, mel.to(compute))
        x = T.linear(self.encoder.dense_layer, x)
        x = x + self.pe[None, : x.shape[1]].to(compute)
        x = T.dropout(x, cfg.dropout, keys[0], train)
        for i, layer in enumerate(self.encoder.encoder.layers):
            x = self._layer(layer, x, use_flash=cfg.use_flash_attention, use_pallas_ffn=cfg.use_pallas_ffn,
                            dropout_rate=cfg.dropout, keys=keys[1 + 4 * i : 5 + 4 * i], train=train)
        x = T.layer_norm(self.encoder.layer_norm, x)
        return T.dropout(x, cfg.dropout, keys[-1], train)

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """Embedding lookup * sqrt(d_model), in the compute dtype; multi-hot
        (B, T, vocab) rows -> `tokens @ emb * sqrt(d_model)`."""
        compute = self.compute_dtype
        emb = self.decoder.tgt_tok_emb.embedding.weight.to(compute)
        scale = torch.tensor(math.sqrt(self.config.d_model), dtype=compute, device=emb.device)
        if tokens.dim() == 3:  # multi-hot (plain=False)
            return torch.matmul(tokens.to(compute), emb) * scale
        if not self.config.plain:
            raise NotImplementedError("plain=False needs multi-hot (B, T, vocab) inputs (model.py:13-39)")
        # F.embedding's backward sums the rows of repeated tokens in fp32 in
        # one pass; `emb[tokens]`'s index_put backward serialises them
        return torch.nn.functional.embedding(tokens, emb) * scale

    def decode_logits(
        self,
        tgt_tokens: torch.Tensor,
        memory: torch.Tensor,
        self_mask: Optional[torch.Tensor] = None,
        keys: Optional[Sequence] = None,
        train: bool = False,
    ) -> torch.Tensor:
        """(B, T) token ids or (B, T, vocab) multi-hot rows + (B, S, d)
        memory -> (B, T, vocab) logits (under `tp`, this rank's vocabulary
        columns).
        `keys`: the decoder's `6 * dec_layers + 1` site keys (None: no dropout)."""
        cfg, compute = self.config, self.compute_dtype
        n_layers = cfg.dec_layers
        keys = _site_words(keys) or [None] * (6 * n_layers + 1)
        if len(keys) != 6 * n_layers + 1:
            raise ValueError(f"decode_logits takes {6 * n_layers + 1} site keys, got {len(keys)}")
        x = self.embed_tokens(tgt_tokens)
        x = x + self.pe[None, : x.shape[1]].to(compute)
        x = T.dropout(x, cfg.dropout, keys[0], train)
        mem = memory.to(compute)
        for i, layer in enumerate(self.decoder.decoder.layers):
            x = self._layer(layer, x, mem, self_mask=self_mask, use_flash=cfg.use_flash_attention,
                            use_pallas_ffn=cfg.use_pallas_ffn, dropout_rate=cfg.dropout,
                            keys=keys[1 + 6 * i : 7 + 6 * i], train=train)
        return T.linear(self.decoder.generator, tp_lib.copy_to_region(x, self.tp))

    def forward_loss(
        self,
        wave: torch.Tensor,
        tokens: torch.Tensor,
        token_lengths: Optional[torch.Tensor],
        keys=None,
        train: bool = False,
        reduction: str = "mean",
    ):
        """Teacher-forced loss (JAX `adt.forward_loss`). `token_lengths`
        follows the reference collate convention (`collate_token_lengths`);
        `keys` is the (n_sites, 2) tensor of site key words (None: no
        dropout); `reduction` as in `cross_entropy_loss`."""
        tgt_input, labels = tokens[:, :-1], tokens[:, 1:]
        seq_len = tgt_input.shape[1]
        words = _site_words(keys)
        n_enc = 4 * self.config.enc_layers + 2
        if words is not None and len(words) != len(dropout_sites(self.config)):
            raise ValueError(f"forward_loss takes {len(dropout_sites(self.config))} site keys, got {len(words)}")
        enc_keys, dec_keys = (None, None) if words is None else (words[:n_enc], words[n_enc:])
        memory = self.encode(wave, enc_keys, train)
        mask = T.causal_mask_additive(seq_len, device=tokens.device)
        if token_lengths is not None:
            mask = mask + T.padding_mask_additive(token_lengths, seq_len)
        logits = self.decode_logits(tgt_input, memory, self_mask=mask, keys=dec_keys, train=train)
        return cross_entropy_loss(logits, labels, reduction=reduction, tp=self.tp)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor, reduction: str = "mean",
                       tp: Optional[tp_lib.ModelAxis] = None):
    """fp32 CE over non-PAD labels with nan_to_num'd logits. "mean": the
    token-masked mean; "sum": `(nll_sum, n_valid)`. With `tp`, `logits` are
    this rank's vocabulary columns (`vocab_parallel_cross_entropy`)."""
    if tp is None:
        logits = torch.nan_to_num(logits.float(), nan=0.0, posinf=1e4, neginf=-1e4)
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    else:
        nll = tp_lib.vocab_parallel_cross_entropy(logits, labels, tp)
    valid = (labels != PAD_TOKEN).float()
    s, n = (nll * valid).sum(), valid.sum()
    if reduction == "sum":
        return s, n
    return s / torch.clamp(n, min=1.0)


def collate_token_lengths(lengths: torch.Tensor) -> torch.Tensor:
    """Reference collate quirk: lengths equal to the batch max lose one."""
    return lengths - (lengths == lengths.max()).to(lengths.dtype)
