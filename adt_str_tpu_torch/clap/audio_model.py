"""CLAP audio tower: the HTSAT Swin transformer and the audio projection.

Port of `adt_str_tpu/clap/audio_model.py` as `nn.Module`s whose state-dict
keys are HF `ClapModel`'s (`audio_model.audio_encoder.*`,
`audio_projection.*`, buffers included), so the audio half of an HF
checkpoint loads with `load_state_dict`. Architecture (HF
`modeling_clap.py`, laion/clap-htsat-fused defaults):

- input: the 4-channel fused dB log-mel (B, 4, T, 64); BatchNorm over mel
  bins, inference mode;
- `reshape_mel2img`: bicubic time interpolation to 1024 frames
  (align_corners=True, as the exact interpolation matrix of the JAX
  package), then the HTSAT frequency regrouping to a (256, 256) image;
- patch embed: a 4x4/4 conv, and where `is_longer` the fused local path (a
  (4, 12)/(4, 12) conv over the 3 crop channels) through the attentional
  feature fusion block -> 64 x 64 x 96;
- 4 Swin stages (depths 2, 2, 6, 2; heads 4, 8, 16, 32; window 8; shifted
  windows with relative position bias; a stage whose resolution equals the
  window has no shift, and none may be smaller), patch merging between
  stages;
- final LayerNorm, the HTSAT frequency regrouping, the temporal mean -> 768;
- projection 768 -> 512 -> 512 with ReLU, L2-normalised.

Inference only. The products are `torch.matmul` and `F.conv2d`, fp32 (the
JAX package computes them outside any Pallas kernel; the head dim is 24).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclass(frozen=True)
class ClapAudioArch:
    """Static architecture facts (ClapAudioConfig defaults: htsat-fused)."""

    window_size: int = 8
    num_mel_bins: int = 64
    spec_size: int = 256
    patch_size: int = 4
    patch_stride: int = 4
    hidden_size: int = 768
    projection_dim: int = 512
    depths: tuple[int, ...] = (2, 2, 6, 2)
    num_heads: tuple[int, ...] = (4, 8, 16, 32)
    patch_embeds_hidden_size: int = 96
    enable_fusion: bool = True
    mlp_ratio: float = 4.0
    aff_block_r: int = 4
    layer_norm_eps: float = 1e-5

    @property
    def freq_ratio(self) -> int:
        return self.spec_size // self.num_mel_bins

    @property
    def grid_size(self) -> int:
        return self.spec_size // self.patch_stride

    @property
    def num_features(self) -> int:
        return int(self.patch_embeds_hidden_size * 2 ** (len(self.depths) - 1))


# ----------------------------------------------------------------- helpers

@functools.lru_cache(maxsize=8)
def _bicubic_matrix_align_corners(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) interpolation matrix of torch's bicubic resize with
    align_corners=True (cubic convolution a=-0.75, edges replicated)."""

    def cubic(x, a=-0.75):
        x = abs(x)
        if x <= 1:
            return (a + 2) * x**3 - (a + 3) * x**2 + 1
        if x < 2:
            return a * x**3 - 5 * a * x**2 + 8 * a * x - 4 * a
        return 0.0

    M = np.zeros((n_out, n_in), dtype=np.float64)
    scale = (n_in - 1) / (n_out - 1) if n_out > 1 else 0.0
    for i in range(n_out):
        x = i * scale
        x0 = int(np.floor(x))
        for k in range(-1, 3):
            idx = min(max(x0 + k, 0), n_in - 1)
            M[i, idx] += cubic(x - (x0 + k))
    return M.astype(np.float32)


@functools.lru_cache(maxsize=16)
def _bicubic_on(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_bicubic_matrix_align_corners(n_in, n_out)).to(device)


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nH * nW, ws, ws, C)."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, C)


def window_reverse(windows: torch.Tensor, ws: int, H: int, W: int) -> torch.Tensor:
    B = windows.shape[0] // (H * W // ws // ws)
    x = windows.reshape(B, H // ws, W // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, -1)


def _relative_position_index(ws: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)  # (ws*ws, ws*ws)


def _shift_attn_mask(H: int, W: int, ws: int, shift: int) -> Optional[np.ndarray]:
    """(num_windows, ws*ws, ws*ws) additive mask of shifted windows: -100
    between tokens of different regions."""
    if shift == 0:
        return None
    img = np.zeros((1, H, W, 1), dtype=np.float32)
    slices = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    count = 0
    for hs in slices:
        for wsl in slices:
            img[:, hs, wsl, :] = count
            count += 1
    x = img.reshape(1, H // ws, ws, W // ws, ws, 1)
    windows = x.transpose(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws)
    mask = windows[:, None, :] - windows[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


class _Dense(nn.Module):
    """A `dense` linear layer under its own name (HF's key layout)."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.dense = nn.Linear(d_in, d_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dense(x)


class ClapProjection(nn.Module):
    """linear1 -> ReLU -> linear2 (`ClapProjectionLayer`)."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.linear1 = nn.Linear(d_in, d_out)
        self.linear2 = nn.Linear(d_out, d_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear2(F.relu(self.linear1(x)))


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


# ------------------------------------------------------------------- blocks

class SwinSelfAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, ws: int):
        super().__init__()
        self.num_heads = num_heads
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(torch.zeros((2 * ws - 1) ** 2, num_heads))
        self.register_buffer("relative_position_index", torch.from_numpy(_relative_position_index(ws)))

    def forward(self, x: torch.Tensor, attn_mask: Optional[torch.Tensor]) -> torch.Tensor:
        """x: (nW * B, ws * ws, C) -> the heads' context, same shape."""
        nwb, n, c = x.shape
        hd = c // self.num_heads

        def heads(t):
            return t.reshape(nwb, n, self.num_heads, hd).transpose(1, 2)

        q, k, v = heads(self.query(x)), heads(self.key(x)), heads(self.value(x))
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
        bias = self.relative_position_bias_table[self.relative_position_index.reshape(-1)]
        scores = scores + bias.reshape(n, n, self.num_heads).permute(2, 0, 1)[None]
        if attn_mask is not None:
            nw = attn_mask.shape[0]
            scores = scores.reshape(nwb // nw, nw, self.num_heads, n, n) + attn_mask[None, :, None]
            scores = scores.reshape(nwb, self.num_heads, n, n)
        out = torch.matmul(torch.softmax(scores, dim=-1), v)
        return out.transpose(1, 2).reshape(nwb, n, c)


class SwinAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, ws: int):
        super().__init__()
        self.self = SwinSelfAttention(dim, num_heads, ws)
        self.output = _Dense(dim, dim)

    def forward(self, x: torch.Tensor, attn_mask: Optional[torch.Tensor]) -> torch.Tensor:
        return self.output(self.self(x, attn_mask))


class SwinLayer(nn.Module):
    """One Swin block at resolution H x W (window multiples in HTSAT), its
    window `ws` and shift fixed at construction."""

    def __init__(self, dim: int, num_heads: int, H: int, W: int, ws: int, shift: int, mlp_ratio: float,
                 eps: float):
        super().__init__()
        self.H, self.W, self.ws, self.shift = H, W, ws, shift
        self.layernorm_before = nn.LayerNorm(dim, eps=eps)
        self.attention = SwinAttention(dim, num_heads, ws)
        self.layernorm_after = nn.LayerNorm(dim, eps=eps)
        self.intermediate = _Dense(dim, int(dim * mlp_ratio))
        self.output = _Dense(int(dim * mlp_ratio), dim)
        mask = _shift_attn_mask(H, W, ws, shift)
        self.register_buffer("attn_mask", None if mask is None else torch.from_numpy(mask), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, _, C = x.shape
        H, W, ws, shift = self.H, self.W, self.ws, self.shift
        shortcut = x
        x = self.layernorm_before(x).reshape(B, H, W, C)
        if shift > 0:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
        windows = window_partition(x, ws).reshape(-1, ws * ws, C)
        attn = self.attention(windows, self.attn_mask)
        x = window_reverse(attn.reshape(-1, ws, ws, C), ws, H, W)
        if shift > 0:
            x = torch.roll(x, (shift, shift), dims=(1, 2))
        x = shortcut + x.reshape(B, H * W, C)
        h = F.gelu(self.intermediate(self.layernorm_after(x)))
        return x + self.output(h)


class PatchMerging(nn.Module):
    def __init__(self, dim: int, H: int, W: int, eps: float):
        super().__init__()
        self.H, self.W = H, W
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(4 * dim, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, _, C = x.shape
        x = x.reshape(B, self.H, self.W, C)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x.reshape(B, -1, 4 * C)))


class SwinStage(nn.Module):
    def __init__(self, arch: ClapAudioArch, si: int, res: int):
        super().__init__()
        dim = arch.patch_embeds_hidden_size * 2**si
        ws = arch.window_size
        if res < ws:  # HF sizes every bias table by the configured window
            raise ValueError(f"stage {si} has resolution {res}, below the window {ws}")
        blocks = []
        for li in range(arch.depths[si]):
            shift = 0 if li % 2 == 0 or res == ws else ws // 2
            blocks.append(SwinLayer(dim, arch.num_heads[si], res, res, ws, shift, arch.mlp_ratio, arch.layer_norm_eps))
        self.blocks = nn.ModuleList(blocks)
        last = si == len(arch.depths) - 1
        self.downsample = None if last else PatchMerging(dim, res, res, arch.layer_norm_eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = block(x)
        return x if self.downsample is None else self.downsample(x)


class AFFBlock(nn.Module):
    """Attentional feature fusion (`ClapAudioAFFBlock`), NCHW."""

    def __init__(self, channels: int, r: int):
        super().__init__()
        inter = channels // r
        self.local_att = nn.Sequential(
            nn.Conv2d(channels, inter, 1), nn.BatchNorm2d(inter), nn.ReLU(),
            nn.Conv2d(inter, channels, 1), nn.BatchNorm2d(channels))
        self.global_att = nn.Sequential(
            nn.AdaptiveAvgPool2d(1), nn.Conv2d(channels, inter, 1), nn.BatchNorm2d(inter), nn.ReLU(),
            nn.Conv2d(inter, channels, 1), nn.BatchNorm2d(channels))

    def forward(self, hidden: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        s = hidden + residual
        gate = torch.sigmoid(self.local_att(s) + self.global_att(s))
        return 2 * hidden * gate + 2 * residual * (1 - gate)


class PatchEmbed(nn.Module):
    def __init__(self, arch: ClapAudioArch):
        super().__init__()
        c, ps, st = arch.patch_embeds_hidden_size, arch.patch_size, arch.patch_stride
        self.stride = st
        self.proj = nn.Conv2d(1, c, ps, stride=st)
        self.norm = nn.LayerNorm(c, eps=arch.layer_norm_eps)
        if arch.enable_fusion:
            self.mel_conv2d = nn.Conv2d(1, c, (ps, ps * 3), stride=(st, st * 3))
            self.fusion_model = AFFBlock(c, arch.aff_block_r)
        else:
            self.mel_conv2d = self.fusion_model = None

    def forward(self, x: torch.Tensor, is_longer: torch.Tensor) -> torch.Tensor:
        """(B, 4, 256, 256) -> (B, 64 * 64, 96). The fused local path runs
        for the rows where `is_longer` alone; the others keep the global
        embedding."""
        out = self.proj(x[:, 0:1])
        if self.fusion_model is not None:
            rows = torch.nonzero(is_longer.reshape(-1)).reshape(-1)
            if rows.numel():
                n = rows.numel()
                local = x[rows, 1:4].reshape(n * 3, 1, x.shape[2], x.shape[3])
                local = self.mel_conv2d(local)
                _, feat, h, w = local.shape
                local = local.reshape(n, 3, feat, h, w).permute(0, 2, 3, 1, 4).reshape(n, feat, h, 3 * w)
                local = F.pad(local, (0, out.shape[-1] - local.shape[-1]))
                out = out.index_copy(0, rows, self.fusion_model(out[rows], local))
        B, C, H, W = out.shape
        return self.norm(out.reshape(B, C, H * W).transpose(1, 2))


class HTSATEncoder(nn.Module):
    """`audio_model.audio_encoder`: fused log-mel -> (B, 768) pooled output."""

    def __init__(self, arch: ClapAudioArch):
        super().__init__()
        self.arch = arch
        self.batch_norm = nn.BatchNorm2d(arch.num_mel_bins)
        self.patch_embed = PatchEmbed(arch)
        res = arch.grid_size
        stages = []
        for si in range(len(arch.depths)):
            stages.append(SwinStage(arch, si, res))
            res //= 2
        self.layers = nn.ModuleList(stages)
        self.norm = nn.LayerNorm(arch.num_features, eps=arch.layer_norm_eps)

    def reshape_mel2img(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C, T, F) normalised mel -> (B, C, 256, 256) HTSAT image."""
        arch = self.arch
        B, C, T, Fq = x.shape
        spec_width = arch.spec_size * arch.freq_ratio  # 1024
        spec_height = arch.spec_size // arch.freq_ratio  # 64
        if T > spec_width or Fq > spec_height:
            raise ValueError("wav size should be <= the swin input size")
        if T < spec_width:
            x = torch.matmul(_bicubic_on(T, spec_width, x.device), x)
        if Fq < spec_height:
            x = torch.matmul(x, _bicubic_on(Fq, spec_height, x.device).T)
        B, C, T, Fq = x.shape
        x = x.reshape(B, C * arch.freq_ratio, T // arch.freq_ratio, Fq).transpose(2, 3)
        return x.reshape(B, C, Fq * arch.freq_ratio, T // arch.freq_ratio)

    def forward(self, input_features: torch.Tensor, is_longer: torch.Tensor) -> torch.Tensor:
        arch = self.arch
        x = self.batch_norm(input_features.transpose(1, 3)).transpose(1, 3)  # mel bins as channels
        x = self.reshape_mel2img(x)
        frames_num = x.shape[2]
        h = self.patch_embed(x, is_longer)
        for stage in self.layers:
            h = stage(h)
        h = self.norm(h)
        B, _, C = h.shape
        freq_shape = frames_num // (2 ** (len(arch.depths) - 1)) // arch.patch_stride
        h = h.transpose(1, 2).reshape(B, C, freq_shape, freq_shape)
        c_freq_bin = freq_shape // arch.freq_ratio
        h = h.reshape(B, C, freq_shape // c_freq_bin, c_freq_bin, freq_shape)
        h = h.permute(0, 1, 3, 2, 4).reshape(B, C, c_freq_bin, -1)
        return h.reshape(B, C, -1).mean(dim=-1)


class _AudioModel(nn.Module):
    """`audio_model`: the holder of `audio_encoder` in HF's layout."""

    def __init__(self, arch: ClapAudioArch):
        super().__init__()
        self.audio_encoder = HTSATEncoder(arch)


class ClapAudioTower(nn.Module):
    """HTSAT encoder + audio projection; state-dict keys are HF ClapModel's
    `audio_model.audio_encoder.*` and `audio_projection.*`."""

    def __init__(self, arch: ClapAudioArch = ClapAudioArch()):
        super().__init__()
        self.arch = arch
        self.audio_model = _AudioModel(arch)
        self.audio_projection = ClapProjection(arch.hidden_size, arch.projection_dim)

    def pooled(self, input_features: torch.Tensor, is_longer: torch.Tensor) -> torch.Tensor:
        """(B, 4, T, 64) + (B,) bool -> (B, hidden) pooled output."""
        return self.audio_model.audio_encoder(input_features, is_longer)

    def forward(self, input_features: torch.Tensor, is_longer: torch.Tensor) -> torch.Tensor:
        """L2-normalised (B, projection_dim) embeddings (`get_audio_features`)."""
        return l2_normalize(self.audio_projection(self.pooled(input_features, is_longer)))
