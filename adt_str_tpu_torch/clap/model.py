"""CLAP wrapper: audio and text embeddings and their semantic match.

Port of `adt_str_tpu/clap/model.py`: `get_audio_features`,
`get_text_features` and `semantic_match` over the port's towers, with the
weights read from a local HF `laion/clap-htsat-fused` checkpoint directory
(`model.safetensors` through the port's own reader, else
`pytorch_model.bin`) and the tower shapes from its `config.json`.

Devices: the wrapper runs on `cuda` unless the caller passes
`device="cpu"`. Short clips on a card take the device-resident path: one
wave upload, K1 at CLAP's frontend, the 4x view, the tower. Long clips, and
every clip on the CPU, go through the host extractor, as the JAX wrapper's
`use_device=jax.default_backend() != "cpu"` does.
"""

from __future__ import annotations

import copy
import json
from pathlib import Path
from typing import Mapping, Optional

import numpy as np
import torch

from adt_str_tpu_torch import resolve_device
from adt_str_tpu_torch.clap.audio_model import ClapAudioArch, ClapAudioTower
from adt_str_tpu_torch.clap.features import MAX_SAMPLES, ClapFeatureExtractor, device_log_mel_db
from adt_str_tpu_torch.clap.text_model import ClapTextArch, ClapTextTower, get_text_features
from adt_str_tpu_torch.models.convert import read_safetensors, write_safetensors
from adt_str_tpu_torch.utils.misc import fp32_products

# HF's buffers that the towers derive from their shapes: a checkpoint may
# hold them or not, and the JAX params trees do not carry them
DERIVED_BUFFERS = ("position_ids", "token_type_ids", "relative_position_index", "num_batches_tracked")


def _derived(key: str) -> bool:
    return key.rsplit(".", 1)[-1] in DERIVED_BUFFERS


def load_clap_state_dict(model_dir: str | Path) -> dict[str, torch.Tensor]:
    """A local HF CLAP checkpoint directory -> {HF key: CPU tensor}."""
    model_dir = Path(model_dir)
    st = model_dir / "model.safetensors"
    if st.exists():
        return read_safetensors(st)
    bin_path = model_dir / "pytorch_model.bin"
    if bin_path.exists():
        return torch.load(str(bin_path), map_location="cpu", weights_only=True)
    raise FileNotFoundError(f"no model.safetensors / pytorch_model.bin in {model_dir}")


def load_tower(tower: torch.nn.Module, sd: Mapping) -> None:
    """Load `tower`'s HF keys from the checkpoint `sd` (numpy or torch
    values; other keys are ignored). Every parameter and running statistic
    must be there; the derived buffers keep the tower's own when absent."""
    own = tower.state_dict()
    missing = [k for k in own if k not in sd and not _derived(k)]
    if missing:
        raise KeyError(f"checkpoint lacks {len(missing)} keys of {type(tower).__name__}, e.g. {missing[:3]}")
    tower.load_state_dict({k: torch.as_tensor(np.asarray(sd[k])) for k in own if k in sd}, strict=False)


def archs_from_hf_config(model_dir: str | Path) -> tuple[ClapAudioArch, ClapTextArch]:
    """The tower architectures from the checkpoint directory's HF
    `config.json` (a transformers `ClapConfig` dump), so any local CLAP
    checkpoint loads: the full htsat-fused or a small one."""
    cfg = json.loads((Path(model_dir) / "config.json").read_text())
    a, t = cfg["audio_config"], cfg["text_config"]
    stride = a.get("patch_stride", [4, 4])
    audio = ClapAudioArch(
        window_size=a.get("window_size", 8),
        num_mel_bins=a.get("num_mel_bins", 64),
        spec_size=a.get("spec_size", 256),
        patch_size=a.get("patch_size", 4),
        patch_stride=stride[0] if isinstance(stride, (list, tuple)) else stride,
        hidden_size=a.get("hidden_size", 768),
        projection_dim=cfg.get("projection_dim", a.get("projection_dim", 512)),
        depths=tuple(a.get("depths", (2, 2, 6, 2))),
        num_heads=tuple(a.get("num_attention_heads", (4, 8, 16, 32))),
        patch_embeds_hidden_size=a.get("patch_embeds_hidden_size", 96),
        enable_fusion=a.get("enable_fusion", True),
        mlp_ratio=a.get("mlp_ratio", 4.0),
        aff_block_r=a.get("aff_block_r", 4),
        layer_norm_eps=a.get("layer_norm_eps", 1e-5),
    )
    text = ClapTextArch(
        vocab_size=t.get("vocab_size", 50265),
        hidden_size=t.get("hidden_size", 768),
        num_layers=t.get("num_hidden_layers", 12),
        num_heads=t.get("num_attention_heads", 12),
        intermediate_size=t.get("intermediate_size", 3072),
        max_positions=t.get("max_position_embeddings", 514),
        pad_token_id=t.get("pad_token_id", 1),
        layer_norm_eps=t.get("layer_norm_eps", 1e-12),
        projection_dim=cfg.get("projection_dim", t.get("projection_dim", 512)),
    )
    return audio, text


def hf_config(audio: ClapAudioArch, text: ClapTextArch) -> dict:
    """The `config.json` fields `archs_from_hf_config` reads, in HF's names."""
    return {
        "projection_dim": audio.projection_dim,
        "audio_config": {
            "window_size": audio.window_size, "num_mel_bins": audio.num_mel_bins, "spec_size": audio.spec_size,
            "patch_size": audio.patch_size, "patch_stride": [audio.patch_stride, audio.patch_stride],
            "hidden_size": audio.hidden_size, "depths": list(audio.depths),
            "num_attention_heads": list(audio.num_heads), "patch_embeds_hidden_size": audio.patch_embeds_hidden_size,
            "enable_fusion": audio.enable_fusion, "mlp_ratio": audio.mlp_ratio, "aff_block_r": audio.aff_block_r,
            "layer_norm_eps": audio.layer_norm_eps,
        },
        "text_config": {
            "vocab_size": text.vocab_size, "hidden_size": text.hidden_size, "num_hidden_layers": text.num_layers,
            "num_attention_heads": text.num_heads, "intermediate_size": text.intermediate_size,
            "max_position_embeddings": text.max_positions, "pad_token_id": text.pad_token_id,
            "layer_norm_eps": text.layer_norm_eps,
        },
    }


def random_state_dict(audio: ClapAudioArch, text: ClapTextArch, seed: int) -> dict[str, torch.Tensor]:
    """Seeded random weights in HF's key layout (the towers' parameters and
    running statistics, and `logit_scale_a`), made with numpy: weights
    N(0, 0.02) as HF initialises them, LayerNorm and BatchNorm scales near 1,
    running variances in [0.5, 1.5]. For tests and the smoke: no CLAP
    checkpoint is in the repo."""
    rng = np.random.default_rng(seed)
    sd: dict[str, torch.Tensor] = {}
    with torch.device("meta"):  # shapes only
        towers = (ClapAudioTower(audio), ClapTextTower(text))
    for tower in towers:
        for k, v in tower.state_dict().items():
            if _derived(k):
                continue
            leaf = k.rsplit(".", 1)[-1]
            if leaf == "running_var":
                x = 0.5 + rng.random(v.shape, dtype=np.float32)
            elif leaf == "weight" and v.dim() == 1:  # LayerNorm and BatchNorm scales
                x = 1 + np.float32(0.1) * rng.standard_normal(v.shape, dtype=np.float32)
            else:
                x = np.float32(0.02) * rng.standard_normal(v.shape, dtype=np.float32)
            sd[k] = torch.from_numpy(x)
    sd["logit_scale_a"] = torch.tensor(np.log(1 / 0.07), dtype=torch.float32)
    return sd


def save_checkpoint(model_dir: str | Path, sd: Mapping[str, torch.Tensor], audio: ClapAudioArch,
                    text: ClapTextArch) -> Path:
    """`config.json` + `model.safetensors` (the port's writer) in `model_dir`."""
    model_dir = Path(model_dir)
    model_dir.mkdir(parents=True, exist_ok=True)
    (model_dir / "config.json").write_text(json.dumps(hf_config(audio, text), indent=1))
    write_safetensors(dict(sd), model_dir / "model.safetensors")
    return model_dir


class ClapWrapper:
    """The port's CLAP encoder (the JAX package's `ClapWrapper`)."""

    @classmethod
    def from_dir(cls, model_dir: str | Path, sample_rate: int = 48_000, device=None, **kwargs) -> "ClapWrapper":
        """Load from a local HF checkpoint directory, with the tower shapes
        of its `config.json` when there is one (htsat-fused otherwise): the
        curation CLI's entry point."""
        if (Path(model_dir) / "config.json").exists():
            audio_arch, text_arch = archs_from_hf_config(model_dir)
            kwargs.setdefault("audio_arch", audio_arch)
            kwargs.setdefault("text_arch", text_arch)
        return cls(str(model_dir), sample_rate=sample_rate, device=device, **kwargs)

    def __init__(
        self,
        model_name_or_dir: str,
        sample_rate: int = 48_000,
        audio_arch: ClapAudioArch = ClapAudioArch(),
        text_arch: ClapTextArch = ClapTextArch(),
        rng: Optional[np.random.Generator] = None,
        state_dict: Optional[Mapping] = None,
        device=None,
    ):
        """`state_dict` stands in for the checkpoint directory (tests and
        the smoke run the real towers on seeded weights)."""
        self.device = resolve_device(device)
        sd = state_dict if state_dict is not None else load_clap_state_dict(model_name_or_dir)
        self.audio = ClapAudioTower(audio_arch)
        self.text = ClapTextTower(text_arch)
        for tower in (self.audio, self.text):
            load_tower(tower, sd)
            tower.to(self.device).eval()
        self.logit_scale_a = float(np.exp(float(np.asarray(sd["logit_scale_a"]))))
        self.audio_arch = audio_arch
        self.text_arch = text_arch
        self.sample_rate = sample_rate
        self.feature_extractor = ClapFeatureExtractor(rng=rng)
        # short clips take `device_log_mel_db` (K1) on a card, the host extractor on the CPU
        self.device_mel = self.device.type != "cpu"
        self._tokenizer = None
        self._model_dir = model_name_or_dir
        self._mesh_towers: Optional[tuple] = None  # (mesh key, {device: tower replica})

    # ------------------------------------------------------------------ audio

    def _towers_for(self, mesh) -> dict:
        """One audio tower a device of `mesh`'s local entries: the wrapper's
        own on its device, a copy elsewhere. Kept while the mesh's devices
        are the same (an equal mesh made anew reuses them)."""
        key = tuple(str(d) for d in mesh.devices)
        if self._mesh_towers is None or self._mesh_towers[0] != key:
            towers = {}
            for d in mesh.devices:
                if d not in towers:
                    towers[d] = self.audio if d == self.device else copy.deepcopy(self.audio).to(d).eval()
            self._mesh_towers = (key, towers)
        return self._mesh_towers[1]

    @staticmethod
    @fp32_products
    def _encode(tower: ClapAudioTower, device: torch.device, waves=None, feats=None, longer=None) -> torch.Tensor:
        """(rows, projection_dim) embeddings on `device`: from 10 s waves
        through K1 and the 4x view, or from host features. The tower's
        matmuls and convolutions are true fp32 (no TF32), as on the CPU."""
        with torch.no_grad():
            if waves is not None:
                mel = device_log_mel_db(torch.from_numpy(waves).to(device))  # (B, 1001, 64)
                mels = mel[:, None].expand(-1, 4, -1, -1)
                is_longer = torch.zeros(mel.shape[0], dtype=torch.bool, device=device)
            else:
                mels, is_longer = torch.from_numpy(feats).to(device), torch.from_numpy(longer).to(device)
            return tower(mels, is_longer)

    def get_audio_features(self, audios: list[np.ndarray], mesh=None) -> np.ndarray:
        """Mono 48 kHz waveforms -> (B, projection_dim) L2-normalised
        embeddings.

        Short clips on a card take the device-resident path (one wave upload,
        K1, the 4x view, the tower, all on the card); long clips and the CPU
        take the host extractor. With `mesh` (`parallel/mesh.py:DataMesh`)
        the rows are padded to a multiple of its local entries, and each
        entry encodes a contiguous run of them on its device with its own
        replica of the tower."""
        fx = self.feature_extractor
        arrays = [np.asarray(a).reshape(-1) for a in audios]
        if self.device_mel and not fx.replicate_hf_longer_quirk and all(len(a) <= MAX_SAMPLES for a in arrays):
            inputs = {"waves": np.stack([fx._pad_short(a) for a in arrays]).astype(np.float32)}
        else:
            feats, longer = fx(arrays)
            inputs = {"feats": feats, "longer": longer}
        if mesh is None:
            return self._encode(self.audio, self.device, **inputs).cpu().numpy()
        n = len(mesh.devices)
        pad = (-len(arrays)) % n
        if pad:
            inputs = {k: np.concatenate([v, np.zeros((pad, *v.shape[1:]), v.dtype)]) for k, v in inputs.items()}
        per = (len(arrays) + pad) // n
        towers = self._towers_for(mesh)
        outs = [self._encode(towers[d], d, **{k: v[i * per : (i + 1) * per] for k, v in inputs.items()})
                for i, d in enumerate(mesh.devices)]
        return torch.cat([o.cpu() for o in outs])[: len(arrays)].numpy()

    # ------------------------------------------------------------------- text

    def tokenize(self, texts: list[str]) -> tuple[np.ndarray, np.ndarray]:
        """RoBERTa tokenisation with the checkpoint directory's tokenizer
        files (needs `transformers`)."""
        if self._tokenizer is None:
            from transformers import AutoTokenizer

            self._tokenizer = AutoTokenizer.from_pretrained(self._model_dir)
        enc = self._tokenizer(texts, padding=True, truncation=True, return_tensors="np")
        return enc["input_ids"], enc["attention_mask"]

    def get_text_features(self, texts: list[str]) -> np.ndarray:
        input_ids, attention_mask = self.tokenize(texts)
        out = get_text_features(self.text, torch.as_tensor(input_ids),
                                torch.as_tensor(attention_mask, dtype=torch.float32))
        return out.cpu().numpy()

    # ------------------------------------------------------------------ match

    def semantic_match(self, audio_features: np.ndarray, text_features: np.ndarray) -> np.ndarray:
        """softmax(logit_scale_a * audio @ text^T) over the texts."""
        logits = self.logit_scale_a * (audio_features @ text_features.T)
        logits = logits - logits.max(axis=-1, keepdims=True)
        e = np.exp(logits)
        return e / e.sum(axis=-1, keepdims=True)
