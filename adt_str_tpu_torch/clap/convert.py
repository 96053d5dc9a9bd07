"""CLAP weights carried across: the JAX package's params trees -> the HF
state dict that the port's towers load.

`state_dict_from_jax_clap_params` inverts
`adt_str_tpu/clap/audio_model.py:audio_params_from_torch_state_dict` and
`adt_str_tpu/clap/text_model.py:text_params_from_torch_state_dict`: it
takes their trees with numpy leaves and gives back the HF keys, transposing
each linear weight (JAX stores (d_in, d_out), PyTorch (d_out, d_in)) and
the patch merging's reduction, keeping conv weights as they are, and naming
the BatchNorm statistics (`scale`, `bias`, `mean`, `var` -> `weight`,
`bias`, `running_mean`, `running_var`). The buffers the towers derive from
their shapes are not carried (`model.DERIVED_BUFFERS`).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def state_dict_from_jax_clap_params(audio_params: Mapping[str, Any], text_params: Mapping[str, Any],
                                    logit_scale_a) -> dict[str, torch.Tensor]:
    """JAX audio and text params trees (numpy leaves) and the raw
    `logit_scale_a` -> {HF key: CPU tensor}."""
    sd: dict[str, torch.Tensor] = {}

    def t(x) -> torch.Tensor:
        return torch.from_numpy(np.array(x, dtype=np.float32, order="C"))

    def lin(prefix, p):
        sd[f"{prefix}.weight"] = t(np.asarray(p["w"]).T)
        sd[f"{prefix}.bias"] = t(p["b"])

    def ln(prefix, p):
        sd[f"{prefix}.weight"] = t(p["scale"])
        sd[f"{prefix}.bias"] = t(p["bias"])

    def conv(prefix, p):
        sd[f"{prefix}.weight"] = t(p["w"])
        sd[f"{prefix}.bias"] = t(p["b"])

    def bn(prefix, p):
        ln(prefix, p)
        sd[f"{prefix}.running_mean"] = t(p["mean"])
        sd[f"{prefix}.running_var"] = t(p["var"])

    enc = "audio_model.audio_encoder"
    a = audio_params["audio_model"]
    bn(f"{enc}.batch_norm", a["batch_norm"])
    pe, ap = f"{enc}.patch_embed", a["patch_embed"]
    conv(f"{pe}.proj", ap["proj"])
    ln(f"{pe}.norm", ap["norm"])
    if "mel_conv2d" in ap:
        conv(f"{pe}.mel_conv2d", ap["mel_conv2d"])
        # nn.Sequential indices: local [0, 1, 3, 4]; global has the pool at 0
        for branch, idx in (("local_att", (0, 1, 3, 4)), ("global_att", (1, 2, 4, 5))):
            bp, p = f"{pe}.fusion_model.{branch}", ap["fusion_model"][branch]
            conv(f"{bp}.{idx[0]}", p["conv1"])
            bn(f"{bp}.{idx[1]}", p["bn1"])
            conv(f"{bp}.{idx[2]}", p["conv2"])
            bn(f"{bp}.{idx[3]}", p["bn2"])
    for si, stage in enumerate(a["stages"]):
        sp = f"{enc}.layers.{si}"
        for li, blk in enumerate(stage["blocks"]):
            bp = f"{sp}.blocks.{li}"
            ln(f"{bp}.layernorm_before", blk["layernorm_before"])
            ln(f"{bp}.layernorm_after", blk["layernorm_after"])
            att = blk["attention"]
            for name in ("query", "key", "value"):
                lin(f"{bp}.attention.self.{name}", att[name])
            sd[f"{bp}.attention.self.relative_position_bias_table"] = t(att["relative_position_bias_table"])
            lin(f"{bp}.attention.output.dense", att["output"])
            lin(f"{bp}.intermediate.dense", blk["intermediate"])
            lin(f"{bp}.output.dense", blk["output"])
        if stage.get("downsample") is not None:
            ln(f"{sp}.downsample.norm", stage["downsample"]["norm"])
            sd[f"{sp}.downsample.reduction.weight"] = t(np.asarray(stage["downsample"]["reduction_w"]).T)
    ln(f"{enc}.norm", a["norm"])
    lin("audio_projection.linear1", audio_params["audio_projection"]["linear1"])
    lin("audio_projection.linear2", audio_params["audio_projection"]["linear2"])

    tm = text_params["text_model"]
    emb = tm["embeddings"]
    for name in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
        sd[f"text_model.embeddings.{name}.weight"] = t(emb[name])
    ln("text_model.embeddings.LayerNorm", emb["LayerNorm"])
    for i, layer in enumerate(tm["layers"]):
        lp = f"text_model.encoder.layer.{i}"
        for name in ("query", "key", "value"):
            lin(f"{lp}.attention.self.{name}", layer[name])
        lin(f"{lp}.attention.output.dense", layer["attn_out"])
        ln(f"{lp}.attention.output.LayerNorm", layer["attn_out_ln"])
        lin(f"{lp}.intermediate.dense", layer["intermediate"])
        lin(f"{lp}.output.dense", layer["output"])
        ln(f"{lp}.output.LayerNorm", layer["out_ln"])
    lin("text_model.pooler.dense", tm["pooler"])
    lin("text_projection.linear1", text_params["text_projection"]["linear1"])
    lin("text_projection.linear2", text_params["text_projection"]["linear2"])
    sd["logit_scale_a"] = t(logit_scale_a)
    return sd
