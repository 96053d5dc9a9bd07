"""The port's model (`adt_str_tpu_torch.models`) against the JAX package's,
on the CPU: the weight bridge, `encode` and `decode_logits` with the kernel
flags off and on, and the reference-checkpoint loader.

The same JAX params are loaded into both sides; inputs are numpy arrays made
from a seed.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adt_str_tpu.config import ModelConfig as JModelConfig
from adt_str_tpu.models import adt as jadt
from adt_str_tpu.models import transformer as JT
from adt_str_tpu.models.torch_compat import params_to_torch_state_dict
from adt_str_tpu.ops.pallas_mel import pallas_log_mel
from adt_str_tpu.training.checkpoint import export_safetensors
from adt_str_tpu_torch.config import ModelConfig
from adt_str_tpu_torch.models import transformer as TT
from adt_str_tpu_torch.models.adt import ADTModel
from adt_str_tpu_torch.models.convert import (
    load_reference_checkpoint,
    read_safetensors,
    state_dict_from_jax_params,
)

SMALL = dict(sample_rate=4000, win_length=256, time_res=0.01, input_sec=0.64, enc_layers=2,
             dec_layers=2, nhead=2, d_query=16, dropout=0.0, tgt_vocab_size=40, n_mels=16,
             compute_dtype="float32", max_positions=64)
# flags on: head dim 128 so that the JAX routing takes the fused attention
FLAGS_ON = dict(SMALL, nhead=1, d_query=128, use_pallas_mel=True, use_flash_attention=True)


def build(kw, seed=0):
    """(JAX params, JAX config, port model, port config) on the same weights."""
    jcfg, tcfg = JModelConfig(**kw), ModelConfig(**kw)
    params = jadt.init_params(jax.random.PRNGKey(seed), jcfg)
    model = ADTModel(tcfg, device="cpu")
    model.load_state_dict(state_dict_from_jax_params(jax.tree.map(np.asarray, params)), strict=True)
    return params, jcfg, model, tcfg


def jax_flags_on_memory(params, cfg, wave):
    """JAX encoder memory with both kernels, assembled from the JAX package's
    own functions: `encode` itself skips the Pallas kernels on the CPU."""
    mel = pallas_log_mel(jnp.asarray(wave), jadt.mel_params(cfg), interpret=True)
    x = JT.linear(params["project_to_mel"], mel)
    x = JT.linear(params["encoder"]["dense"], x)
    x = x + jnp.asarray(JT.sinusoidal_positions(cfg.max_positions, cfg.d_model))[None, : x.shape[1]]
    for p in params["encoder"]["layers"]:
        x = JT.encoder_layer_forward(p, x, cfg.nhead, 0.0, None, False, use_flash=True)
    return JT.layer_norm(params["encoder"]["final_ln"], x)


def waves(cfg, n=2, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, cfg.chunk_samples)) * 0.3).astype(np.float32)


def test_state_dict_round_trip_is_bit_exact():
    params, _, model, _ = build(SMALL)
    ref = params_to_torch_state_dict(jax.tree.map(np.asarray, params))
    got = model.state_dict()
    assert list(got) and set(got) == set(ref)
    for k, v in ref.items():
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_seeded_init_matches_jax_distributions():
    """Same shapes and distributions as `adt.init_params` (not the same
    draws: torch.Generator and jax.random differ)."""
    kw = dict(SMALL, d_query=32)
    params, _, _, tcfg = build(kw)
    ref = params_to_torch_state_dict(jax.tree.map(np.asarray, params))
    a, b = ADTModel(tcfg, seed=1, device="cpu").state_dict(), ADTModel(tcfg, seed=1, device="cpu").state_dict()
    for k, v in ref.items():
        assert tuple(a[k].shape) == v.shape, k
        assert torch.equal(a[k], b[k]), k  # seeded: reproducible
        if v.size > 256:
            lo, hi = float(v.min()), float(v.max())
            assert abs(float(a[k].std()) - float(v.std())) < 0.1 * float(v.std()) + 1e-6, k
            assert lo - 0.05 * (hi - lo) <= float(a[k].min()) and float(a[k].max()) <= hi + 0.05 * (hi - lo), k


# fp32 compute on both sides: differences are fp32 summation order, well
# inside 1e-4 on LayerNorm-scaled activations and on the logits.
def test_encode_matches_jax():
    params, jcfg, model, tcfg = build(SMALL)
    w = waves(tcfg)
    ref = np.asarray(jadt.encode(params, jnp.asarray(w), jcfg))
    out = model.encode(torch.from_numpy(w)).detach().numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


def test_decode_logits_with_causal_and_padding_masks_matches_jax():
    params, jcfg, model, tcfg = build(SMALL)
    w = waves(tcfg)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, tcfg.tgt_vocab_size, size=(2, 9))
    lengths = np.array([9, 5])
    memory = jadt.encode(params, jnp.asarray(w), jcfg)
    jmask = JT.causal_mask_additive(9) + JT.padding_mask_additive(jnp.asarray(lengths), 9)
    ref = np.asarray(jadt.decode_logits(params, jnp.asarray(tokens), memory, jcfg, self_mask=jmask))
    tmask = TT.causal_mask_additive(9) + TT.padding_mask_additive(torch.from_numpy(lengths), 9)
    out = model.decode_logits(torch.from_numpy(tokens), torch.from_numpy(np.array(memory)), tmask)
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-4, rtol=0)


def test_flags_on_encode_matches_jax_kernels():
    """K1 and K5 on: the port's wrappers run their plain versions on the CPU;
    the JAX side runs the Pallas kernels in interpret mode. Both use the same
    bf16 DFT bases, so they agree to fp32 rounding."""
    params, jcfg, model, tcfg = build(FLAGS_ON)
    w = waves(tcfg)
    ref = np.asarray(jax_flags_on_memory(params, jcfg, w))
    out = model.encode(torch.from_numpy(w)).detach().numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


def test_load_reference_checkpoint(tmp_path):
    """safetensors written by the JAX package's exporter, and a torch
    `pytorch_model.bin`, both load into the port model with strict=True."""
    params, _, _, tcfg = build(SMALL, seed=3)
    export_safetensors(params, tmp_path / "model.safetensors")
    sd = load_reference_checkpoint(tmp_path, device="cpu")
    model = ADTModel(tcfg, device="cpu")
    model.load_state_dict(sd, strict=True)
    ref = params_to_torch_state_dict(jax.tree.map(np.asarray, params))
    for k, v in ref.items():
        np.testing.assert_array_equal(model.state_dict()[k].numpy(), v, err_msg=k)

    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    torch.save({"state_dict": {k: torch.from_numpy(v.copy()) for k, v in ref.items()}}, bin_dir / "pytorch_model.bin")
    sd_bin = load_reference_checkpoint(bin_dir, device="cpu")
    assert all(torch.equal(sd_bin[k], sd[k]) for k in sd)
    with pytest.raises(FileNotFoundError):
        load_reference_checkpoint(tmp_path / "missing", device="cpu")


def test_read_safetensors_rejects_truncated_file(tmp_path):
    bad = tmp_path / "model.safetensors"
    bad.write_bytes((1000).to_bytes(8, "little") + b"{}")
    with pytest.raises(ValueError, match="header"):
        read_safetensors(bad)
