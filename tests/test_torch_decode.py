"""The port's greedy KV-cache decode against the JAX package's, on the CPU:
tokens must be equal on the same weights, with the kernel flags off and on.

The config is the tiny one of `tests/test_serving.py` with the generator
scaled by 4 so that greedy emits varied tokens.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adt_str_tpu.config import ModelConfig as JModelConfig
from adt_str_tpu.models import adt as jadt
from adt_str_tpu.models import decode as jdecode
from adt_str_tpu_torch.config import ModelConfig
from adt_str_tpu_torch.models import decode as tdecode
from adt_str_tpu_torch.models.adt import ADTModel
from adt_str_tpu_torch.models.convert import state_dict_from_jax_params
from test_torch_model import jax_flags_on_memory

SERVING_TINY = dict(input_sec=0.64, time_res=0.01, win_length=256, sample_rate=4000, enc_layers=1,
                    dec_layers=1, nhead=2, d_query=16, dropout=0.0, tgt_vocab_size=1400, n_mels=16,
                    compute_dtype="float32", max_positions=64)
FLAGS_ON = dict(SERVING_TINY, nhead=1, d_query=128, use_pallas_mel=True, use_flash_attention=True)
MAX_LEN = 16


def build(kw, eos_bias=0.0):
    jcfg, tcfg = JModelConfig(**kw), ModelConfig(**kw)
    params = jadt.init_params(jax.random.PRNGKey(2), jcfg)
    params["decoder"]["generator"]["w"] = params["decoder"]["generator"]["w"] * 4.0
    params["decoder"]["generator"]["b"] = params["decoder"]["generator"]["b"].at[3].add(eos_bias)
    model = ADTModel(tcfg, device="cpu")
    model.load_state_dict(state_dict_from_jax_params(jax.tree.map(np.asarray, params)), strict=True)
    return params, jcfg, model


def waves(cfg, n=3, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, cfg.chunk_samples)) * 0.3).astype(np.float32)


@pytest.mark.parametrize("eos_bias", [0.0, 3.0], ids=["long", "early-eos"])
def test_greedy_tokens_equal_jax(eos_bias):
    params, jcfg, model = build(SERVING_TINY, eos_bias)
    w = waves(jcfg)
    ref = np.asarray(jdecode.greedy_decode(params, jnp.asarray(w), jcfg, max_length=MAX_LEN))
    out = tdecode.greedy_decode(model, torch.from_numpy(w), max_length=MAX_LEN)
    assert out.dtype == torch.int32 and out.shape == (3, MAX_LEN)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert (out[:, 0] == 2).all()
    if eos_bias:  # rows froze at EOS: the early-exit and EOS-fill paths ran
        assert (out[:, -1] == 3).all() and (out[:, 1:] != 3).any()


def test_greedy_tokens_equal_jax_with_kernels():
    """Flags on: the JAX side decodes from the memory its Pallas kernels
    (interpret mode) produce; the port runs its kernels' plain versions."""
    params, jcfg, model = build(FLAGS_ON)
    w = waves(jcfg)
    memory = jax_flags_on_memory(params, jcfg, w)
    ref = np.asarray(jdecode.greedy_decode_from_memory(params, memory, jcfg, MAX_LEN))
    out = tdecode.greedy_decode(model, torch.from_numpy(w), max_length=MAX_LEN)
    np.testing.assert_array_equal(out.numpy(), ref)
