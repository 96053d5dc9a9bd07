"""The port's serving export (`adt_str_tpu_torch/scripts/export_serving.py`)
against the JAX package's (`tools/export_serving.py`), on the CPU.

- the saved and loaded artifact's tokens equal the port's `greedy_decode`
  and JAX's round-tripped artifact on `tests/test_export_serving.py`'s tiny
  fp32 config with JAX's `init_params` carried over;
- a config with both kernel flags on (K1 and K5f in the encoder) exports
  and serves the same tokens as the eager decode;
- the symbolic batch serves 1 and 4 rows (slow, as JAX's);
- the bytes run in a fresh process that imports only `torch` and
  `adt_str_tpu_torch.ops`, after the model is gone;
- the CLI writes the artifact and `meta.json` with JAX's keys, and checks;
- the graph calls the `adt_str_tpu_torch::` ops, holds a `while_loop` and
  casts nothing in the loop body;
- each custom op runs its plain version on CPU tensors, bit for bit,
  without a launch, and its fake gives the real output's shape and dtype,
  at a symbolic batch too.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from adt_str_tpu.models import adt as jadt
from adt_str_tpu_torch.config import ModelConfig
from adt_str_tpu_torch.models import decode as tdecode
from adt_str_tpu_torch.models.adt import ADTModel
from adt_str_tpu_torch.models.convert import state_dict_from_jax_params, write_safetensors
from adt_str_tpu_torch.ops import attention_rows, cuda_attention, cuda_mel, op_wrappers
from adt_str_tpu_torch.ops import layer_norm as ln_ops
from adt_str_tpu_torch.ops import linear as linear_ops
from adt_str_tpu_torch.ops.mel import MelFrontendParams
from adt_str_tpu_torch.scripts import export_serving as texport
from test_export_serving import tiny_config

REPO = Path(__file__).resolve().parent.parent
OPS = torch.ops.adt_str_tpu_torch
FLAGS_ON = dict(nhead=1, d_query=128, use_pallas_mel=True, use_flash_attention=True)
CAST_OPS = {torch.ops.aten._to_copy.default, torch.ops.aten.to.dtype, torch.ops.aten.to.dtype_layout,
            torch.ops.prims.convert_element_type.default}


def _setup(**kw):
    """`tests/test_export_serving.py`'s `_setup` with the port's model beside
    JAX's params (its tiny config, `init_params(PRNGKey(0))`, three waves)."""
    jcfg = tiny_config(**kw)
    params = jadt.init_params(jax.random.PRNGKey(0), jcfg)
    model = ADTModel(ModelConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}), device="cpu")
    model.load_state_dict(state_dict_from_jax_params(jax.tree.map(np.asarray, params)), strict=True)
    rng = np.random.default_rng(1)
    wavs = (rng.normal(size=(3, jcfg.chunk_samples)) * 0.1).astype(np.float32)
    return jcfg, params, model, wavs


def _round_trip(exported):
    return texport.from_bytes(texport.to_bytes(exported))


def test_artifact_tokens_equal_greedy_decode_and_jax_artifact():
    from jax import export as jexport

    from tools.export_serving import build_exported as jax_build_exported

    jcfg, params, model, wavs = _setup()
    got = _round_trip(texport.build_exported(model, max_length=12, batch_size=3))(torch.from_numpy(wavs))
    want = tdecode.greedy_decode(model, torch.from_numpy(wavs), max_length=12)
    jax_artifact = jexport.deserialize(jax_build_exported(params, jcfg, max_length=12, batch_size=3).serialize())
    ref = np.asarray(jax_artifact.call(jnp.asarray(wavs)))
    assert got.shape == (3, 12) and got.dtype == torch.int32
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (got[:, 0] == 2).all()


def test_artifact_with_the_kernel_flags_on_equals_greedy_decode():
    """K1 and K5f (head dim 128) in the encoder: their ops run the plain versions here."""
    _, _, model, wavs = _setup(**FLAGS_ON)
    exported = texport.build_exported(model, max_length=12, batch_size=3)
    targets = {str(n.target) for n in exported.graph.nodes if n.op == "call_function"}
    assert {"adt_str_tpu_torch.log_mel.default", "adt_str_tpu_torch.fused_attention_tf32.default"} <= targets
    got = _round_trip(exported)(torch.from_numpy(wavs))
    assert torch.equal(got, tdecode.greedy_decode(model, torch.from_numpy(wavs), max_length=12))


@pytest.mark.slow
def test_poly_batch_export_serves_multiple_batch_sizes():
    _, _, model, _ = _setup()
    program = _round_trip(texport.build_exported(model, max_length=10, batch_size=None))
    rng = np.random.default_rng(2)
    for b in (1, 4):
        wavs = torch.from_numpy((rng.normal(size=(b, model.config.chunk_samples)) * 0.1).astype(np.float32))
        assert torch.equal(program(wavs), tdecode.greedy_decode(model, wavs, max_length=10))


def test_artifact_runs_from_its_bytes_with_only_the_ops_imported(tmp_path):
    """The saved bytes alone, after the model is deleted, in a process that
    imports `torch` and `adt_str_tpu_torch.ops` and nothing else of the port."""
    _, _, model, wavs = _setup()
    blob = texport.to_bytes(texport.build_exported(model, max_length=8, batch_size=3))
    want = tdecode.greedy_decode(model, torch.from_numpy(wavs), max_length=8)
    del model
    (tmp_path / "a.pt2").write_bytes(blob)
    np.save(tmp_path / "wavs.npy", wavs)
    code = (
        "import sys, numpy as np, torch\n"
        "import adt_str_tpu_torch.ops\n"
        f"program = torch.export.load({str(tmp_path / 'a.pt2')!r}).module()\n"
        f"out = program(torch.from_numpy(np.load({str(tmp_path / 'wavs.npy')!r})))\n"
        f"np.save({str(tmp_path / 'out.npy')!r}, out.numpy())\n"
        "port = sorted(m for m in sys.modules if m.startswith('adt_str_tpu'))\n"
        "assert all(m == 'adt_str_tpu_torch' or m.startswith('adt_str_tpu_torch.ops') for m in port), port\n"
        "assert 'jax' not in sys.modules\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = np.load(tmp_path / "out.npy")
    assert len(blob) > 1000 and out.shape == (3, 8) and out.dtype == np.int32
    np.testing.assert_array_equal(out, want.numpy())


def _cli_config(tmp_path, model) -> Path:
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    write_safetensors(model.state_dict(), ckpt / "model.safetensors")
    cfg = model.config
    raw = {"shared": {"sample_rate": cfg.sample_rate, "input_sec": cfg.input_sec, "time_res": cfg.time_res,
                      "win_length": cfg.win_length},
           "model": {k: getattr(cfg, k) for k in ("enc_layers", "dec_layers", "nhead", "d_query", "dropout",
                                                  "tgt_vocab_size", "n_mels", "compute_dtype", "max_positions")},
           "tokenizer": {"BOS_token": 2, "EOS_token": 3, "pad_token": 1},
           "inference": {"checkpoint_path": str(ckpt), "max_length": 12}}
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(raw))
    return path


def test_cli_writes_the_artifact_and_jax_meta_and_checks(tmp_path):
    _, _, model, _ = _setup()
    cfg = _cli_config(tmp_path, model)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-m", "adt_str_tpu_torch.scripts.export_serving", str(cfg), "--out",
                           str(tmp_path / "out"), "--batch", "3", "--device", "cpu", "--check"], cwd=tmp_path,
                          env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "check OK" in proc.stdout
    meta = json.loads((tmp_path / "out" / "meta.json").read_text())
    assert (tmp_path / "out" / meta["artifact"]).stat().st_size > 1000
    assert meta["artifact"] == "transcribe_greedy.pt2" and meta["platforms"] == ["cpu"]
    assert meta["torch_version"] == torch.__version__ and "import adt_str_tpu_torch.ops" in meta["requires"]
    assert meta["input"] == {"shape": [3, model.config.chunk_samples], "dtype": "float32",
                             "sample_rate": model.config.sample_rate, "seconds_per_chunk": model.config.input_sec}
    assert meta["output"] == {"shape": [3, 12], "dtype": "int32", "bos_token": 2, "eos_token": 3, "pad_token": 1,
                              "vocab_size": model.config.tgt_vocab_size}
    jax_keys = {"artifact", "input", "output", "platforms", "jax_version", "checkpoint"}
    assert set(meta) == jax_keys - {"jax_version"} | {"torch_version", "requires"}
    assert meta["checkpoint"] == str(tmp_path / "ckpt")
    # without CUDA and without --device it raises, and never falls back to the CPU
    proc = subprocess.run([sys.executable, "-m", "adt_str_tpu_torch.scripts.export_serving", str(cfg), "--out",
                           str(tmp_path / "none")], cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "no CUDA device is available" in proc.stderr


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_graph_calls_the_ops_in_a_while_loop_and_casts_nothing_in_its_body(compute_dtype):
    _, _, model, _ = _setup(compute_dtype=compute_dtype)
    gm = texport.build_exported(model, max_length=8, batch_size=3).graph_module
    loops = [n for n in gm.graph.nodes if n.op == "call_function" and n.target is torch.ops.higher_order.while_loop]
    assert len(loops) == 1
    body = getattr(gm, loops[0].args[1].target)
    targets = [n.target for n in body.graph.nodes if n.op == "call_function"]
    kernels = {str(t) for t in targets if str(t).startswith("adt_str_tpu_torch.")}
    assert kernels == {"adt_str_tpu_torch.linear.default", "adt_str_tpu_torch.add_layer_norm.default",
                       "adt_str_tpu_torch.attention_rows_split.default" if compute_dtype == "float32"
                       else "adt_str_tpu_torch.attention_rows.default"}
    assert not [t for t in targets if t in CAST_OPS]
    assert torch.ops.aten.index_copy.default in targets  # the functional cache writes


MEL = MelFrontendParams(4000, 256, 40, 16)


def _op_cases() -> dict:
    """Each op's CPU arguments (batch 3 first) and its plain version."""
    g = torch.Generator().manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, generator=g)

    x, w, b = rand(3, 1, 16), rand(24, 16), rand(24)
    lw, lb = rand(16), rand(16)
    q, kv = rand(3, 2, 1, 16), rand(3, 2, 12, 16)
    mask = attention_rows.keys_mask(None, 5, 12, x.device)
    qa, ka = rand(3, 1, 10, 128), rand(3, 1, 14, 128)
    wave = rand(3, 2560)
    cases = {
        "linear": ((x, w, b), lambda: linear_ops.linear_plain(x, w, b)),
        "layer_norm": ((x, lw, lb, 1e-5), lambda: ln_ops.layer_norm_plain(x, lw, lb, 1e-5)),
        "add_layer_norm": ((x, x.flip(0), lw, lb, 1e-5), lambda: ln_ops.add_layer_norm_plain(x, x.flip(0), lw, lb, 1e-5)),
        "attention_rows": ((q, kv, kv, mask), lambda: attention_rows.attention_plain(q, kv, kv, None, 5)),
        "attention_rows_split": ((q, kv, kv, None), lambda: attention_rows.attention_plain(q, kv, kv, None)),
    }
    for name in ("fused_attention", "fused_attention_d256", "fused_attention_tf32", "fused_attention_wide"):
        cases[name] = ((qa, ka, ka, None, 2), lambda: cuda_attention.attention_plain(qa, ka, ka, None, 2))
    for name, hop in (("log_mel", 40), ("log_mel_any_hop", 41), ("log_mel_long_hop", 40)):
        p = dataclasses.replace(MEL, hop_length=hop)
        cases[name] = ((wave, *dataclasses.astuple(p), True), lambda p=p: cuda_mel.log_mel_plain(wave, p))
    return cases


def _launches() -> list:
    return [f.launches for f in op_wrappers().values()]


def test_every_kernel_of_the_decode_path_is_a_registered_op():
    names = {n for n in dir(OPS) if not n.startswith("_") and n != "name"}
    assert names == set(_op_cases()) == set(op_wrappers())


@pytest.mark.parametrize("name", sorted(_op_cases()))
def test_op_runs_the_plain_version_on_cpu_and_its_fake_gives_the_shapes(name):
    args, plain = _op_cases()[name]
    op = getattr(OPS, name)
    before = _launches()
    got, ref = op(*args), plain()
    assert _launches() == before
    got, ref = (got, ref) if isinstance(got, tuple) else ((got,), (ref,))
    assert all(torch.equal(a, r) for a, r in zip(got, ref)) and len(got) == len(ref)
    torch.library.opcheck(op, args)  # the fake's shapes, dtypes and strides against the real outputs'
    # at a symbolic batch: the fake's outputs carry the inputs' batch symbol
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.symbolic_shapes import DimDynamic, ShapeEnv, StatelessSymbolicContext

    mode = FakeTensorMode(shape_env=ShapeEnv())

    def fake(a):
        if not isinstance(a, torch.Tensor):
            return a
        dims = [DimDynamic.DYNAMIC if i == 0 and a.shape[0] == 3 else DimDynamic.STATIC for i in range(a.dim())]
        return mode.from_tensor(a, symbolic_context=StatelessSymbolicContext(dynamic_sizes=dims))

    fake_args = [fake(a) for a in args]
    with mode:
        outs = getattr(op, "default")(*fake_args)
    outs = outs if isinstance(outs, tuple) else (outs,)
    batch = fake_args[0].shape[0]
    assert isinstance(batch, torch.SymInt)
    for o, r in zip(outs, ref):
        assert o.dtype == r.dtype and str(o.shape[0]) == str(batch) and tuple(o.shape[1:]) == tuple(r.shape[1:])
