"""The port's checkpoints on the CPU: save/restore round trip, GC by mtime,
`latest_checkpoint`, overwrite of a step, the `meta.json` fallback, the
reference-named `model.safetensors` (read by the safetensors package and by
the JAX package's loader), and `config.remat` in training (the same loss
and gradients as without it)."""

import json
import os
import time

import jax
import numpy as np
import pytest
import torch

from adt_str_tpu.training.checkpoint import load_params_from_reference_checkpoint
from adt_str_tpu_torch.config import ModelConfig, TrainingConfig
from adt_str_tpu_torch.models.adt import ADTModel, draw_site_keys
from adt_str_tpu_torch.models.convert import read_safetensors, state_dict_from_jax_params, write_safetensors
from adt_str_tpu_torch.training import checkpoint as ckpt
from adt_str_tpu_torch.training.optimizer import make_optimizer

TINY = dict(input_sec=0.64, time_res=0.01, win_length=256, sample_rate=4000, enc_layers=1, dec_layers=2, nhead=2,
            d_query=16, dropout=0.1, tgt_vocab_size=1400, n_mels=16, compute_dtype="float32", max_positions=64)


def trained_state(accum=1, skip_nonfinite=0, steps=2):
    """A tiny model and its optimizer state after `steps` updates (every
    OptState field populated)."""
    model = ADTModel(ModelConfig(**TINY), seed=1, device="cpu")
    opt, _ = make_optimizer(TrainingConfig(gradient_accumulation_steps=accum, skip_nonfinite_updates=skip_nonfinite,
                                           warmup_ratio=0.0), total_steps=10, model=model)
    state = opt.init(dict(model.named_parameters()))
    gen = torch.Generator().manual_seed(0)
    for _ in range(steps):
        params = dict(model.named_parameters())
        grads = {n: torch.randn(p.shape, generator=gen) for n, p in params.items()}
        updates, state = opt.update(grads, state, params)
        with torch.no_grad():
            for n, p in params.items():
                p.add_(updates[n])
    return model, state


@pytest.mark.parametrize("accum,skip", [(1, 0), (2, 3)], ids=["plain", "accumulation+guard"])
def test_save_restore_round_trip(tmp_path, accum, skip):
    model, opt_state = trained_state(accum, skip, steps=3)
    path = ckpt.save_checkpoint(tmp_path, model, opt_state, step=7, epoch=2)
    assert path.endswith("checkpoint-epoch-2-step-7")
    assert sorted(os.listdir(path)) == ["meta.json", "model.safetensors", "state.pt"]
    assert json.loads(open(os.path.join(path, "meta.json")).read()) == {"step": 7, "epoch": 2}
    fresh = ADTModel(ModelConfig(**TINY), seed=99, device="cpu")
    restored, step, epoch = ckpt.restore_checkpoint(path, fresh)
    assert (step, epoch) == (7, 2)
    for (n, a), (_, b) in zip(model.state_dict().items(), fresh.state_dict().items()):
        assert torch.equal(a, b), n
    for field in ("count", "mini_step", "notfinite_count", "total_notfinite"):
        assert getattr(restored, field) == getattr(opt_state, field)
    for field in ("mu", "nu", "acc"):
        got, want = getattr(restored, field), getattr(opt_state, field)
        assert sorted(got) == sorted(want)
        assert all(torch.equal(got[n], want[n]) for n in want), field


def test_gc_latest_and_overwrite(tmp_path):
    model, opt_state = trained_state()
    for s in (1, 2, 3):
        ckpt.save_checkpoint(tmp_path, model, opt_state, step=s, max_checkpoints=2)
        time.sleep(0.05)
    assert sorted(p.name for p in tmp_path.glob("checkpoint-*")) == ["checkpoint-epoch-0-step-2",
                                                                      "checkpoint-epoch-0-step-3"]
    assert ckpt.latest_checkpoint(tmp_path).endswith("checkpoint-epoch-0-step-3")
    assert ckpt.latest_checkpoint(tmp_path / "nowhere") is None
    # a second save of a step overwrites it (a resume from an older checkpoint re-reaches it)
    path = ckpt.save_checkpoint(tmp_path, model, opt_state, step=2)
    time.sleep(0.05)
    assert ckpt.latest_checkpoint(tmp_path) == path
    assert not list(tmp_path.rglob("*.tmp"))
    ckpt.gc_checkpoints(tmp_path, 1)
    assert [p.name for p in tmp_path.glob("checkpoint-*")] == ["checkpoint-epoch-0-step-2"]


def test_meta_json_fallback(tmp_path):
    model, opt_state = trained_state()
    path = ckpt.save_checkpoint(tmp_path, model, opt_state, step=5, epoch=1)
    os.unlink(os.path.join(path, "meta.json"))
    _, step, epoch = ckpt.restore_checkpoint(path, ADTModel(ModelConfig(**TINY), device="cpu"))
    assert (step, epoch) == (5, 1)
    odd = tmp_path / "odd"
    os.rename(path, odd)
    with pytest.raises(FileNotFoundError, match="naming"):
        ckpt.restore_checkpoint(odd, ADTModel(ModelConfig(**TINY), device="cpu"))


def test_safetensors_loads_in_the_safetensors_package_and_in_jax(tmp_path):
    """model.safetensors holds the model in the reference naming: equal
    through `safetensors.numpy`, through the port's reader, and through the
    JAX package's loader (whose params convert back to the same state dict)."""
    from safetensors.numpy import load_file

    model, opt_state = trained_state()
    path = ckpt.save_checkpoint(tmp_path, model, opt_state, step=1)
    sd = model.state_dict()
    st = load_file(os.path.join(path, "model.safetensors"))
    assert sorted(st) == sorted(sd)
    for n, t in sd.items():
        np.testing.assert_array_equal(st[n], t.numpy(), err_msg=n)
    own = read_safetensors(os.path.join(path, "model.safetensors"))
    assert all(torch.equal(own[n], t) for n, t in sd.items())
    params = load_params_from_reference_checkpoint(path)
    back = state_dict_from_jax_params(jax.tree.map(np.asarray, params))
    assert sorted(back) == sorted(sd)
    assert all(torch.equal(back[n], t) for n, t in sd.items())


def test_safetensors_writer_dtypes(tmp_path):
    """bf16 (through its int16 view), f16, ints, bools, scalars and empty
    tensors round-trip through the safetensors package's torch loader and
    the port's reader; the header is 8-byte aligned."""
    from safetensors.torch import load_file

    g = torch.Generator().manual_seed(0)
    tensors = {"bf16": torch.randn(3, 5, generator=g).to(torch.bfloat16), "f16": torch.randn(7, generator=g).half(),
               "f32": torch.randn(2, 2, 2, generator=g), "i64": torch.arange(-3, 3), "i8": torch.tensor([-1, 2], dtype=torch.int8),
               "bool": torch.tensor([True, False, True]), "scalar": torch.tensor(2.5), "empty": torch.zeros(0, 4)}
    path = tmp_path / "x.safetensors"
    write_safetensors(tensors, path)
    raw = path.read_bytes()
    assert int.from_bytes(raw[:8], "little") % 8 == 0
    for loaded in (load_file(str(path)), read_safetensors(path)):
        assert sorted(loaded) == sorted(tensors)
        for n, t in tensors.items():
            assert loaded[n].dtype == t.dtype and torch.equal(loaded[n], t), n


def test_remat_gives_the_same_loss_and_gradients():
    """config.remat recomputes each layer in the backward pass: at fp32 with
    dropout 0.1 and its keys as data, loss and gradients equal remat off."""
    g = torch.Generator().manual_seed(0)
    wave = torch.randn(3, 2560, generator=g) * 0.3
    tokens = torch.randint(4, 600, (3, 12), generator=g)
    tokens[:, 0] = 2
    lengths = torch.tensor([12, 7, 9])
    out = {}
    for remat in (False, True):
        model = ADTModel(ModelConfig(**TINY, remat=remat), seed=3, device="cpu")
        keys = draw_site_keys(model.config, torch.Generator().manual_seed(5))
        loss = model.forward_loss(wave, tokens, lengths - 1, keys=keys, train=True)
        names, params = zip(*model.named_parameters())
        out[remat] = (loss.detach(), dict(zip(names, torch.autograd.grad(loss, params))))
    (l0, g0), (l1, g1) = out[False], out[True]
    assert abs(float(l0) - float(l1)) <= 1e-6 * abs(float(l0))
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], rtol=0, atol=1e-6, msg=n)
    assert any(float(g.abs().max()) > 0 for g in g0.values())
