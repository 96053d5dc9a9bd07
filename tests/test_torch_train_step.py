"""The port's training slice against the JAX package's, on the CPU:
`forward_loss` in train mode and its gradients, the schedules, decay mask,
AdamW, accumulation and the non-finite guard, and whole train steps.

Both sides compute in fp32 on the same weights (`state_dict_from_jax_params`)
and inputs made with numpy from a seed. Dropout keys are replayed: the JAX
rng's split tree is walked (`jax_site_keys`) and its `key_data` handed to the
port as the (n_sites, 2) key words, so both sides draw the same masks.

Configurations: `plain` has every kernel flag off; `fused-ffn` and `flash`
turn on the K4 and K5 flags of the two training configurations, so the
port runs the kernels' plain versions (and K5's backward) on the CPU, while
JAX's `forward_loss` takes its XLA path on the CPU (it skips Pallas there).
The two agree by design: the masks are bit-identical and the kernels compute
the XLA path's function (K4 with a 1.5e-7 erf). K1 stays off: its bf16 DFT
bases differ from the XLA rfft path by design (`test_torch_mel.py` holds it
against the Pallas kernel), and no gradient flows into the wave.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from adt_str_tpu.config import FrameworkConfig as JFrameworkConfig
from adt_str_tpu.config import ModelConfig as JModelConfig
from adt_str_tpu.config import TrainingConfig as JTrainingConfig
from adt_str_tpu.models import adt as jadt
from adt_str_tpu.parallel import train_step as jstep
from adt_str_tpu.training import optimizer as jopt
from adt_str_tpu_torch.config import FrameworkConfig, ModelConfig, TrainingConfig
from adt_str_tpu_torch.models import adt as tadt
from adt_str_tpu_torch.models.adt import ADTModel
from adt_str_tpu_torch.models.convert import state_dict_from_jax_params
from adt_str_tpu_torch.parallel import train_step as tstep
from adt_str_tpu_torch.training import optimizer as topt

REPO = Path(__file__).resolve().parent.parent
BASE = dict(sample_rate=4000, win_length=256, time_res=0.01, input_sec=0.64, enc_layers=2, dec_layers=2,
            nhead=1, d_query=128, tgt_vocab_size=40, n_mels=16, compute_dtype="float32", max_positions=64)
CONFIGS = {
    "plain": dict(BASE, dropout=0.1),
    "fused-ffn": dict(BASE, dropout=0.1, use_pallas_ffn=True),
    "flash": dict(BASE, dropout=0.0, use_flash_attention=True),
}

# Tolerances (fp32 on both sides, other summation orders; K4's erf differs by
# at most 1.5e-7): the loss to 2e-6 relative; each gradient to 1e-4 of its
# own largest element plus 1e-6 absolute.
LOSS_RTOL = 2e-6


def assert_grads_close(got: dict, ref: dict) -> None:
    assert set(got) == set(ref)
    for name, r in ref.items():
        g = got[name].detach().numpy()
        r = np.asarray(r)
        assert g.shape == r.shape, name
        np.testing.assert_allclose(g, r, atol=1e-4 * np.abs(r).max() + 1e-6, rtol=0, err_msg=name)


def jax_site_keys(rng, cfg) -> np.ndarray:
    """The key words of every dropout site, walking JAX's split tree in
    `forward_loss` -> `encode` / `decode_logits` -> layer order."""
    k_enc, k_dec = jax.random.split(rng)
    enc = jax.random.split(k_enc, cfg.enc_layers + 2)
    dec = jax.random.split(k_dec, cfg.dec_layers + 1)
    keys = [enc[0], *[k for i in range(cfg.enc_layers) for k in jax.random.split(enc[1 + i], 4)], enc[-1], dec[0],
            *[k for i in range(cfg.dec_layers) for k in jax.random.split(dec[1 + i], 6)]]
    return np.stack([np.asarray(jax.random.key_data(k)).reshape(-1) for k in keys]).astype(np.int64)


def build(kw, seed=0):
    jcfg, tcfg = JModelConfig(**kw), ModelConfig(**kw)
    params = jadt.init_params(jax.random.PRNGKey(seed), jcfg)
    model = ADTModel(tcfg, device="cpu")
    model.load_state_dict(state_dict_from_jax_params(jax.tree.map(np.asarray, params)), strict=True)
    return params, jcfg, model, tcfg


def make_batch(cfg, B=3, T=24, seed=0):
    """Numpy batch: ragged token rows (BOS, tokens, EOS, PAD...), collated lengths."""
    rng = np.random.default_rng(seed)
    wave = (rng.normal(size=(B, cfg.chunk_samples)) * 0.3).astype(np.float32)
    tokens = np.full((B, T), 1, dtype=np.int32)
    tokens[:, 0] = 2
    for i in range(B):
        n = int(rng.integers(T // 2, T - 1)) if i else T - 1
        tokens[i, 1:n] = rng.integers(4, cfg.tgt_vocab_size, n - 1)
        tokens[i, n] = 3
    lengths = (tokens != 1).sum(axis=1).astype(np.int32)
    lengths = lengths - (lengths == lengths.max())
    return {"wavs": wave, "tokens": tokens, "token_lengths": lengths.astype(np.int32)}


def jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def tbatch(b):
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32 else v) for k, v in b.items()}


def test_dropout_sites_follow_the_jax_split_tree():
    cfg = ModelConfig()
    sites = tadt.dropout_sites(cfg)
    assert len(sites) == len(set(sites)) == 43
    assert sites[0] == "encoder.input" and sites[17] == "encoder.output" and sites[18] == "decoder.input"
    assert sites[1:5] == [f"encoder.layers.0.{s}" for s in tadt.ENCODER_LAYER_SITES]
    keys = tadt.draw_site_keys(cfg, torch.Generator().manual_seed(0))
    assert keys.shape == (43, 2) and keys.dtype == torch.int64
    assert 0 <= int(keys.min()) and int(keys.max()) < 2**32
    assert jax_site_keys(jax.random.PRNGKey(0), JModelConfig()).shape == (43, 2)


@pytest.fixture(scope="module")
def jax_reference():
    """`get(dropout)`: JAX's train-mode loss and gradients (port names) and
    its eval loss on `make_batch`, computed once per dropout rate. JAX's
    encode and decode skip every Pallas kernel on the CPU, so the kernel
    flags change nothing on its side and configs of one rate share it."""
    cache = {}

    def get(dropout):
        if dropout not in cache:
            jcfg = JModelConfig(**dict(BASE, dropout=dropout))
            params = jadt.init_params(jax.random.PRNGKey(0), jcfg)
            jb = jbatch(make_batch(ModelConfig(**BASE)))
            rng = jax.random.PRNGKey(11)

            def jloss(p):
                return jadt.forward_loss(p, jb["wavs"], jb["tokens"], jb["token_lengths"], jcfg, rng=rng, train=True)

            loss, grads = jax.jit(jax.value_and_grad(jloss))(params)
            if "eval" not in cache:
                cache["eval"] = float(jstep.make_eval_step(jcfg)(params, jb))
            cache[dropout] = (float(loss), state_dict_from_jax_params(jax.tree.map(np.asarray, grads)),
                              jax_site_keys(rng, jcfg))
        return cache[dropout] + (cache["eval"],)

    return get


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_loss_and_grads_match_jax(name, jax_reference):
    _, _, model, tcfg = build(CONFIGS[name])
    ref_loss, ref_grads, site_keys, ref_eval = jax_reference(tcfg.dropout)
    tb = tbatch(make_batch(tcfg))
    loss = model.forward_loss(tb["wavs"], tb["tokens"], tb["token_lengths"], keys=torch.from_numpy(site_keys),
                              train=True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), ref_loss, rtol=LOSS_RTOL)
    assert_grads_close({n: p.grad for n, p in model.named_parameters()}, ref_grads)
    # eval mode: no dropout, the same loss as JAX's eval step
    ev = tstep.make_eval_step(tcfg, device="cpu")(model, tb)
    np.testing.assert_allclose(ev.item(), ref_eval, rtol=LOSS_RTOL)


def test_cross_entropy_sum_and_nonfinite_logits_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(2, 5, 7)).astype(np.float32) * 3
    logits[0, 1, 2], logits[1, 3, 0], logits[1, 4, 4] = np.nan, np.inf, -np.inf
    labels = rng.integers(0, 7, size=(2, 5)).astype(np.int64)
    labels[0, 4] = 1  # PAD is ignored
    s, n = tadt.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels), reduction="sum")
    js, jn = jadt.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels), reduction="sum")
    np.testing.assert_allclose(s.item(), float(js), rtol=1e-6)
    assert n.item() == float(jn) == float((labels != 1).sum())
    lengths = np.array([5, 9, 9, 3])
    np.testing.assert_array_equal(tadt.collate_token_lengths(torch.from_numpy(lengths)).numpy(),
                                  np.asarray(jadt.collate_token_lengths(jnp.asarray(lengths))))


@pytest.mark.parametrize(
    "kw", [dict(lr_scheduler_type="cosine"), dict(lr_scheduler_type="cosine", min_learning_rate=1e-5),
           dict(lr_scheduler_type="linear"), dict(lr_scheduler_type="constant_with_warmup"),
           dict(lr_scheduler_type="constant")],
    ids=["cosine", "cosine-min-lr", "linear", "constant-with-warmup", "constant"],
)
def test_schedules_match_jax(kw):
    base = dict(learning_rate=1e-3, warmup_ratio=0.1, **kw)
    got = topt.make_schedule(TrainingConfig(**base), total_steps=100)
    ref = jopt.make_schedule(JTrainingConfig(**base), total_steps=100)
    for step in range(0, 102):
        # JAX evaluates in fp32, the port in float64: 1e-6 of the base lr absolute
        np.testing.assert_allclose(got(step), float(ref(step)), rtol=1e-6, atol=1e-9, err_msg=str(step))
    assert got(0) == 0.0 or kw["lr_scheduler_type"] == "constant"
    with pytest.raises(ValueError):
        topt.make_schedule(TrainingConfig(lr_scheduler_type="polynomial"), total_steps=100)


def test_decay_mask_matches_jax():
    params, _, model, _ = build(CONFIGS["plain"])
    ref = state_dict_from_jax_params(jax.tree.map(np.asarray, jopt.decay_mask(params)))
    got = topt.decay_mask(model)
    assert got == {k: bool(v.all()) for k, v in ref.items()}
    assert not got["encoder.encoder.layers.0.norm1.weight"] and not got["decoder.decoder.layers.1.self_attn.in_proj_bias"]
    assert got["decoder.tgt_tok_emb.embedding.weight"] and got["encoder.dense_layer.weight"]


def _opt_pair(decay, **kw):
    """The port's optimizer and optax's chain for {"w": decays, "b": not}."""
    tcfg = dict(learning_rate=1e-2, weight_decay=0.1, warmup_ratio=0.25, max_grad_norm=1.0, **kw)
    total = 8 * tcfg.get("gradient_accumulation_steps", 1)
    tx, _ = jopt.make_optimizer(JTrainingConfig(**tcfg), total_steps=total, params=decay)
    cfg = TrainingConfig(**tcfg)
    accum = max(1, cfg.gradient_accumulation_steps)
    opt = topt.Optimizer(topt.make_schedule(cfg, total // accum), max_grad_norm=cfg.max_grad_norm,
                         weight_decay=cfg.weight_decay, decay={"w": True, "b": False}, accum_steps=accum,
                         skip_nonfinite=cfg.skip_nonfinite_updates)
    return opt, tx


def _grad_stream(n, nan_at=()):
    rng = np.random.default_rng(3)
    out = []
    for i in range(n):
        scale = 5.0 if i % 3 == 0 else 0.1  # every third step is clipped
        g = {"w": rng.normal(size=(4, 3)).astype(np.float32) * scale, "b": rng.normal(size=(3,)).astype(np.float32) * scale}
        if i in nan_at:
            g["w"][1, 1] = np.nan
        out.append(g)
    return out


@pytest.mark.parametrize(
    "kw, nan_at",
    [({}, ()), ({"gradient_accumulation_steps": 2}, ()), ({"skip_nonfinite_updates": 2}, (2, 4, 5, 6, 7))],
    ids=["adamw", "accumulation", "skip-nonfinite"],
)
def test_optimizer_matches_optax(kw, nan_at):
    """Params and counters after each of 10 updates: warmup (first lr 0),
    clipping, decay only on `w`; accumulation in update space; the guard
    skipping NaN steps, then letting the third consecutive one through."""
    rng = np.random.default_rng(0)
    p0 = {"w": rng.normal(size=(4, 3)).astype(np.float32), "b": rng.normal(size=(3,)).astype(np.float32)}
    opt, tx = _opt_pair({"w": True, "b": False}, **kw)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    js, ts = tx.init(jp), opt.init(tp)
    update = jax.jit(tx.update)
    for i, g in enumerate(_grad_stream(10, nan_at)):
        ju, js = update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = opt.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp)
        topt.apply_updates(tp, tu)
        for k in p0:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-6, equal_nan=True,
                                       err_msg=f"step {i} {k}")
        if nan_at:
            assert ts.total_notfinite == int(js.total_notfinite) and ts.notfinite_count == int(js.notfinite_count)
    if nan_at:
        assert not np.isfinite(tp["w"].numpy()).all()  # the third consecutive NaN step got through


@pytest.mark.parametrize("name", ["fused-ffn", "flash"])
def test_three_train_steps_match_jax(name):
    """Three `make_train_step` steps on one batch, each with its own rng:
    loss, grad_norm and every parameter. Warmup makes the first update's lr
    0 on both sides. Tolerances: once Adam has moved the parameters, its
    1/sqrt(v) has turned the fp32 gradient noise of near-zero elements into
    parameter differences of ~1e-5, which move grad_norm by up to 2e-4
    relative and the loss by less than 2e-6. The key part of each
    `in_proj_bias` has a gradient that is zero by construction (softmax is
    shift-invariant), so Adam steps it by +-lr on noise of either sign: it
    is held to the sum of the applied learning rates, the rest to 5e-5."""
    kw = CONFIGS[name]
    params, jcfg, model, tcfg = build(kw)
    train = dict(learning_rate=1e-3, warmup_ratio=0.2, weight_decay=1e-2, max_grad_norm=1.0)
    tx, _ = jopt.make_optimizer(JTrainingConfig(**train), total_steps=10, params=params)
    opt, sched = topt.make_optimizer(TrainingConfig(**train), total_steps=10, model=model)
    assert sched(0) == 0.0
    jfn, tfn = jstep.make_train_step(jcfg, tx), tstep.make_train_step(tcfg, opt, device="cpu")
    js, ts = jstep.init_train_state(params, tx), tstep.init_train_state(model, opt)
    b = make_batch(tcfg, seed=1)
    for i in range(3):
        rng = jax.random.PRNGKey(100 + i)
        js, jm = jfn(js, jbatch(b), rng)
        ts, tm = tfn(ts, tbatch(b), torch.from_numpy(jax_site_keys(rng, jcfg)))
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=LOSS_RTOL, err_msg=str(i))
        np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]), rtol=2e-4, err_msg=str(i))
    assert ts.step == 3 and ts.opt_state.count == 3
    lr_sum = sum(sched(i) for i in range(3))
    ref = state_dict_from_jax_params(jax.tree.map(np.asarray, js.params))
    for n, p in model.named_parameters():
        got, want = p.detach().numpy(), ref[n].numpy()
        if n.endswith("in_proj_bias"):  # q | k | v thirds: only k is held to lr_sum
            d = got.shape[0] // 3
            np.testing.assert_allclose(got[d : 2 * d], want[d : 2 * d], atol=lr_sum, rtol=0, err_msg=n + " k")
            got, want = np.delete(got, np.s_[d : 2 * d]), np.delete(want, np.s_[d : 2 * d])
        np.testing.assert_allclose(got, want, atol=5e-5, rtol=0, err_msg=n)


def test_train_step_refuses_a_mesh_remat_and_a_missing_card(monkeypatch):
    _, _, model, tcfg = build(CONFIGS["plain"])
    opt, _ = topt.make_optimizer(TrainingConfig(), total_steps=10, model=model)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: tstep.make_train_step(tcfg, opt), lambda: tstep.make_eval_step(tcfg)):
        with pytest.raises(RuntimeError, match="no CUDA"):
            make()
    with pytest.raises(NotImplementedError, match="DDP"):
        tstep.make_train_step(tcfg, opt, device="cpu", mesh=object())
    # remat is ported: training recomputes each layer (test_torch_checkpoint.py holds it to remat off)
    remat = ADTModel(ModelConfig(**dict(CONFIGS["plain"], remat=True)), device="cpu")
    assert remat.encode(torch.zeros(1, tcfg.chunk_samples), train=True).shape[0] == 1
    with pytest.raises(ValueError, match="unsupported optim"):
        topt.make_optimizer(TrainingConfig(optim="adafactor"), total_steps=10, model=model)


@pytest.mark.parametrize("name", ["fused-ffn", "flash"])
def test_chip_smoke_train_configs_match_their_yaml(name, monkeypatch):
    """chip_smoke.py reads configs/train/TMIDT-<name>.yaml with the port's own
    reader (the machine with the card has no PyYAML): with PyYAML blocked it
    gives the JAX package's typed config."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    path = chip_smoke.TRAIN_YAMLS[name]
    assert path == f"configs/train/TMIDT-{name}.yaml"
    jax_cfg = JFrameworkConfig.from_yaml(REPO / path)
    monkeypatch.setitem(sys.modules, "yaml", None)
    yaml_cfg = chip_smoke.load_config(path, train=True)
    for section in ("shared", "tokenizer", "model"):
        assert dataclasses.asdict(getattr(yaml_cfg, section)) == dataclasses.asdict(getattr(jax_cfg, section)), section
    jt = dataclasses.asdict(jax_cfg.training)
    assert {k: v for k, v in dataclasses.asdict(yaml_cfg.training).items()} == {
        k: jt[k] for k in dataclasses.asdict(yaml_cfg.training)}
    model = yaml_cfg.model
    assert model.use_pallas_mel and model.d_model == 768 and model.ffn_dim == 3072
    assert (model.use_pallas_ffn, model.dropout > 0) == ((True, True) if name == "fused-ffn" else (False, False))
    assert model.use_flash_attention == (name == "flash")
