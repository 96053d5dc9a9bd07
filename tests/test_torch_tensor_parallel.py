"""Tensor parallelism of the port's training (the mesh's `model` axis), on the CPU.

- The pieces: `hash_mask_slice` against the slice of `hash_mask`; K4's
  plain version with `col0` 0 at the whole width against its one-process
  call, and its partial mode summed over the column shards; the fused
  `add_layer_norm`'s plain route against `layer_norm(x + r)`; the layout's
  shard and unshard (heads within each of q, k, v), and layouts that do
  not divide.
- The step: the port's ranks (spawned processes over gloo, as in
  `test_torch_ddp.py`) at 1 x 2 (2 ranks) and 2 x 2 (4 ranks) against JAX's
  `make_train_step` on `make_mesh(n_data, n_model)` over conftest's virtual
  CPU devices, on the same weights, rows and dropout keys (the site keys of
  JAX's step rng, folded with the data index on a data axis of 2), with
  dropout 0.1 so the masks' whole-tensor offsets are covered. `plain` runs
  the XLA path's layers, `fused-ffn` K4's plain version in its partial
  mode; JAX's forward skips Pallas on the CPU, so one JAX reference serves
  both. Tolerances are JAX's own for its sharded step
  (`tests/test_train_step.py:97-110`): the gradients, gathered, to 1e-5
  absolute and 1e-4 relative; the loss to 1e-5 relative; the grad norm to
  1e-4 relative.
- The trainer at `mesh.model_axis: 2` in two ranks: a straight run and a
  run resumed from its mid-run checkpoint are bit-equal, the ranks hold one
  model between them, and the checkpoint (written whole) loads into a
  one-process `ADTModel` equal to the gathered shards.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from adt_str_tpu.config import TrainingConfig as JTrainingConfig
from adt_str_tpu.models import adt as jadt
from adt_str_tpu.parallel import mesh as jmesh
from adt_str_tpu.parallel import train_step as jstep
from adt_str_tpu.training import optimizer as jopt
from adt_str_tpu_torch.config import ModelConfig, TrainingConfig
from adt_str_tpu_torch.models.adt import ADTModel
from adt_str_tpu_torch.models.convert import shard_state_dict_from_jax_params, state_dict_from_jax_params
from adt_str_tpu_torch.ops import layer_norm as ln_ops
from adt_str_tpu_torch.ops.dropout_hash import hash_mask, hash_mask_slice, seed_from_key
from adt_str_tpu_torch.ops.ffn import ffn_dropout_bwd_plain, ffn_dropout_plain
from adt_str_tpu_torch.parallel import mesh as tmesh
from adt_str_tpu_torch.parallel import tensor_parallel as tp
from adt_str_tpu_torch.parallel import train_step as tstep
from adt_str_tpu_torch.training import checkpoint as ckpt
from adt_str_tpu_torch.training import optimizer as topt
from adt_str_tpu_torch.training import trainer
from test_torch_ddp import init_gloo, run_ranks
from test_torch_train_step import build, jax_site_keys, make_batch
from test_torch_trainer import lakh_config, lakh_env  # noqa: F401 (fixture)

TP_MODEL = dict(sample_rate=4000, win_length=256, time_res=0.01, input_sec=0.64, enc_layers=2, dec_layers=2,
                nhead=2, d_query=128, tgt_vocab_size=64, n_mels=16, compute_dtype="float32", max_positions=64,
                dropout=0.1)
CASES = {"plain": {}, "fused-ffn": {"use_pallas_ffn": True}}
SHAPES = {"1x2": (1, 2), "2x2": (2, 2)}
B = 4  # global rows
STEPS = 2
TRAIN = dict(learning_rate=1e-3, warmup_ratio=0.2, weight_decay=1e-2, max_grad_norm=1.0)


# ------------------------------------------------------------------ the pieces


@pytest.mark.parametrize("shape,dim,start,stop", [((2, 4, 5, 5), 1, 1, 3), ((2, 4, 5, 5), 1, 0, 4),
                                                  ((3, 7, 12), -1, 5, 12), ((3, 7, 12), -1, 0, 4),
                                                  ((9, 1536 * 2), -1, 1536, 3072), ((5, 3, 6), 1, 2, 2)])
def test_hash_mask_slice_is_the_slice_of_hash_mask(shape, dim, start, stop):
    seed = seed_from_key((123, 4567))
    whole = hash_mask(shape, seed, 0.9)
    part = hash_mask_slice(shape, dim, start, stop, seed, 0.9)
    assert torch.equal(part, whole.narrow(dim % len(shape), start, stop - start))


def _ffn_inputs(n=10, d=16, d_ff=24, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, d, generator=g)
    w1, b1 = torch.randn(d_ff, d, generator=g) / 4, torch.randn(d_ff, generator=g) / 4
    w2, b2 = torch.randn(d, d_ff, generator=g) / 4, torch.randn(d, generator=g) / 4
    seeds = seed_from_key((5, 6)) + seed_from_key((7, 8))
    return x, w1, b1, w2, b2, seeds


def test_k4_plain_at_col0_zero_and_the_whole_width_is_the_one_process_call():
    x, w1, b1, w2, b2, seeds = _ffn_inputs()
    out, pre = ffn_dropout_plain(x, w1, b1, w2, b2, seeds, 0.8, 0.7)
    out2, pre2 = ffn_dropout_plain(x, w1, b1, w2, b2, seeds, 0.8, 0.7, col0=0, d_ff_total=w1.shape[0])
    assert torch.equal(out, out2) and torch.equal(pre, pre2)
    g = torch.randn_like(out)
    full = ffn_dropout_bwd_plain(g, x, w1, w2, pre, seeds, 0.8, 0.7)
    again = ffn_dropout_bwd_plain(g, x, w1, w2, pre, seeds, 0.8, 0.7, col0=0, d_ff_total=w1.shape[0])
    assert all(torch.equal(a, b) for a, b in zip(full, again))


def test_k4_partial_mode_summed_over_column_shards_is_the_one_process_call():
    """Two column shards in the partial mode, summed, then b2 and the output
    dropout: the one-process output to fp32 summation order; each shard's
    pre is its columns of the whole pre; the backward's parts likewise."""
    x, w1, b1, w2, b2, seeds = _ffn_inputs()
    out, pre = ffn_dropout_plain(x, w1, b1, w2, b2, seeds, 0.8, 0.7)
    n, d_ff = x.shape[0], w1.shape[0]
    half = d_ff // 2
    parts = [ffn_dropout_plain(x, w1[c : c + half], b1[c : c + half], w2[:, c : c + half], None, seeds, 0.8, 0.7,
                               col0=c, d_ff_total=d_ff) for c in (0, half)]
    assert all(p.dtype == torch.float32 for p, _ in parts)
    assert torch.equal(torch.cat([pr for _, pr in parts], 1), pre)
    y = parts[0][0] + parts[1][0] + b2
    mo = hash_mask((n, x.shape[1]), seeds[2:4], 0.7)
    torch.testing.assert_close(torch.where(mo, y * (1.0 / 0.7), 0.0), out, atol=1e-6, rtol=1e-6)
    g = torch.randn_like(out)
    dw1, db1, dw2, db2, dx = ffn_dropout_bwd_plain(g, x, w1, w2, pre, seeds, 0.8, 0.7)
    g_part = torch.where(mo, g * (1.0 / 0.7), 0.0)  # the output dropout's backward, before the partial products
    shards = [ffn_dropout_bwd_plain(g_part, x, w1[c : c + half], w2[:, c : c + half], pre[:, c : c + half], seeds,
                                    0.8, 0.7, col0=c, d_ff_total=d_ff, partial=True) for c in (0, half)]
    assert all(s[3] is None for s in shards)
    torch.testing.assert_close(torch.cat([s[0] for s in shards]), dw1, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(torch.cat([s[1] for s in shards]), db1, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(torch.cat([s[2] for s in shards], 1), dw2, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(shards[0][4] + shards[1][4], dx, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_add_layer_norm_plain_is_layer_norm_of_the_sum(dtype):
    g = torch.Generator().manual_seed(1)
    x, r = ((torch.randn(7, 5, 96, generator=g) * 3 + 0.5).to(dtype) for _ in range(2))
    w, b = 1 + 0.1 * torch.randn(96, generator=g), 0.1 * torch.randn(96, generator=g)
    got = ln_ops.add_layer_norm(x, r, w, b, 1e-5)
    assert got.dtype == dtype and torch.equal(got, ln_ops.layer_norm(x + r, w, b, 1e-5))


def test_the_layout_cuts_heads_within_q_k_v_and_puts_them_back():
    cfg = ModelConfig(**TP_MODEL)
    full = ADTModel(cfg, device="cpu")
    sd = full.state_dict()
    shards = [tp.shard_state_dict(sd, r, 2) for r in range(2)]
    back = tp.unshard_state_dicts(shards)
    assert all(torch.equal(back[k], v) for k, v in sd.items())
    name = "encoder.encoder.layers.0.self_attn.in_proj_weight"
    d = cfg.d_model
    hd = d // cfg.nhead
    # rank 1 holds head 1 of each of q, k and v: rows [hd, 2 hd) of each d-row block
    want = torch.cat([sd[name][i * d + hd : (i + 1) * d] for i in range(3)])
    assert torch.equal(shards[1][name], want)
    assert tp.split_of("decoder.generator.weight") == tp.ROWS and tp.split_of("decoder.norm1.weight") is None
    assert tp.split_of("encoder.encoder.layers.1.self_attn.out_proj.bias") is None


def test_a_layout_that_does_not_divide_raises():
    cfg = ModelConfig(**TP_MODEL)
    with pytest.raises(ValueError, match="divisible"):
        ADTModel(cfg, device="cpu", tp=tp.ModelAxis(group=None, rank=0, size=3))
    with pytest.raises(ValueError, match="do not divide"):
        tp.shard(torch.zeros(3 * 10, 4), tp.QKV, 0, 3)
    with pytest.raises(ValueError, match="one process a rank"):
        tmesh.make_mesh(n_data=1, n_model=2, devices=["cpu"])


def test_jax_params_go_straight_to_a_shard():
    params, _, model, _ = build(TP_MODEL)
    for r in range(2):
        got = shard_state_dict_from_jax_params(jax.tree.map(np.asarray, params), r, 2)
        want = tp.shard_state_dict(model.state_dict(), r, 2)
        assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)


# ------------------------------------------------------------------ the step against JAX's


def _rows(b: dict, d: int, k: int) -> dict:
    return {n: torch.from_numpy(v[d * k : (d + 1) * k].astype(np.int64) if v.dtype == np.int32 else
                                v[d * k : (d + 1) * k]) for n, v in b.items()}


def _tp_case(case: dict, mesh) -> dict:
    """This rank's gathered gradients of one step, then STEPS steps."""
    tcfg = ModelConfig(**case["model"])
    axis = mesh.model
    model = ADTModel(tcfg, device="cpu", tp=axis)
    model.load_state_dict(tp.shard_state_dict(case["weights"], axis.rank, axis.size), strict=True)
    rows = _rows(case["batch"], mesh.rank, B // mesh.world)
    wav, tok, lengths = rows["wavs"], rows["tokens"], rows["token_lengths"]
    keys = torch.from_numpy(case["grad_keys"][mesh.rank])
    params = dict(model.named_parameters())

    def loss_fn(reduction):
        return model.forward_loss(wav, tok, lengths, keys=keys, train=True, reduction=reduction)

    loss, _ = tstep._global_mean(mesh, loss_fn, False)
    grads = tstep.allreduce_grads(mesh, list(torch.autograd.grad(loss, list(params.values()))), None)
    grads = tp.gather_state_dict(dict(zip(params, grads)), axis)
    opt, _ = topt.make_optimizer(TrainingConfig(**TRAIN), total_steps=10, model=model)
    step, state = tstep.make_train_step(tcfg, opt, device="cpu", mesh=mesh), tstep.init_train_state(model, opt)
    losses, norms = [], []
    for i in range(STEPS):
        state, m = step(state, rows, torch.from_numpy(case["step_keys"][i][mesh.rank]))
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    return {"grads": grads, "losses": losses, "grad_norms": norms,
            "weights": tp.gather_state_dict(model.state_dict(), axis)}


def _tp_rank(rank: int, world: int, store: str, job_path: str, out_path: str) -> None:
    torch.set_num_threads(1)
    init_gloo(rank, world, store)
    try:
        job = torch.load(job_path, weights_only=False)
        mesh = tmesh.make_mesh(*job["shape"], devices=["cpu"])
        assert (mesh.n_data, mesh.n_model, mesh.global_rank) == (*job["shape"], rank)
        torch.save({name: _tp_case(case, mesh) for name, case in job["cases"].items()}, out_path)
    finally:
        dist.destroy_process_group()


def jax_tp(shape: tuple) -> tuple[dict, dict]:
    """JAX on a (n_data, n_model) mesh -> (its gradients of one step as port
    names, its STEPS steps' losses and norms; the ranks' case inputs)."""
    nd, nm = shape
    params, jcfg, model, tcfg = build(TP_MODEL)
    mesh = jmesh.make_mesh(n_data=nd, n_model=nm, devices=jax.devices()[: nd * nm])
    fresh = lambda: jmesh.shard_params(mesh, jax.tree.map(np.asarray, params))  # noqa: E731 (the step donates)
    b = make_batch(tcfg, B=B, seed=3)
    k = B // nd

    def sum_loss(p, rows, key):
        return jadt.forward_loss(p, rows["wavs"], rows["tokens"], rows["token_lengths"], jcfg, rng=key, train=True,
                                 reduction="sum")

    grad_fn = jax.jit(jax.grad(sum_loss, has_aux=True))
    rng = jax.random.PRNGKey(7)
    sharded = fresh()
    total, count, grad_keys = None, 0.0, []
    for d in range(nd):
        key = rng if nd == 1 else jax.random.fold_in(rng, d)
        g, n_valid = grad_fn(sharded, {n: jnp.asarray(v[d * k : (d + 1) * k]) for n, v in b.items()}, key)
        total = g if total is None else jax.tree.map(jnp.add, total, g)
        count += float(n_valid)
        grad_keys.append(jax_site_keys(key, jcfg))
    grads = state_dict_from_jax_params(jax.tree.map(lambda g: np.asarray(g) / max(count, 1.0), total))
    tx, _ = jopt.make_optimizer(JTrainingConfig(**TRAIN), total_steps=10, params=params)
    fn = jstep.make_train_step(jcfg, tx, mesh=mesh)
    state = jstep.init_train_state(fresh(), tx)
    losses, norms, step_keys = [], [], []
    for i in range(STEPS):
        r = jax.random.PRNGKey(200 + i)
        state, m = fn(state, {n: jnp.asarray(v) for n, v in b.items()}, r)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        step_keys.append([jax_site_keys(r if nd == 1 else jax.random.fold_in(r, d), jcfg) for d in range(nd)])
    ref = {"grads": grads, "losses": losses, "grad_norms": norms}
    case = {"weights": model.state_dict(), "batch": b, "grad_keys": grad_keys, "step_keys": step_keys}
    return ref, case


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    out = {}
    for label, shape in SHAPES.items():
        ref, case = jax_tp(shape)
        cases = {name: dict(case, model=dict(TP_MODEL, **flags)) for name, flags in CASES.items()}
        ranks = run_ranks(_tp_rank, tmp_path_factory.mktemp(f"tp{label}"), {"shape": shape, "cases": cases},
                          world=shape[0] * shape[1])
        out[label] = (ref, ranks)
    return out


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("label", SHAPES)
def test_tp_gradients_match_jax_on_its_mesh(tp_runs, label, case):
    ref, ranks = tp_runs[label]
    got = ranks[0][case]["grads"]
    assert got.keys() == ref["grads"].keys()
    for name, want in ref["grads"].items():
        np.testing.assert_allclose(got[name].numpy(), want.numpy(), atol=1e-5, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("label", SHAPES)
def test_tp_steps_match_jax_on_its_mesh(tp_runs, label, case):
    ref, ranks = tp_runs[label]
    got = ranks[0][case]
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norms"], ref["grad_norms"], rtol=1e-4)


@pytest.mark.parametrize("label", SHAPES)
def test_every_rank_holds_the_same_model(tp_runs, label):
    """The gathered weights, losses and norms of every rank are bit-equal:
    the replicated parameters stay in step across a model group, and the
    data axis keeps the groups in step."""
    _, ranks = tp_runs[label]
    for case in CASES:
        first = ranks[0][case]
        for other in ranks[1:]:
            assert other[case]["losses"] == first["losses"] and other[case]["grad_norms"] == first["grad_norms"]
            assert all(torch.equal(other[case]["weights"][n], w) for n, w in first["weights"].items())


# ------------------------------------------------------------------ the trainer


def _trainer_tp_rank(rank: int, world: int, store: str, job_path: str, out_path: str) -> None:
    torch.set_num_threads(1)
    init_gloo(rank, world, store)
    try:
        job = torch.load(job_path, weights_only=False)
        env, out = job["env"], job["out"]
        straight_cfg = lakh_config(env, out / "a", 2)
        straight_cfg.mesh = dataclasses.replace(straight_cfg.mesh, model_axis=2)
        straight_cfg.logging = dataclasses.replace(straight_cfg.logging, save_every_n_steps=1)
        straight = trainer.train(straight_cfg, device="cpu")
        half = dataclasses.replace(straight_cfg, logging=dataclasses.replace(straight_cfg.logging,
                                                                             output_dir=str(out / "b")))
        half.training = dataclasses.replace(half.training, max_steps=1)
        trainer.train(half, device="cpu")
        resumed = trainer.train(dataclasses.replace(half, training=dataclasses.replace(half.training, max_steps=2)),
                                device="cpu")
        axis = straight.model.tp
        torch.save({"steps": (straight.step, resumed.step), "axis": (axis.rank, axis.size),
                    "straight": {n: p.detach().clone() for n, p in straight.model.named_parameters()},
                    "resumed": {n: p.detach().clone() for n, p in resumed.model.named_parameters()},
                    "gathered": tp.gather_state_dict(straight.model.state_dict(), axis),
                    "mu": tp.gather_state_dict(straight.opt_state.mu, axis)}, out_path)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def trainer_tp(lakh_env, tmp_path_factory):  # noqa: F811
    out = tmp_path_factory.mktemp("trainer_tp")
    return out, run_ranks(_trainer_tp_rank, out / "spawn", {"env": lakh_env, "out": out})


def test_trainer_at_model_axis_2_resumes_bit_equal(trainer_tp):
    _, (r0, r1) = trainer_tp
    assert r0["steps"] == r1["steps"] == (2, 2) and r0["axis"] == (0, 2) and r1["axis"] == (1, 2)
    for r in (r0, r1):
        assert all(torch.equal(r["straight"][n], r["resumed"][n]) for n in r["straight"])
    assert all(torch.equal(r0["gathered"][n], r1["gathered"][n]) for n in r0["gathered"])
    # the two ranks hold different halves of a split parameter
    name = "decoder.generator.weight"
    assert not torch.equal(r0["straight"][name], r1["straight"][name])


def test_a_tp_checkpoint_loads_into_one_process(trainer_tp):
    out, (r0, _) = trainer_tp
    path = ckpt.latest_checkpoint(out / "a" / "lakh")
    assert path is not None and path.endswith("step-2")
    cfg = lakh_config(out, out, 2)
    model = ADTModel(cfg.model, device="cpu")
    opt_state, step, _ = ckpt.restore_checkpoint(path, model)
    assert step == 2
    assert all(torch.equal(model.state_dict()[n], w) for n, w in r0["gathered"].items())
    assert all(torch.equal(opt_state.mu[n], m) for n, m in r0["mu"].items())
    st = torch.load(f"{path}/state.pt", weights_only=True)
    assert st["model"]["decoder.generator.weight"].shape[0] == cfg.model.tgt_vocab_size  # written whole
