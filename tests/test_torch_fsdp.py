"""FSDP of the port's training (parameters and moments sharded over the data axis), on the CPU.

- The layout: for a tiny config at n_data 2 and 4 and n_model 1 and 2, each
  leaf's data-sharded torch dimension (or replicated) equals what JAX's
  `fsdp_partition_specs` gives, mapped through the transpose; the rule's
  corner cases (a tie, a dimension n_data does not divide, a leaf under
  1,024 elements, a dimension the tensor-parallel spec names).
- The step: the port's ranks (spawned processes over gloo, as in
  `test_torch_ddp.py`) at 2 x 1, 4 x 1 and 2 x 2 against JAX's
  `make_train_step` on `make_mesh(n_data, n_model)` with
  `shard_params(..., fsdp=True)` over conftest's virtual CPU devices, on
  the same weights (loaded through
  `convert.fsdp_shard_state_dict_from_jax_params`), rows and dropout keys,
  with dropout 0.1. `plain` and `fused-ffn` (K4's plain version) as in
  `test_torch_tensor_parallel.py`. Tolerances are JAX's own for its FSDP
  step (`tests/test_train_step.py:289-345`): the gradients, gathered, to
  1e-5 absolute and 1e-4 relative; the loss to 2e-5 relative; the
  parameters after the steps to 2e-4 absolute and 0.02 relative.
- On the same ranks and rows: FSDP against DDP (the first step's loss
  bit-equal, the grad norm within 1e-5 relative), each rank's resting
  bytes, and `comm_dtype` "bf16" within JAX's bf16 bound
  (`tests/test_train_step.py:270-282`: losses 5e-3 relative, parameters
  5e-3 absolute).
- The trainer at `mesh.fsdp: true` in 2 ranks (2 x 1) and 4 ranks (2 x 2,
  `model_axis: 2`): a straight run and a run resumed from its mid-run
  checkpoint are bit-equal, and the checkpoint (written whole) loads into a
  one-process `ADTModel` equal to the gathered shards.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from adt_str_tpu.config import ModelConfig as JModelConfig
from adt_str_tpu.config import TrainingConfig as JTrainingConfig
from adt_str_tpu.models import adt as jadt
from adt_str_tpu.parallel import mesh as jmesh
from adt_str_tpu.parallel import train_step as jstep
from adt_str_tpu.training import optimizer as jopt
from adt_str_tpu_torch.config import ModelConfig, TrainingConfig
from adt_str_tpu_torch.models.adt import ADTModel
from adt_str_tpu_torch.models.convert import fsdp_shard_state_dict_from_jax_params, state_dict_from_jax_params
from adt_str_tpu_torch.parallel import fsdp
from adt_str_tpu_torch.parallel import mesh as tmesh
from adt_str_tpu_torch.parallel import tensor_parallel as tp
from adt_str_tpu_torch.parallel import train_step as tstep
from adt_str_tpu_torch.training import checkpoint as ckpt
from adt_str_tpu_torch.training import optimizer as topt
from adt_str_tpu_torch.training import trainer
from test_torch_ddp import init_gloo, run_ranks
from test_torch_train_step import jax_site_keys, make_batch
from test_torch_trainer import lakh_config, lakh_env  # noqa: F401 (fixture)

# d_model 256, d_ff 1024; a vocabulary of 262 = 2 x 131: the embedding's rows divide over 2 data ranks, not 4
FSDP_MODEL = dict(sample_rate=4000, win_length=256, time_res=0.01, input_sec=0.64, enc_layers=2, dec_layers=2,
                  nhead=2, d_query=128, tgt_vocab_size=262, n_mels=16, compute_dtype="float32", max_positions=64,
                  dropout=0.1)
CASES = {"plain": {}, "fused-ffn": {"use_pallas_ffn": True}}
SHAPES = {"2x1": (2, 1), "4x1": (4, 1), "2x2": (2, 2)}
B = 4  # global rows
STEPS = 2
TRAIN = dict(learning_rate=1e-3, warmup_ratio=0.2, weight_decay=1e-2, max_grad_norm=1.0)


def jax_params(seed=0):
    return jax.tree.map(np.asarray, jadt.init_params(jax.random.PRNGKey(seed), JModelConfig(**FSDP_MODEL)))


# ------------------------------------------------------------------ the layout


def jax_data_dims(params, n_data: int) -> dict:
    """{port name: the torch dimension JAX shards over `data`, or None}: each
    leaf replaced by its index along the data-sharded JAX dimension (zeros
    when replicated), taken through the port's converter, which transposes
    as it does the weights; the torch dimension is the one the values vary along."""
    specs = jmesh.fsdp_partition_specs(params, n_data)

    def marker(leaf, spec):
        shape = np.shape(leaf)
        entries = list(spec) + [None] * (len(shape) - len(spec))
        out = np.zeros(shape, np.float32)
        for d, e in enumerate(entries):
            if e == jmesh.DATA_AXIS:
                out += np.arange(shape[d], dtype=np.float32).reshape([-1 if i == d else 1 for i in range(len(shape))])
        return out

    marked = state_dict_from_jax_params(jax.tree.map(marker, params, specs))
    return {k: next((d for d in range(t.dim()) if bool((t.diff(dim=d) != 0).any())), None) for k, t in marked.items()}


@pytest.mark.parametrize("n_model", [1, 2])
@pytest.mark.parametrize("n_data", [2, 4])
def test_the_layout_is_jax_fsdp_partition_specs(n_data, n_model):
    params = jax_params()
    want = jax_data_dims(params, n_data)
    shard = tp.shard_state_dict(state_dict_from_jax_params(params), 0, n_model)
    got = fsdp.data_dims({k: tuple(v.shape) for k, v in shard.items()}, n_data, n_model)
    assert got == want
    # the rule's cases in this model: every P("model") bias and every small leaf replicated, the embedding's
    # 262 rows taken over 2 ranks and its 256 columns over 4, the dense layer's tie to torch dim 1
    assert got["encoder.encoder.layers.0.self_attn.in_proj_bias"] is None
    assert got["encoder.encoder.layers.0.linear1.bias"] is None and got["decoder.generator.bias"] is None
    assert got["encoder.encoder.layers.0.norm1.weight"] is None
    assert got[fsdp.EMBEDDING] == (0 if n_data == 2 else 1)
    assert got["encoder.dense_layer.weight"] == 1 and got["project_to_mel.weight"] == 0
    assert got["encoder.encoder.layers.0.self_attn.in_proj_weight"] == 1
    assert got["decoder.decoder.layers.0.linear2.weight"] == 0 and got["decoder.generator.weight"] == 1


def test_the_rule_on_its_corner_cases():
    assert fsdp.data_dim("x.weight", (33, 35), 2) is None  # no dimension divides
    assert fsdp.data_dim("x.weight", (34, 38), 2) == 1  # JAX (38, 34): its dim 0, 38, the larger -> torch dim 1
    assert fsdp.data_dim("x.weight", (34, 38), 4) is None  # neither 34 nor 38 divides by 4
    assert fsdp.data_dim("x.weight", (64, 64), 4) == 1  # a tie: JAX's first, (in, out) -> torch dim 1
    assert fsdp.data_dim(fsdp.EMBEDDING, (64, 64), 4) == 0  # the embedding is not transposed
    assert fsdp.data_dim("x.weight", (31, 32), 2) is None  # 992 elements: under 1,024
    assert fsdp.data_dim("a.linear1.weight", (256, 64), 2) == 1  # dim 0 named by TP even at n_model 1
    assert fsdp.data_dim("a.out_proj.weight", (64, 256), 2) == 0
    assert fsdp.data_dim("a.linear1.weight", (256, 64), 1) is None  # one data rank: nothing sharded


def test_a_one_rank_fsdp_mesh_shards_nothing():
    mesh = tmesh.make_mesh(devices=["cpu"], fsdp=True)
    assert mesh.fsdp and mesh.n_data == 1
    model = ADTModel(ModelConfig(**FSDP_MODEL), device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    layout = fsdp.shard_model_(model, mesh)
    assert layout.sharded == [] and model.fsdp is layout
    assert all(torch.equal(model.state_dict()[k], v) for k, v in before.items())


# ------------------------------------------------------------------ the step against JAX's


def _rows(b: dict, d: int, k: int) -> dict:
    return {n: torch.from_numpy(v[d * k : (d + 1) * k].astype(np.int64) if v.dtype == np.int32 else
                                v[d * k : (d + 1) * k]) for n, v in b.items()}


def _model(case: dict, mesh) -> ADTModel:
    """This rank's FSDP (and TP) shard of the case's JAX weights."""
    model = ADTModel(ModelConfig(**case["model"]), device="cpu", tp=mesh.model)
    if mesh.fsdp:
        fsdp.shard_model_(model, mesh)
    m_rank, n_model = (0, 1) if mesh.model is None else (mesh.model.rank, mesh.model.size)
    model.load_state_dict(fsdp_shard_state_dict_from_jax_params(case["params"], mesh.rank if mesh.fsdp else 0,
                                                                mesh.n_data if mesh.fsdp else 1, m_rank, n_model),
                          strict=True)
    return model


def _whole(sd: dict, model: ADTModel) -> dict:
    """A rank's state dict (or moments) at rest -> the one-process one."""
    if model.fsdp is not None:
        sd = model.fsdp.gather_state_dict(sd)
    return sd if model.tp is None else tp.gather_state_dict(sd, model.tp)


def _steps(case: dict, mesh, rows: dict, comm_dtype=None) -> dict:
    model = _model(case, mesh)
    opt, _ = topt.make_optimizer(TrainingConfig(**TRAIN), total_steps=10, model=model)
    step = tstep.make_train_step(model.config, opt, device="cpu", mesh=mesh, comm_dtype=comm_dtype)
    state = tstep.init_train_state(model, opt)
    sharded = set(model.fsdp.sharded) if model.fsdp is not None else set()

    def held(sd, pick):  # bytes this rank holds of the leaves `pick` takes
        return sum(t.numel() * t.element_size() for k, t in sd.items() if pick(k))

    resting = {kind: {"sharded": held(sd, lambda k: k in sharded), "replicated": held(sd, lambda k: k not in sharded)}
               for kind, sd in (("params", dict(model.named_parameters())), ("mu", state.opt_state.mu),
                                ("nu", state.opt_state.nu))}
    losses, norms = [], []
    for i in range(STEPS):
        state, m = step(state, rows, torch.from_numpy(case["step_keys"][i][mesh.rank]))
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    return {"losses": losses, "grad_norms": norms, "weights": _whole(model.state_dict(), model),
            "mu": _whole(state.opt_state.mu, model), "resting": resting}


def _fsdp_case(case: dict, mesh, ddp_mesh, bf16: bool) -> dict:
    """This rank's gathered gradients of one step, then STEPS steps under
    FSDP, and on the same ranks the DDP (TP) steps and, with `bf16`, the
    FSDP steps with bf16 transport."""
    rows = _rows(case["batch"], mesh.rank, B // mesh.world)
    model = _model(case, mesh)
    params = dict(model.named_parameters())
    keys = torch.from_numpy(case["grad_keys"][mesh.rank])
    with fsdp.gathered(model):
        loss, _ = tstep._global_mean(mesh, lambda r: model.forward_loss(rows["wavs"], rows["tokens"],
                                                                         rows["token_lengths"], keys=keys,
                                                                         train=True, reduction=r), False)
        grads = torch.autograd.grad(loss, list(params.values()))
    grads = model.fsdp.reduce_grads(dict(zip(params, grads)), None, None, tstep.allreduce_grads)
    out = {"grads": _whole(grads, model), "fsdp": _steps(case, mesh, rows), "ddp": _steps(case, ddp_mesh, rows),
           "whole_bytes": sum(int(np.prod(s)) * 4 for s in model.fsdp.whole.values())}
    if bf16:
        out["bf16"] = _steps(case, mesh, rows, comm_dtype="bf16")
    return out


def _fsdp_rank(rank: int, world: int, store: str, job_path: str, out_path: str) -> None:
    torch.set_num_threads(1)
    init_gloo(rank, world, store)
    try:
        job = torch.load(job_path, weights_only=False)
        mesh = tmesh.make_mesh(*job["shape"], devices=["cpu"], fsdp=True)
        ddp_mesh = tmesh.make_mesh(*job["shape"], devices=["cpu"])
        assert (mesh.n_data, mesh.n_model, mesh.global_rank) == (*job["shape"], rank)
        torch.save({name: _fsdp_case(case, mesh, ddp_mesh, job["bf16"] and name == "plain")
                    for name, case in job["cases"].items()}, out_path)
    finally:
        dist.destroy_process_group()


def jax_fsdp(shape: tuple) -> tuple[dict, dict]:
    """JAX on a (n_data, n_model) mesh with FSDP-sharded params -> (its
    gradients of one step as port names, its STEPS steps' losses and final
    params; the ranks' case inputs)."""
    nd, nm = shape
    params = jax_params()
    jcfg = JModelConfig(**FSDP_MODEL)
    mesh = jmesh.make_mesh(n_data=nd, n_model=nm, devices=jax.devices()[: nd * nm])
    fresh = lambda: jmesh.shard_params(mesh, params, fsdp=True)  # noqa: E731 (the step donates)
    b = make_batch(jcfg, B=B, seed=3)
    k = B // nd

    def sum_loss(p, rows, key):
        return jadt.forward_loss(p, rows["wavs"], rows["tokens"], rows["token_lengths"], jcfg, rng=key, train=True,
                                 reduction="sum")

    grad_fn = jax.jit(jax.grad(sum_loss, has_aux=True))
    rng = jax.random.PRNGKey(7)
    sharded = fresh()
    assert sum("data" in str(x.sharding.spec) for x in jax.tree.leaves(sharded)) >= 10
    total, count, grad_keys = None, 0.0, []
    for d in range(nd):
        key = jax.random.fold_in(rng, d)
        g, n_valid = grad_fn(sharded, {n: jnp.asarray(v[d * k : (d + 1) * k]) for n, v in b.items()}, key)
        total = g if total is None else jax.tree.map(jnp.add, total, g)
        count += float(n_valid)
        grad_keys.append(jax_site_keys(key, jcfg))
    grads = state_dict_from_jax_params(jax.tree.map(lambda g: np.asarray(g) / max(count, 1.0), total))
    tx, _ = jopt.make_optimizer(JTrainingConfig(**TRAIN), total_steps=10, params=params)
    fn = jstep.make_train_step(jcfg, tx, mesh=mesh)
    state = jstep.init_train_state(fresh(), tx)
    losses, step_keys = [], []
    for i in range(STEPS):
        r = jax.random.PRNGKey(200 + i)
        state, m = fn(state, {n: jnp.asarray(v) for n, v in b.items()}, r)
        losses.append(float(m["loss"]))
        step_keys.append([jax_site_keys(jax.random.fold_in(r, d), jcfg) for d in range(nd)])
    ref = {"grads": grads, "losses": losses,
           "weights": state_dict_from_jax_params(jax.tree.map(np.asarray, state.params))}
    return ref, {"params": params, "batch": b, "grad_keys": grad_keys, "step_keys": step_keys}


@pytest.fixture(scope="module")
def fsdp_runs(tmp_path_factory):
    out = {}
    for label, shape in SHAPES.items():
        ref, case = jax_fsdp(shape)
        cases = {name: dict(case, model=dict(FSDP_MODEL, **flags)) for name, flags in CASES.items()}
        job = {"shape": shape, "cases": cases, "bf16": label == "2x1"}
        out[label] = (ref, run_ranks(_fsdp_rank, tmp_path_factory.mktemp(f"fsdp{label}"), job,
                                     world=shape[0] * shape[1]))
    return out


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("label", SHAPES)
def test_fsdp_gradients_match_jax_on_its_mesh(fsdp_runs, label, case):
    ref, ranks = fsdp_runs[label]
    got = ranks[0][case]["grads"]
    assert got.keys() == ref["grads"].keys()
    for name, want in ref["grads"].items():
        np.testing.assert_allclose(got[name].numpy(), want.numpy(), atol=1e-5, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("label", SHAPES)
def test_fsdp_steps_match_jax_on_its_mesh(fsdp_runs, label, case):
    ref, ranks = fsdp_runs[label]
    got = ranks[0][case]["fsdp"]
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=2e-5)
    assert got["weights"].keys() == ref["weights"].keys()
    for name, want in ref["weights"].items():
        np.testing.assert_allclose(got["weights"][name].numpy(), want.numpy(), atol=2e-4, rtol=0.02, err_msg=name)


@pytest.mark.parametrize("label", SHAPES)
def test_fsdp_against_ddp_on_the_same_ranks(fsdp_runs, label):
    """The first step's forward runs the same whole weights: its loss is
    bit-equal; the grad norm sums the squares of shards over the data group
    (another order), within 1e-5 relative."""
    _, ranks = fsdp_runs[label]
    for r in ranks:
        for case in CASES:
            f, d = r[case]["fsdp"], r[case]["ddp"]
            assert f["losses"][0] == d["losses"][0]
            np.testing.assert_allclose(f["grad_norms"][0], d["grad_norms"][0], rtol=1e-5)


@pytest.mark.parametrize("label", SHAPES)
def test_every_rank_holds_the_same_model(fsdp_runs, label):
    _, ranks = fsdp_runs[label]
    for case in CASES:
        first = ranks[0][case]["fsdp"]
        for other in ranks[1:]:
            o = other[case]["fsdp"]
            assert o["losses"] == first["losses"] and o["grad_norms"] == first["grad_norms"]
            assert all(torch.equal(o["weights"][n], w) for n, w in first["weights"].items())
            assert all(torch.equal(o["mu"][n], m) for n, m in first["mu"].items())


@pytest.mark.parametrize("label", SHAPES)
def test_resting_bytes_a_rank(fsdp_runs, label):
    """Parameters, mu and nu at rest: the sharded leaves' bytes are 1/n_data
    of theirs whole, the replicated leaves' whole; the sum is at most
    1/n_data of the whole plus the replicated leaves, and below DDP's."""
    n_data = SHAPES[label][0]
    _, ranks = fsdp_runs[label]
    for r in ranks:
        res = r["plain"]
        ddp = sum(v["replicated"] for v in res["ddp"]["resting"].values())
        whole = 3 * res["whole_bytes"]
        assert ddp == whole  # DDP holds every leaf whole
        rest = res["fsdp"]["resting"]
        sharded = sum(v["sharded"] for v in rest.values())
        replicated = sum(v["replicated"] for v in rest.values())
        assert sharded * n_data == whole - replicated
        assert sharded + replicated <= whole / n_data + replicated
        assert replicated < 0.05 * whole and sharded + replicated < 0.6 * ddp


def test_bf16_transport_stays_within_jax_bf16_bound(fsdp_runs):
    _, ranks = fsdp_runs["2x1"]
    f32, bf16 = ranks[0]["plain"]["fsdp"], ranks[0]["plain"]["bf16"]
    np.testing.assert_allclose(bf16["losses"], f32["losses"], rtol=5e-3)
    for name, w in f32["weights"].items():
        np.testing.assert_allclose(bf16["weights"][name].numpy(), w.numpy(), atol=5e-3, rtol=0, err_msg=name)
    assert any(not torch.equal(bf16["weights"][n], w) for n, w in f32["weights"].items())  # the cast took effect


# ------------------------------------------------------------------ the trainer

TRAINER_SHAPES = {"2x1": 1, "2x2": 2}  # label: model_axis


def _trainer_fsdp_rank(rank: int, world: int, store: str, job_path: str, out_path: str) -> None:
    torch.set_num_threads(1)
    init_gloo(rank, world, store)
    try:
        job = torch.load(job_path, weights_only=False)
        env, out = job["env"], job["out"]
        straight_cfg = lakh_config(env, out / "a", 2)
        straight_cfg.mesh = dataclasses.replace(straight_cfg.mesh, model_axis=job["model_axis"], fsdp=True)
        straight_cfg.training = dataclasses.replace(straight_cfg.training, batch_size=2)  # 2 rows a data index
        straight_cfg.logging = dataclasses.replace(straight_cfg.logging, save_every_n_steps=1)
        straight = trainer.train(straight_cfg, device="cpu")
        half = dataclasses.replace(straight_cfg, logging=dataclasses.replace(straight_cfg.logging,
                                                                             output_dir=str(out / "b")))
        half.training = dataclasses.replace(half.training, max_steps=1)
        trainer.train(half, device="cpu")
        resumed = trainer.train(dataclasses.replace(half, training=dataclasses.replace(half.training, max_steps=2)),
                                device="cpu")
        model = straight.model
        torch.save({"steps": (straight.step, resumed.step), "sharded": len(model.fsdp.sharded),
                    "straight": {n: p.detach().clone() for n, p in straight.model.named_parameters()},
                    "resumed": {n: p.detach().clone() for n, p in resumed.model.named_parameters()},
                    "gathered": _whole(model.state_dict(), model), "mu": _whole(straight.opt_state.mu, model)},
                   out_path)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def trainer_fsdp(lakh_env, tmp_path_factory):  # noqa: F811
    runs = {}
    for label, n_model in TRAINER_SHAPES.items():
        out = tmp_path_factory.mktemp(f"trainer_fsdp{label}")
        runs[label] = out, run_ranks(_trainer_fsdp_rank, out / "spawn",
                                     {"env": lakh_env, "out": out, "model_axis": n_model}, world=2 * n_model)
    return runs


@pytest.mark.parametrize("label", TRAINER_SHAPES)
def test_trainer_at_fsdp_resumes_bit_equal(trainer_fsdp, label):
    _, ranks = trainer_fsdp[label]
    for r in ranks:
        assert r["steps"] == (2, 2) and r["sharded"] > 10
        assert all(torch.equal(r["straight"][n], r["resumed"][n]) for n in r["straight"])
        assert all(torch.equal(r["gathered"][n], ranks[0]["gathered"][n]) for n in r["gathered"])
    name = "decoder.tgt_tok_emb.embedding.weight"  # (1400, 32): its rows over the data axis
    assert not torch.equal(ranks[0]["straight"][name], ranks[-1]["straight"][name])
    assert ranks[0]["straight"][name].shape[0] * 2 == ranks[0]["gathered"][name].shape[0]


@pytest.mark.parametrize("label", TRAINER_SHAPES)
def test_an_fsdp_checkpoint_loads_into_one_process(trainer_fsdp, label):
    out, ranks = trainer_fsdp[label]
    path = ckpt.latest_checkpoint(out / "a" / "lakh")
    assert path is not None and path.endswith("step-2")
    cfg = lakh_config(out, out, 2)
    model = ADTModel(cfg.model, device="cpu")
    opt_state, step, _ = ckpt.restore_checkpoint(path, model)
    assert step == 2
    assert all(torch.equal(model.state_dict()[n], w) for n, w in ranks[0]["gathered"].items())
    assert all(torch.equal(opt_state.mu[n], m) for n, m in ranks[0]["mu"].items())
    st = torch.load(f"{path}/state.pt", weights_only=True)
    assert st["model"]["decoder.tgt_tok_emb.embedding.weight"].shape == (cfg.model.tgt_vocab_size, cfg.model.d_model)
