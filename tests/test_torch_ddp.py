"""Data parallelism of the port's training and eval steps, on the CPU.

Two ranks run as spawned processes over gloo (rendezvous: a `FileStore`
under `tmp_path`; every spawn is bounded by `RANK_TIMEOUT` seconds), each
on its own rows of one global batch, with the port's `make_train_step` /
`make_synth_train_step` / eval steps over `parallel/mesh.py:make_mesh()`.
They are held against JAX's 2-device data-manual `shard_map` steps
(`make_*_step(mesh=make_mesh(n_data=2, devices=jax.devices()[:2]))` on
conftest's virtual CPU devices) at fp32 on the same weights and rows. JAX
folds the shard index into the step's rng; each rank gets the site keys
(`jax_site_keys`) and render draws (`jax_render_draws`) of its shard's
folded key, so dropout 0.1 is covered too.

Tolerances: the loss to 1e-5 relative; the grad norm to 2e-4 relative
once Adam has moved the weights; every weight after 3 steps to
`WEIGHT_ATOL` = 5e-5 absolute, as `test_torch_train_step.py` holds the
one-device steps: fp32 on both sides in other summation orders, and
Adam's 1/sqrt(v) turns the noise of a near-zero gradient element into a
weight difference of up to ~6e-5 (2 of 49,152 elements of one decoder
projection here; the rest lie within 1e-5). The key third of each
`in_proj_bias`, whose gradient is zero by construction, is held to the
sum of the applied learning rates. The bf16 transport
is held per element to bf16 rounding: each rank's gradient and the sum
round once each, so the reduced element lies within 2^-7 of the sum of
the ranks' magnitudes from the exact fp32 sum.
"""

import multiprocessing
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from adt_str_tpu.config import SynthConfig as JSynthConfig
from adt_str_tpu.config import TrainingConfig as JTrainingConfig
from adt_str_tpu.parallel import mesh as jmesh
from adt_str_tpu.parallel import train_step as jstep
from adt_str_tpu.synth import render as jrender
from adt_str_tpu.synth.bank import make_test_bank
from adt_str_tpu.training import optimizer as jopt
from adt_str_tpu_torch.config import ModelConfig, SynthConfig, TrainingConfig
from adt_str_tpu_torch.models import adt as tadt
from adt_str_tpu_torch.models.adt import ADTModel
from adt_str_tpu_torch.models.convert import state_dict_from_jax_params
from adt_str_tpu_torch.parallel import fsdp
from adt_str_tpu_torch.parallel import mesh as tmesh
from adt_str_tpu_torch.parallel import train_step as tstep
from adt_str_tpu_torch.synth import render as trender
from adt_str_tpu_torch.synth.bank import n_allowed_bins
from adt_str_tpu_torch.training import optimizer as topt
from test_torch_synth import jax_render_draws
from test_torch_synth_train_step import PITCHES, SYNTH, L, SR, synth_batch
from test_torch_train_step import BASE, build, jax_site_keys, make_batch

RANK_TIMEOUT = 120  # seconds a spawn of ranks may take
WORLD = 2
STEPS = 3
B = 4  # global rows: 2 a rank
WEIGHT_ATOL = 5e-5
TRAIN = dict(learning_rate=1e-3, warmup_ratio=0.2, weight_decay=1e-2, max_grad_norm=1.0)
CASES = {  # name: (kind, dropout, ragged token lengths, ddp_loss_weighting, transport dtype)
    "plain-uniform": ("plain", 0.1, False, False, None),
    "plain-ragged": ("plain", 0.1, True, False, None),
    "plain-ragged-ddp": ("plain", 0.1, True, True, None),
    "plain-bf16": ("plain", 0.1, True, False, "bf16"),
    "synth-ragged": ("synth", 0.1, True, False, None),
}
F32_CASES = [n for n, c in CASES.items() if c[4] is None]
ONE_PROCESS = "plain-no-dropout"  # held to the port's one-process step, which cannot replay per-rank dropout


# ------------------------------------------------------------------ spawning ranks


def init_gloo(rank: int, world: int, store_path: str) -> None:
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank, world_size=world)


def run_ranks(target, tmp_path, job, world: int = WORLD, timeout: float = RANK_TIMEOUT) -> list:
    """`target(rank, world, store_path, job_path, out_path)` in `world`
    spawned processes -> what each rank saved to its `out_path`. A rank
    that fails or outlives `timeout` fails the test (and is killed)."""
    tmp_path.mkdir(parents=True, exist_ok=True)
    job_path, store = tmp_path / "job.pt", tmp_path / "store"
    torch.save(job, job_path)
    ctx = multiprocessing.get_context("spawn")
    outs = [tmp_path / f"rank{r}.pt" for r in range(world)]
    procs = [ctx.Process(target=target, args=(r, world, str(store), str(job_path), str(outs[r])), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    assert not hung, f"ranks {hung} still ran after {timeout} s"
    assert [p.exitcode for p in procs] == [0] * world, [p.exitcode for p in procs]
    return [torch.load(o, weights_only=False) for o in outs]


# ------------------------------------------------------------------ the rank side


def _bank():
    return make_test_bank(np.random.default_rng(0), PITCHES, sample_rate=SR, max_len=L)


def _tensors(b: dict) -> dict:
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32 else v) for k, v in b.items()}


def _run_case(case: dict, mesh, rank: int) -> dict:
    """3 steps of one case on this rank's rows -> losses, grad norms, weights."""
    tcfg = ModelConfig(**case["model"])
    model = ADTModel(tcfg, device="cpu")
    model.load_state_dict(case["weights"], strict=True)
    opt, _ = topt.make_optimizer(TrainingConfig(**TRAIN), total_steps=10, model=model)
    k = case["batch"]["tokens"].shape[0] // mesh.world
    rows = _tensors({key: v[rank * k : (rank + 1) * k] for key, v in case["batch"].items()})
    kw = dict(device="cpu", mesh=mesh, comm_dtype=case["comm"], ddp_loss_weighting=case["ddp"])
    if case["kind"] == "synth":
        statics = trender.SynthStatics.from_bank(_bank(), device="cpu")
        step = tstep.make_synth_train_step(tcfg, SynthConfig(**SYNTH), statics, opt, **kw)
    else:
        step = tstep.make_train_step(tcfg, opt, **kw)
    state = tstep.init_train_state(model, opt)
    losses, norms = [], []
    for i in range(STEPS):
        keys = torch.from_numpy(case["site_keys"][i][rank])
        if case["kind"] == "synth":
            state, m = step(state, rows, case["draws"][i][rank], keys)
        else:
            state, m = step(state, rows, keys)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    return {"losses": losses, "grad_norms": norms,
            "weights": {n: p.detach().clone() for n, p in model.named_parameters()}}


def _run_eval(case: dict, mesh, rank: int) -> float:
    tcfg = ModelConfig(**case["model"])
    model = ADTModel(tcfg, device="cpu")
    model.load_state_dict(case["weights"], strict=True)
    k = case["batch"]["tokens"].shape[0] // mesh.world
    rows = _tensors({key: v[rank * k : (rank + 1) * k] for key, v in case["batch"].items()})
    if case["kind"] == "synth":
        statics = trender.SynthStatics.from_bank(_bank(), device="cpu")
        step = tstep.make_synth_eval_step(tcfg, SynthConfig(**SYNTH), statics, mesh=mesh)
        return step(model, rows, case["draws"][rank]).item()
    return tstep.make_eval_step(tcfg, mesh=mesh)(model, rows).item()


def _transport(mesh, rank: int) -> dict:
    """Seeded gradients of both ranks (magnitudes over six decades) reduced
    in fp32 and through bf16 transport."""
    def grads(r):
        g = torch.Generator().manual_seed(100 + r)
        return [torch.randn(s, generator=g) * 10.0 ** torch.randint(-4, 2, s, generator=g).float()
                for s in ((7, 5), (33,), (3, 4, 6))]

    mine = grads(rank)
    return {"f32": tstep.allreduce_grads(mesh, mine, None), "bf16": tstep.allreduce_grads(mesh, mine, torch.bfloat16),
            "magnitude": [sum(g[i].abs() for g in map(grads, range(mesh.world))) for i in range(len(mine))]}


def _steps_rank(rank: int, world: int, store: str, job_path: str, out_path: str) -> None:
    torch.set_num_threads(1)
    init_gloo(rank, world, store)
    try:
        job = torch.load(job_path, weights_only=False)
        mesh = tmesh.make_mesh(devices=["cpu"])
        assert (mesh.rank, mesh.world, mesh.n_data, mesh.backend) == (rank, world, world, "gloo")
        out = {name: _run_case(case, mesh, rank) for name, case in job["cases"].items()}
        out["eval"] = {name: _run_eval(case, mesh, rank) for name, case in job["evals"].items()}
        out["transport"] = _transport(mesh, rank)
        torch.save(out, out_path)
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------------ the JAX side and the fixture


def uniform(b: dict) -> dict:
    """Every row of `b` as long as the longest (the last label EOS)."""
    tokens = b["tokens"].copy()
    T = tokens.shape[1]
    tokens[tokens == 3] = 5
    tokens[tokens == 1] = 5
    tokens[:, T - 1] = 3
    lengths = np.full(tokens.shape[0], T - 1, np.int32)
    return dict(b, tokens=tokens, token_lengths=lengths)


def jax_mesh():
    return jmesh.make_mesh(n_data=WORLD, n_model=1, devices=jax.devices()[:WORLD])


def shard_rngs(rng) -> list:
    return [jax.random.fold_in(rng, r) for r in range(WORLD)]


def jax_case(name: str, statics_pair, cache: dict) -> tuple[dict, dict]:
    """-> (JAX's 3 steps on the 2-device mesh, the ranks' job). `cache`
    keeps the mesh, the built weights and JAX's jitted steps by their
    options, so cases that differ only in data share one compile (the
    weights start replicated on the mesh, as the steps return them)."""
    kind, dropout, ragged, ddp, comm = CASES[name]
    kw = dict(BASE, dropout=dropout)
    mesh = cache.setdefault("mesh", jax_mesh())
    if dropout not in cache:
        cache[dropout] = build(kw)
    params, jcfg, model, tcfg = cache[dropout]
    weights = {k: v.clone() for k, v in model.state_dict().items()}
    tx, _ = jopt.make_optimizer(JTrainingConfig(**TRAIN), total_steps=10, params=params)
    if (kind, ddp, comm) not in cache:
        if kind == "synth":
            cache[kind, ddp, comm] = jstep.make_synth_train_step(jcfg, JSynthConfig(**SYNTH), statics_pair[0], tx,
                                                                 mesh=mesh, comm_dtype=comm, ddp_loss_weighting=ddp)
        else:
            cache[kind, ddp, comm] = jstep.make_train_step(jcfg, tx, mesh=mesh, comm_dtype=comm,
                                                           ddp_loss_weighting=ddp)
    fn = cache[kind, ddp, comm]
    params = jmesh.shard_params(mesh, jax.tree.map(np.asarray, params))  # fresh arrays: the step donates them
    b = synth_batch(B=B, seed=3) if kind == "synth" else make_batch(tcfg, B=B, seed=3)
    if not ragged:
        b = uniform(b)
    state = jstep.init_train_state(params, tx)
    losses, norms, keys, draws = [], [], [], []
    tsynth = SynthConfig(**SYNTH)
    for i in range(STEPS):
        rng = jax.random.PRNGKey(200 + i)
        state, m = fn(state, {k: jnp.asarray(v) for k, v in b.items()}, rng)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if kind == "synth":
            split = [jax.random.split(r) for r in shard_rngs(rng)]
            keys.append([jax_site_keys(k_model, jcfg) for _, k_model in split])
            draws.append([jax_render_draws(statics_pair[0], jax.random.split(k_synth, B // WORLD),
                                           n_allowed_bins(tsynth.similarity_threshold), False, tsynth.mixup_range,
                                           tsynth.use_fx_prob, (tsynth.use_reverb_prob, tsynth.use_compression_prob,
                                                                tsynth.use_limiter_prob))
                          for k_synth, _ in split])
        else:
            keys.append([jax_site_keys(r, jcfg) for r in shard_rngs(rng)])
    ref = {"losses": losses, "grad_norms": norms,
           "weights": state_dict_from_jax_params(jax.tree.map(np.asarray, state.params))}
    job = {"kind": kind, "model": kw, "weights": weights, "batch": b, "ddp": ddp, "comm": comm,
           "site_keys": keys, "draws": draws}
    return ref, job


def jax_eval(kind: str, statics_pair) -> tuple[float, dict]:
    """JAX's 2-device eval loss and the ranks' job (dropout off)."""
    kw = dict(BASE, dropout=0.0)
    params, jcfg, model, tcfg = build(kw)
    mesh = jax_mesh()
    if kind == "synth":
        b = synth_batch(B=B, seed=5)
        rng = jax.random.PRNGKey(9)
        fn = jstep.make_synth_eval_step(jcfg, JSynthConfig(**SYNTH), statics_pair[0], mesh=mesh)
        loss = float(fn(params, {k: jnp.asarray(v) for k, v in b.items()}, rng))
        tsynth = SynthConfig(**SYNTH)
        draws = [jax_render_draws(statics_pair[0], jax.random.split(r, B // WORLD),
                                  n_allowed_bins(tsynth.similarity_threshold), False, tsynth.mixup_range,
                                  tsynth.use_fx_prob, (tsynth.use_reverb_prob, tsynth.use_compression_prob,
                                                       tsynth.use_limiter_prob)) for r in shard_rngs(rng)]
    else:
        b = make_batch(tcfg, B=B, seed=5)
        loss = float(jstep.make_eval_step(jcfg, mesh=mesh)(params, {k: jnp.asarray(v) for k, v in b.items()}))
        draws = []
    return loss, {"kind": kind, "model": kw, "weights": model.state_dict(), "batch": b, "draws": draws}


@pytest.fixture(scope="module")
def ddp(tmp_path_factory):
    """JAX's results, the port's one-process steps on the global batch, and
    both ranks' results of every case (one spawn)."""
    bank = _bank()
    statics_pair = (jrender.SynthStatics.from_bank(bank), trender.SynthStatics.from_bank(bank, device="cpu"))
    refs, jobs, cache = {}, {}, {}
    for name in CASES:
        refs[name], jobs[name] = jax_case(name, statics_pair, cache)
    _, _, model, _ = build(dict(BASE, dropout=0.0))
    jobs[ONE_PROCESS] = {"kind": "plain", "model": dict(BASE, dropout=0.0), "weights": model.state_dict(),
                         "batch": make_batch(ModelConfig(**BASE), B=B, seed=3), "ddp": False, "comm": None,
                         "site_keys": [[np.zeros((len(tadt.dropout_sites(ModelConfig(**BASE))), 2), np.int64)] * WORLD]
                         * STEPS, "draws": []}
    eval_refs, eval_jobs = {}, {}
    for kind in ("plain", "synth"):
        eval_refs[kind], eval_jobs[kind] = jax_eval(kind, statics_pair)
    ranks = run_ranks(_steps_rank, tmp_path_factory.mktemp("ddp"), {"cases": jobs, "evals": eval_jobs})
    return refs, jobs, eval_refs, ranks


def lr_sum() -> float:
    _, sched = topt.make_optimizer(TrainingConfig(**TRAIN), total_steps=10, model=ADTModel(ModelConfig(**BASE),
                                                                                           device="cpu"))
    return sum(sched(i) for i in range(STEPS))


def assert_weights_close(got: dict, want: dict, atol: float) -> None:
    for n, w in want.items():
        g, w = got[n].numpy(), w.numpy()
        if n.endswith("in_proj_bias"):  # q | k | v thirds: only k is held to the lr sum
            d = g.shape[0] // 3
            np.testing.assert_allclose(g[d : 2 * d], w[d : 2 * d], atol=lr_sum(), rtol=0, err_msg=n + " k")
            g, w = np.delete(g, np.s_[d : 2 * d]), np.delete(w, np.s_[d : 2 * d])
        np.testing.assert_allclose(g, w, atol=atol, rtol=0, err_msg=n)


# ------------------------------------------------------------------ the tests


@pytest.mark.parametrize("name", F32_CASES)
def test_two_rank_steps_match_jax_shard_map(ddp, name):
    refs, _, _, ranks = ddp
    ref, got = refs[name], ranks[0][name]
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norms"], ref["grad_norms"], rtol=2e-4)
    assert_weights_close(got["weights"], ref["weights"], atol=WEIGHT_ATOL)


@pytest.mark.parametrize("name", [*CASES, ONE_PROCESS])
def test_ranks_stay_bit_equal(ddp, name):
    _, _, _, ranks = ddp
    a, b = ranks[0][name], ranks[1][name]
    assert a["losses"] == b["losses"] and a["grad_norms"] == b["grad_norms"]
    assert all(torch.equal(a["weights"][n], b["weights"][n]) for n in a["weights"])


def test_two_ranks_equal_one_process_on_the_global_batch(ddp):
    """Dropout off: the global token-weighted step over 2 ranks is the
    port's one-process step over the 4 rows, up to fp32 summation order."""
    _, jobs, _, ranks = ddp
    job = jobs[ONE_PROCESS]
    tcfg = ModelConfig(**job["model"])
    model = ADTModel(tcfg, device="cpu")
    model.load_state_dict(job["weights"])
    opt, _ = topt.make_optimizer(TrainingConfig(**TRAIN), total_steps=10, model=model)
    step, state = tstep.make_train_step(tcfg, opt, device="cpu"), tstep.init_train_state(model, opt)
    keys = torch.zeros(len(tadt.dropout_sites(tcfg)), 2, dtype=torch.int64)
    losses = []
    for _ in range(STEPS):
        state, m = step(state, _tensors(job["batch"]), keys)
        losses.append(m["loss"].item())
    np.testing.assert_allclose(ranks[0][ONE_PROCESS]["losses"], losses, rtol=1e-5)
    assert_weights_close(ranks[0][ONE_PROCESS]["weights"],
                         {n: p.detach() for n, p in model.named_parameters()}, atol=WEIGHT_ATOL)


def test_bf16_transport_within_bf16_rounding(ddp):
    refs, _, _, ranks = ddp
    got, ref = ranks[0]["plain-bf16"], refs["plain-bf16"]
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)  # the loss does not travel in bf16
    np.testing.assert_allclose(got["grad_norms"], ref["grad_norms"], rtol=2**-7)
    t = ranks[0]["transport"]
    for f32, b16, mag in zip(t["f32"], t["bf16"], t["magnitude"]):
        assert b16.dtype == torch.float32
        assert ((b16 - f32).abs() <= 2**-7 * mag).all()
    assert any(not torch.equal(a, b) for a, b in zip(t["f32"], t["bf16"]))  # the transport did round
    # bf16 differs from the f32 transport of the same step by rounding only
    np.testing.assert_allclose(got["grad_norms"], ranks[0]["plain-ragged"]["grad_norms"], rtol=2**-7)


@pytest.mark.parametrize("kind", ["plain", "synth"])
def test_eval_steps_under_a_mesh_match_jax(ddp, kind):
    _, _, eval_refs, ranks = ddp
    assert ranks[0]["eval"][kind] == ranks[1]["eval"][kind]  # every rank holds the global loss
    np.testing.assert_allclose(ranks[0]["eval"][kind], eval_refs[kind], rtol=1e-5)


def test_layouts_the_port_does_not_have_raise(monkeypatch, tmp_path):
    # the 2-D mesh is one rank a mesh entry: in one process a model axis raises, and in a process group a
    # grid that is not the world raises while the whole world builds
    with pytest.raises(ValueError, match="model axis of 2 runs one process a rank"):
        tmesh.make_mesh(n_data=1, n_model=2, devices=["cpu"])
    init_gloo(0, 1, str(tmp_path / "store"))
    try:
        with pytest.raises(ValueError, match="mesh 1 x 2 needs 2 ranks, the process group has 1"):
            tmesh.make_mesh(n_data=1, n_model=2, devices=["cpu"])
        one = tmesh.make_mesh(n_data=-1, n_model=1, devices=["cpu"])
        assert (one.n_data, one.n_model, one.model, one.global_rank) == (1, 1, None, 0)
    finally:
        dist.destroy_process_group()
    # FSDP on a one-rank data axis: the mesh records the flag and no leaf is sharded
    fsdp_mesh = tmesh.make_mesh(devices=["cpu"], fsdp=True)
    assert fsdp_mesh.fsdp and fsdp_mesh.n_data == 1
    assert fsdp.FsdpLayout({"decoder.generator.weight": (4096, 768)}, fsdp_mesh).sharded == []
    with pytest.raises(ValueError, match="unsupported grad_allreduce_dtype"):
        tstep.normalize_comm_dtype("fp16")
    assert tstep.normalize_comm_dtype("f32") is None and tstep.normalize_comm_dtype("bf16") == torch.bfloat16
    # a step runs one process a rank: a single-process mesh of two entries raises, one entry is no mesh
    _, _, model, tcfg = build(dict(BASE, dropout=0.0))
    opt, _ = topt.make_optimizer(TrainingConfig(), total_steps=10, model=model)
    with pytest.raises(ValueError, match="one process a rank"):
        tstep.make_train_step(tcfg, opt, mesh=tmesh.make_mesh(devices=["cpu", "cpu"]))
    with pytest.raises(TypeError, match="DataMesh"):
        tstep.make_eval_step(tcfg, device="cpu", mesh=object())
    b = _tensors(make_batch(tcfg, B=2))
    keys = torch.zeros(len(tadt.dropout_sites(tcfg)), 2, dtype=torch.int64)
    _, m1 = tstep.make_train_step(tcfg, opt, mesh=tmesh.make_mesh(devices=["cpu"]))(
        tstep.init_train_state(model, opt), b, keys)
    assert np.isfinite(m1["loss"].item())


@pytest.mark.parametrize("env", [{"WORLD_SIZE": "2"}, {"RANK": "0", "WORLD_SIZE": "2", "LOCAL_RANK": "0"},
                                 {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "1", "RANK": "1", "LOCAL_RANK": "1"}])
def test_a_partial_torchrun_environment_raises(monkeypatch, env):
    for v in tmesh.TORCHRUN_VARS:
        monkeypatch.delenv(v, raising=False)
    assert tmesh.maybe_initialize_distributed("cpu") is None  # no environment: one process, nothing joined
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="partial torchrun environment"):
        tmesh.maybe_initialize_distributed("cpu")
    assert not dist.is_initialized()


def test_placement_follows_the_topology(monkeypatch):
    assert tmesh.placement("cpu", 1, 2)[:2] == (torch.device("cpu"), "gloo")
    assert tmesh.placement("cuda:0", 1, 2)[:2] == (torch.device("cuda:0"), "gloo")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert tmesh.placement(None, 3, 4)[:2] == (torch.device("cuda", 3), "nccl")
    assert tmesh.placement("cuda", 1, 2)[:2] == (torch.device("cuda", 1), "nccl")
    with pytest.raises(RuntimeError, match="8 local ranks but 4 cards"):
        tmesh.placement(None, 0, 8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        tmesh.placement(None, 0, 1)
