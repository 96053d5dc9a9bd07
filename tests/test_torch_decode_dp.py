"""Data-parallel decode in the port, on the CPU: the sharded greedy and beam
decoders, `ServingEngine(mesh=)`, `run_inference(mesh=)` in one process and
in two gloo ranks, and `transcribe(mesh=)`.

The mesh repeats the CPU (`make_mesh(devices=["cpu", "cpu"])`), as JAX's
virtual CPU devices split one host: each entry decodes its own rows with no
collective. Decoding is row-independent, so tokens must equal the
single-device decode's and JAX's sharded decoders' on a 2-device mesh
exactly, and metrics, `metrics.json`, the confusion CSV and the MIDI file
must equal the single-device run's byte for byte.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from adt_str_tpu.models import decode as jdecode
from adt_str_tpu.parallel import mesh as jmesh
from adt_str_tpu_torch.config import EvalDataConfig, FrameworkConfig, InferenceConfig
from adt_str_tpu_torch import inference as tinference
from adt_str_tpu_torch.data import datasets as tdata
from adt_str_tpu_torch.domain.tokenizer import MidiTokenizer
from adt_str_tpu_torch.evaluation import harness as tharness
from adt_str_tpu_torch.models import decode as tdecode
from adt_str_tpu_torch.parallel import mesh as tmesh
from adt_str_tpu_torch.serving.engine import ServingEngine
from adt_str_tpu_torch.utils.midi_io import write_midi
from test_torch_ddp import init_gloo, run_ranks
from test_torch_decode import MAX_LEN, SERVING_TINY, build, waves
from test_torch_eval import SR, crafted, port_model, shard, tiny_config  # noqa: F401 (fixtures)


def cpu_mesh():
    return tmesh.make_mesh(devices=["cpu", "cpu"])


def jax_mesh():
    return jmesh.make_mesh(n_data=2, n_model=1, devices=jax.devices()[:2])


@pytest.mark.parametrize("eos_bias", [0.0, 3.0], ids=["long", "early-eos"])
def test_sharded_greedy_equals_one_device_and_jax(eos_bias):
    params, jcfg, model = build(SERVING_TINY, eos_bias)
    w = waves(jcfg, n=4)
    one = tdecode.greedy_decode(model, torch.from_numpy(w), max_length=MAX_LEN)
    got = tdecode.greedy_decode_sharded(model, torch.from_numpy(w), cpu_mesh(), max_length=MAX_LEN)
    ref = np.asarray(jdecode.greedy_decode_sharded(params, jnp.asarray(w), jcfg, jax_mesh(), max_length=MAX_LEN))
    assert got.dtype == torch.int32 and got.shape == (4, MAX_LEN)
    assert torch.equal(got, one)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("beam_size, length_penalty", [(3, 1.0), (2, 0.6)])
def test_sharded_beam_equals_one_device_and_jax(beam_size, length_penalty):
    params, jcfg, model = build(SERVING_TINY)
    w = waves(jcfg, n=4, seed=1)
    kw = dict(beam_size=beam_size, max_length=MAX_LEN, length_penalty=length_penalty)
    one = tdecode.beam_search_decode(model, torch.from_numpy(w), **kw)
    got = tdecode.beam_search_decode_sharded(model, torch.from_numpy(w), cpu_mesh(), **kw)
    ref = np.asarray(jdecode.beam_search_decode_sharded(params, jnp.asarray(w), jcfg, jax_mesh(), **kw))
    assert torch.equal(got, one)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_a_batch_the_data_axis_does_not_divide_raises():
    _, jcfg, model = build(SERVING_TINY)
    with pytest.raises(ValueError, match="not divisible by the mesh data axis"):
        tdecode.greedy_decode_sharded(model, torch.from_numpy(waves(jcfg, n=3)), cpu_mesh(), max_length=MAX_LEN)


def test_replicas_follow_the_weights():
    """A replica is the model on its own device, and a copy elsewhere that
    a write to the weights (an optimizer step, `load_state_dict`) renews."""
    _, _, model = build(SERVING_TINY)
    mesh = cpu_mesh()
    assert mesh.replica(model, torch.device("cpu")) is model
    meta = mesh.replica(model, torch.device("meta"))
    assert meta is not model and next(meta.parameters()).device.type == "meta"
    assert mesh.replica(model, torch.device("meta")) is meta
    with torch.no_grad():
        next(model.parameters()).add_(1.0)
    assert mesh.replica(model, torch.device("meta")) is not meta


@pytest.mark.parametrize("use_beam", [False, True], ids=["greedy", "beam"])
def test_engine_over_a_mesh_answers_as_one_device(use_beam):
    _, jcfg, model = build(SERVING_TINY)
    cfg = FrameworkConfig.from_dict({"shared": {k: SERVING_TINY[k] for k in ("input_sec", "time_res", "win_length",
                                                                            "sample_rate")},
                                     "model": SERVING_TINY, "inference": {"max_length": MAX_LEN}})
    w = waves(jcfg, n=3, seed=2)
    kw = dict(buckets=(2, 4), max_wait_ms=50.0, use_beam=use_beam, beam_size=2)
    with ServingEngine(model, cfg, device="cpu", **kw) as one, ServingEngine(model, cfg, mesh=cpu_mesh(), **kw) as dp:
        assert dp.device == torch.device("cpu")
        want = [f.result(timeout=120) for f in [one.submit_chunk(x) for x in w]]
        got = [f.result(timeout=120) for f in [dp.submit_chunk(x) for x in w]]
    for g, r in zip(got, want):
        np.testing.assert_array_equal(g, r)
    with pytest.raises(ValueError, match=r"buckets \[1\] not divisible by the mesh data axis \(2\)"):
        ServingEngine(model, cfg, mesh=cpu_mesh(), buckets=(1, 2, 4))


def _eval_run(crafted, shard, out, mesh=None, batch_size=3):  # noqa: F811
    cfg = FrameworkConfig.from_dict(tiny_config())
    tok = MidiTokenizer(cfg.tokenizer)
    ds = tdata.ENSTDataset(EvalDataConfig(dataset_path=shard, dataset_name="ENST", sample_rate=SR, input_sec=0.64),
                           tok)
    inf = InferenceConfig(batch_size=batch_size, max_length=16, output_path=str(out))
    return tharness.run_inference(port_model(crafted, cfg), cfg.model, ds, tok, inf, device="cpu", mesh=mesh)


def test_run_inference_over_a_mesh_writes_what_one_device_writes(tmp_path, crafted, shard):  # noqa: F811
    """Batches of 3 round up to 4 rows over the 2-entry mesh."""
    one = _eval_run(crafted, shard, tmp_path / "one")
    got = _eval_run(crafted, shard, tmp_path / "dp", mesh=cpu_mesh())
    assert got == one and 0 < one["all"]["f_measure"] < 1
    for f in ("metrics.json", "confusion_matrix.csv"):
        assert (tmp_path / "dp" / f).read_bytes() == (tmp_path / "one" / f).read_bytes(), f


def _eval_rank(rank: int, world: int, store: str, job_path: str, out_path: str) -> None:
    torch.set_num_threads(1)
    init_gloo(rank, world, store)
    try:
        job = torch.load(job_path, weights_only=False)
        mesh = tmesh.make_mesh(devices=["cpu"])
        metrics = _eval_run(job["params"], job["shard"], f"{job['out']}/rank{rank}", mesh=mesh)
        torch.save({"metrics": metrics, "n_data": mesh.n_data}, out_path)
    finally:
        dist.destroy_process_group()


def test_run_inference_in_two_ranks_equals_one_device(tmp_path, crafted, shard):  # noqa: F811
    """Each rank decodes its stripe of every 4-row batch and all-gathers the
    tokens: both ranks hold the single-device metrics; rank 0 alone writes."""
    one = _eval_run(crafted, shard, tmp_path / "one")
    ranks = run_ranks(_eval_rank, tmp_path / "spawn",
                      {"params": jax.tree.map(np.asarray, crafted), "shard": shard, "out": str(tmp_path)})
    for r in ranks:
        assert r["metrics"] == one and r["n_data"] == 2
    for f in ("metrics.json", "confusion_matrix.csv"):
        assert (tmp_path / "rank0" / f).read_bytes() == (tmp_path / "one" / f).read_bytes(), f
    assert not (tmp_path / "rank1").exists()


@pytest.mark.parametrize("hop_sec", [None, 0.32])
def test_transcribe_over_a_mesh_writes_the_same_midi(tmp_path, crafted, hop_sec):  # noqa: F811
    """3 chunks (7 with the hop) pad to the 2-entry mesh; the notes and the
    MIDI file equal the single-device transcription's."""
    cfg = FrameworkConfig.from_dict(tiny_config(inference={"max_length": 16}))
    tok = MidiTokenizer(cfg.tokenizer)
    wave = (np.random.default_rng(0).normal(size=int(1.9 * SR)) * 0.1).astype(np.float32)
    model = port_model(crafted, cfg)
    one = tinference.transcribe(model, cfg, wave, tok, device="cpu", hop_sec=hop_sec)
    got = tinference.transcribe(model, cfg, wave, tok, hop_sec=hop_sec, mesh=cpu_mesh())
    np.testing.assert_array_equal(got, one)
    assert len(one) > 0
    write_midi(str(tmp_path / "one.mid"), one, is_drum=True)
    write_midi(str(tmp_path / "dp.mid"), got, is_drum=True)
    assert (tmp_path / "one.mid").read_bytes() == (tmp_path / "dp.mid").read_bytes()
