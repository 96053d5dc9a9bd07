"""The port's beam search against the JAX package's, on the CPU: tokens
equal on tiny models across beam widths and length penalties, at exact
score ties (generator zeroed, bias tied), beam 1 equal to greedy, the
serving engine's beam equal to a direct decode (and its bounded queue), and
`run_inference` with `use_beam_search` writing the JAX harness's
`metrics.json` on the crafted model of `test_torch_eval.py`."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adt_str_tpu.config import EvalDataConfig as JEvalDataConfig
from adt_str_tpu.config import FrameworkConfig as JFrameworkConfig
from adt_str_tpu.config import InferenceConfig as JInferenceConfig
from adt_str_tpu.data import datasets as jdata
from adt_str_tpu.domain.tokenizer import MidiTokenizer as JMidiTokenizer
from adt_str_tpu.evaluation import harness as jharness
from adt_str_tpu.models import adt as jadt
from adt_str_tpu.models import decode as jdecode
from adt_str_tpu_torch.config import EvalDataConfig, FrameworkConfig, InferenceConfig
from adt_str_tpu_torch.data import datasets as tdata
from adt_str_tpu_torch.domain.tokenizer import MidiTokenizer
from adt_str_tpu_torch.evaluation import harness as tharness
from adt_str_tpu_torch.models import decode as tdecode
from adt_str_tpu_torch.serving.engine import ServingEngine
from test_torch_decode import SERVING_TINY, build, waves
from test_torch_eval import CYCLE, SR, crafted_params, port_model, tiny_config, write_shard

MAX_LEN = 16


def jax_beam(params, jcfg, w, **kw):
    return np.asarray(jdecode.beam_search_decode(params, jnp.asarray(w), jcfg, **kw))


@pytest.mark.parametrize("length_penalty", [0.0, 0.6, 1.0])
@pytest.mark.parametrize("beam_size", [1, 3, 5])
@pytest.mark.parametrize("eos_bias", [0.0, 4.0, 6.0], ids=["long", "some-eos", "early-eos"])
def test_beam_tokens_equal_jax(eos_bias, beam_size, length_penalty):
    params, jcfg, model = build(SERVING_TINY, eos_bias)
    w = waves(jcfg, n=3, seed=1)
    ref = jax_beam(params, jcfg, w, beam_size=beam_size, max_length=MAX_LEN, length_penalty=length_penalty)
    out = tdecode.beam_search_decode(model, torch.from_numpy(w), max_length=MAX_LEN, beam_size=beam_size,
                                     length_penalty=length_penalty)
    assert out.dtype == torch.int32 and out.shape == (3, MAX_LEN)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert (out[:, 0] == 2).all()
    if eos_bias == 6.0:  # every best beam finished: the frozen-beam bookkeeping ran
        assert (ref == 3).any(axis=1).all()


def tied_params(jcfg, bias_spec):
    """The test's own copy of `test_reference_equivalence._tied_params`:
    the generator's weight zeroed and its bias set to tied groups, so every
    step's logits are constant and the beams depend only on score
    arithmetic and candidate order."""
    params = jadt.init_params(jax.random.PRNGKey(3), jcfg)
    bias = np.zeros(jcfg.tgt_vocab_size, np.float32)
    for tok, val in bias_spec.items():
        bias[tok] = val
    params["decoder"]["generator"] = {"w": jnp.zeros_like(params["decoder"]["generator"]["w"]), "b": jnp.asarray(bias)}
    return params


TIES = {
    "eos-10-20": ({3: 1.0, 10: 1.0, 20: 1.0}, 3, 8),  # a 3-way exact tie tops every step
    "4-5-above-eos": ({4: 1.0, 5: 1.0, 3: 0.8}, 2, 8),  # a within-beam tie over a sub-tied EOS
}


@pytest.mark.parametrize("length_penalty", [0.0, 1.0])
@pytest.mark.parametrize("case", sorted(TIES))
def test_beam_ties_resolve_as_jax(case, length_penalty):
    spec, beam, max_len = TIES[case]
    _, jcfg, model = build(SERVING_TINY)
    params = tied_params(jcfg, spec)
    from adt_str_tpu_torch.models.convert import state_dict_from_jax_params

    model.load_state_dict(state_dict_from_jax_params(jax.tree.map(np.asarray, params)), strict=True)
    w = waves(jcfg, n=2, seed=7)
    ref = jax_beam(params, jcfg, w, beam_size=beam, max_length=max_len, length_penalty=length_penalty)
    out = tdecode.beam_search_decode(model, torch.from_numpy(w), max_length=max_len, beam_size=beam,
                                     length_penalty=length_penalty).numpy()
    np.testing.assert_array_equal(out, ref)
    if case == "4-5-above-eos" and length_penalty == 1.0:  # the JAX package's pinned tie order
        assert out.tolist() == [[2, 4, 4, 4, 4, 4, 4, 4]] * 2


@pytest.mark.parametrize("eos_bias", [0.0, 1.0, 3.0])
def test_beam_one_equals_greedy(eos_bias):
    _, jcfg, model = build(SERVING_TINY, eos_bias)
    w = torch.from_numpy(waves(jcfg, n=4, seed=2))
    greedy = tdecode.greedy_decode(model, w, max_length=MAX_LEN)
    for lp in (0.0, 1.0):
        assert torch.equal(tdecode.beam_search_decode(model, w, max_length=MAX_LEN, beam_size=1, length_penalty=lp),
                           greedy)


def test_engine_beam_equals_a_direct_decode_and_bounds_its_queue():
    """3 chunks through a beam engine (padded to bucket 4) equal a direct
    beam decode of the 3 rows; `max_queue` makes `submit_chunk` wait while
    the queue is full."""
    _, jcfg, model = build(SERVING_TINY, eos_bias=1.0)
    cfg = FrameworkConfig.from_dict({"shared": {k: SERVING_TINY[k] for k in ("input_sec", "time_res", "win_length",
                                                                             "sample_rate")},
                                     "model": SERVING_TINY, "inference": {"max_length": MAX_LEN},
                                     "serving": {"use_beam_search": True, "beam_size": 3, "length_penalty": 0.6,
                                                 "buckets": [1, 2, 4], "max_wait_ms": 200.0}})
    w = waves(jcfg, n=3, seed=4)
    direct = tdecode.beam_search_decode(model, torch.from_numpy(w), max_length=MAX_LEN, beam_size=3,
                                        length_penalty=0.6).numpy()
    with ServingEngine.from_config(model, cfg, device="cpu") as eng:
        assert (eng.use_beam, eng.beam_size, eng.length_penalty) == (True, 3, 0.6)
        futs = [eng.submit_chunk(x) for x in w]
        got = np.stack([f.result(timeout=120) for f in futs])
        assert eng.stats()["occupancy"] == {4: 1}
    np.testing.assert_array_equal(got, direct)

    gate = threading.Event()
    with ServingEngine.from_config(model, cfg, device="cpu", max_queue=2, buckets=(1,), max_wait_ms=0.0) as eng:
        real = eng._decode_device
        eng._decode_device = lambda waves_: (gate.wait(60), real(waves_))[1]  # hold the dispatcher
        futs = [eng.submit_chunk(w[0])]  # taken by the dispatcher, which then waits
        time.sleep(0.3)
        futs += [eng.submit_chunk(w[i]) for i in (1, 2)]  # fill the queue
        blocked = threading.Thread(target=lambda: futs.append(eng.submit_chunk(w[0])), daemon=True)
        blocked.start()
        blocked.join(0.5)
        assert blocked.is_alive() and eng._queue.qsize() == 2  # the fourth submit waits for room
        gate.set()
        blocked.join(60)
        assert not blocked.is_alive()
        results = [f.result(timeout=120) for f in futs]
    np.testing.assert_array_equal(results[1], direct[1])


@pytest.fixture(scope="module")
def crafted_shard(tmp_path_factory):
    from adt_str_tpu_torch.evaluation.notes import decode_tokens_to_notes

    cfg = FrameworkConfig.from_dict(tiny_config())
    pred = decode_tokens_to_notes(MidiTokenizer(cfg.tokenizer), np.asarray(CYCLE))
    path = tmp_path_factory.mktemp("shard") / "eval.parquet"
    write_shard(path, np.random.default_rng(11), pred)
    return str(path)


@pytest.mark.parametrize("beam_size", [3, None], ids=["beam3", "beam-default"])
def test_run_inference_with_beam_search_writes_what_the_jax_harness_writes(tmp_path, crafted_shard, beam_size):
    crafted = crafted_params()
    raw = tiny_config()
    cfg, jcfg = FrameworkConfig.from_dict(raw), JFrameworkConfig.from_dict(raw)
    tok, jtok = MidiTokenizer(cfg.tokenizer), JMidiTokenizer(jcfg.tokenizer)
    kw = dict(dataset_path=crafted_shard, dataset_name="ENST", sample_rate=SR, input_sec=0.64)
    inf = dict(batch_size=2, max_length=16, use_beam_search=True, beam_size=beam_size)
    got = tharness.run_inference(port_model(crafted, cfg), cfg.model, tdata.ENSTDataset(EvalDataConfig(**kw), tok),
                                 tok, InferenceConfig(**inf, output_path=str(tmp_path / "port")), device="cpu")
    ref = jharness.run_inference(crafted, jcfg.model, jdata.ENSTDataset(JEvalDataConfig(**kw), jtok), jtok,
                                 JInferenceConfig(**inf, output_path=str(tmp_path / "jax")))
    assert got == ref
    assert 0 < ref["all"]["precision"] and 0 < ref["all"]["recall"]
    for f in ("metrics.json", "confusion_matrix.csv"):
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f
