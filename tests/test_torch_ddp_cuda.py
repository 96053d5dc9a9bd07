"""The port's data parallelism on the card. Marked `cuda`: each test skips
without a CUDA device. On the machine with the card run them with
`python -m pytest --noconftest -p no:cacheprovider tests/test_torch_ddp_cuda.py`
(`tests/conftest.py` imports JAX, which that machine does not have). This
file imports no JAX.

- One rank of NCCL (torchrun's environment for a world of 1, so
  `maybe_initialize_distributed` picks NCCL on cuda:0): the training step
  through the mesh equals the step without one.
- The sharded greedy and beam decoders on a mesh of two entries of cuda:0
  equal the one-device decode.
"""

import socket

import numpy as np
import pytest
import torch

from adt_str_tpu_torch.config import ModelConfig, TrainingConfig
from adt_str_tpu_torch.models import adt as tadt
from adt_str_tpu_torch.models import decode as tdecode
from adt_str_tpu_torch.models.adt import ADTModel, collate_token_lengths
from adt_str_tpu_torch.parallel import mesh as tmesh
from adt_str_tpu_torch.parallel import train_step as tstep
from adt_str_tpu_torch.training import optimizer as topt

pytestmark = pytest.mark.cuda

SMALL = dict(sample_rate=4000, win_length=256, time_res=0.01, input_sec=0.64, enc_layers=2, dec_layers=2, nhead=2,
             d_query=64, tgt_vocab_size=40, n_mels=16, dropout=0.0, compute_dtype="float32", max_positions=64)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _batch(cfg: ModelConfig, B: int, T: int = 24, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    wave = torch.from_numpy((rng.normal(size=(B, cfg.chunk_samples)) * 0.3).astype(np.float32))
    ends = torch.from_numpy(rng.integers(T // 2, T, B))
    pos = torch.arange(T)[None]
    tokens = torch.from_numpy(rng.integers(4, cfg.tgt_vocab_size, (B, T)))
    tokens = torch.where(pos < ends[:, None], tokens, 1)
    tokens = torch.where(pos == ends[:, None], 3, tokens)
    tokens[:, 0] = 2
    return {"wavs": wave, "tokens": tokens, "token_lengths": collate_token_lengths(ends + 1)}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_nccl_one_rank_step_equals_the_no_mesh_step(cuda, monkeypatch):
    cfg = ModelConfig(**SMALL)
    batch = {k: v.to(cuda) for k, v in _batch(cfg, 4).items()}
    keys = torch.zeros(len(tadt.dropout_sites(cfg)), 2, dtype=torch.int64)

    def one_step(mesh):
        model = ADTModel(cfg, seed=0, device=cuda)
        opt, _ = topt.make_optimizer(TrainingConfig(learning_rate=1e-3, warmup_ratio=0.0), 10, model)
        step = tstep.make_train_step(cfg, opt, device=None if mesh else cuda, mesh=mesh)
        _, m = step(tstep.init_train_state(model, opt), batch, keys)
        return m["loss"].item(), m["grad_norm"].item()

    want = one_step(None)
    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port()), "RANK": "0", "WORLD_SIZE": "1",
           "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    device = tmesh.maybe_initialize_distributed()
    try:
        mesh = tmesh.make_mesh(devices=[device])
        assert (mesh.backend, mesh.world, device) == ("nccl", 1, cuda)
        got = one_step(mesh)
    finally:
        tmesh.destroy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("beam_size", [None, 3], ids=["greedy", "beam"])
def test_sharded_decode_on_one_card_twice_equals_one_device(cuda, beam_size):
    cfg = ModelConfig(**SMALL)
    model = ADTModel(cfg, seed=1, device=cuda)
    wave = _batch(cfg, 4, seed=2)["wavs"].to(cuda)
    mesh = tmesh.make_mesh(devices=["cuda:0", "cuda:0"])
    if beam_size is None:
        one = tdecode.greedy_decode(model, wave, max_length=16)
        got = tdecode.greedy_decode_sharded(model, wave, mesh, max_length=16)
    else:
        one = tdecode.beam_search_decode(model, wave, max_length=16, beam_size=beam_size)
        got = tdecode.beam_search_decode_sharded(model, wave, mesh, max_length=16, beam_size=beam_size)
    assert got.device == cuda
    assert torch.equal(got, one)
