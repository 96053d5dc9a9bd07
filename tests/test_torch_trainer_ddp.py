"""The port's training job data-parallel over two ranks, on the CPU.

- Each rank's epoch (`batches(process_index=r, process_count=2)`) is
  byte-equal to JAX's `_epoch_batches` for process r: the holdout prefix
  left out, the shuffle and the per-example seeds over the whole epoch,
  then the stride, and no bucket trims.
- `trainer.train` in two spawned ranks over gloo (a `FileStore` under
  `tmp_path`, every spawn bounded by `RANK_TIMEOUT` s) on the tiny Lakh
  config of `test_torch_trainer.py` (synthesis on, dropout 0.1 with keys
  and draws per rank): the ranks' weights stay bit-equal, rank 0 alone
  writes the checkpoints and `eval_history.jsonl`, a run resumed mid-epoch
  is bit-equal to the straight run, and a holdout smaller than one global
  eval batch raises on every rank.
- A SIGTERM to one rank stops both at the same step, after one common save.
"""

import dataclasses
import json
import logging
import multiprocessing
import os
import signal
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from adt_str_tpu.data import datasets as jdata
from adt_str_tpu_torch.training import checkpoint as ckpt
from adt_str_tpu_torch.training import trainer
from test_torch_ddp import RANK_TIMEOUT, init_gloo, run_ranks
from test_torch_train_data import assert_batches_equal, make_datasets, shards  # noqa: F401 (fixture)
from test_torch_trainer import lakh_config, lakh_env  # noqa: F401 (fixture)

WORLD = 2


@pytest.mark.parametrize("shuffle", [True, False], ids=["train", "eval-order"])
@pytest.mark.parametrize("name", ["Lakh", "TMIDT"])
def test_each_rank_loads_jax_process_stride(name, shuffle, shards):  # noqa: F811
    port, jax_ds = make_datasets(name, shards, max_tokens=160, holdout_fraction=0.25)
    for rank in range(WORLD):
        kw = dict(shuffle=shuffle, skip=1, process_index=rank, process_count=WORLD)
        got = list(port.batches(3, np.random.default_rng([5, rank]), **kw))
        want = list(jdata._epoch_batches(jax_ds, 3, np.random.default_rng([5, rank]), drop_last=True, **kw))
        assert_batches_equal(got, want)
        assert {b["tokens"].shape[1] for b in got} == {160}  # no trims: every rank's batches keep one shape
        if name == "Lakh":
            assert {b["notes"].shape[1] for b in got} == {64}


def _rank_config(env: Path, out: Path, max_steps: int, **kw):
    cfg = lakh_config(env, out, max_steps, **kw)
    cfg.training = dataclasses.replace(cfg.training, batch_size=2, num_epochs=200)  # 2 rows a rank, 4 a step
    return cfg


def _count_writes(calls: list) -> None:
    """Wrap the checkpoint writer so this rank's file writes are counted."""
    write = ckpt._replace_into

    def counted(path, fn):
        calls.append(str(path))
        return write(path, fn)

    ckpt._replace_into = counted


def _trainer_rank(rank: int, world: int, store: str, job_path: str, out_path: str) -> None:
    torch.set_num_threads(1)
    init_gloo(rank, world, store)
    try:
        job = torch.load(job_path, weights_only=False)
        env, out = Path(job["env"]), Path(job["out"])
        res = {}
        bad = _rank_config(env, out / "bad", 2, eval_every_n_steps=1)
        bad.train_data = dataclasses.replace(bad.train_data, holdout_fraction=0.25)  # 3 rows: < one 4-row batch
        try:
            trainer.train(bad, device="cpu")
        except ValueError as e:
            res["holdout_error"] = str(e)
        calls: list = []
        _count_writes(calls)
        straight_cfg = _rank_config(env, out / "a", 3, eval_every_n_steps=2, eval_batches=1)
        straight_cfg.train_data = dataclasses.replace(straight_cfg.train_data, holdout_fraction=0.3)
        straight = trainer.train(straight_cfg, device="cpu")
        half = dataclasses.replace(straight_cfg, logging=dataclasses.replace(straight_cfg.logging,
                                                                             output_dir=str(out / "b")))
        half.training = dataclasses.replace(half.training, max_steps=1)
        trainer.train(half, device="cpu")
        resumed_cfg = dataclasses.replace(half, training=dataclasses.replace(half.training, max_steps=3))
        resumed = trainer.train(resumed_cfg, device="cpu")
        res.update(writes=calls, straight_step=straight.step, resumed_step=resumed.step,
                   straight={n: p.detach().clone() for n, p in straight.model.named_parameters()},
                   resumed={n: p.detach().clone() for n, p in resumed.model.named_parameters()},
                   is_initialized=dist.is_initialized())
        torch.save(res, out_path)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def two_rank_runs(lakh_env, tmp_path_factory):  # noqa: F811
    out = tmp_path_factory.mktemp("trainer_ddp")
    ranks = run_ranks(_trainer_rank, out / "spawn", {"env": str(lakh_env), "out": str(out)})
    return out, ranks


def test_ranks_stay_bit_equal_and_resume_bit_equal(two_rank_runs):
    _, (r0, r1) = two_rank_runs
    assert r0["straight_step"] == r0["resumed_step"] == r1["straight_step"] == 3
    for run in ("straight", "resumed"):
        assert all(torch.equal(r0[run][n], r1[run][n]) for n in r0[run]), run
    assert all(torch.equal(r0["straight"][n], r0["resumed"][n]) for n in r0["straight"])
    assert r0["is_initialized"] and r1["is_initialized"]  # the caller's group outlives train()


def test_rank_zero_alone_writes(two_rank_runs):
    out, (r0, r1) = two_rank_runs
    assert r1["writes"] == [] and len(r0["writes"]) > 0
    assert {Path(w).name for w in r0["writes"]} == {"state.pt", "meta.json", "model.safetensors"}
    history = [json.loads(x) for x in (out / "a" / "lakh" / "eval_history.jsonl").read_text().splitlines()]
    assert [h["step"] for h in history] == [2] and np.isfinite(history[0]["eval_loss"])
    names = sorted(p.name for p in (out / "b" / "lakh").glob("checkpoint-*"))
    assert names == ["checkpoint-epoch-0-step-2", "checkpoint-epoch-2-step-3"]


def test_the_holdout_is_checked_at_the_global_batch(two_rank_runs):
    _, ranks = two_rank_runs
    for r in ranks:
        assert "reserves only 3 of 14 rows but one eval batch needs 4" in r["holdout_error"]


class Progress(logging.Handler):
    """Writes the last logged step to `path`."""

    def __init__(self, path: Path):
        super().__init__()
        self.path = path

    def emit(self, record):
        if "loss" in getattr(record, "step_metrics", {}):
            self.path.write_text(str(record.step_metrics["step"]))


def _signal_rank(rank: int, world: int, store: str, job_path: str, out_path: str) -> None:
    torch.set_num_threads(1)
    init_gloo(rank, world, store)
    try:
        job = torch.load(job_path, weights_only=False)
        cfg = _rank_config(Path(job["env"]), Path(job["out"]), 400, save_every_n_steps=None)
        trainer.logger.addHandler(Progress(Path(job["out"]) / f"progress{rank}"))
        state = trainer.train(cfg, device="cpu")
        torch.save({"step": state.step, "latest": ckpt.latest_checkpoint(Path(job["out"]) / "lakh")}, out_path)
    finally:
        dist.destroy_process_group()


def test_sigterm_to_one_rank_stops_both_after_a_common_save(lakh_env, tmp_path):  # noqa: F811
    """Rank 0 reports its steps; once it has taken 3, rank 1 alone gets
    SIGTERM. Both ranks stop at one step, well before the 400th, and the
    last checkpoint is that step's."""
    job_path, store = tmp_path / "job.pt", tmp_path / "store"
    torch.save({"env": str(lakh_env), "out": str(tmp_path)}, job_path)
    ctx = multiprocessing.get_context("spawn")
    outs = [tmp_path / f"rank{r}.pt" for r in range(WORLD)]
    procs = [ctx.Process(target=_signal_rank, args=(r, WORLD, str(store), str(job_path), str(outs[r])), daemon=True)
             for r in range(WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + RANK_TIMEOUT
    try:
        progress = tmp_path / "progress0"
        while time.monotonic() < deadline:
            if progress.exists() and progress.read_text() and int(progress.read_text()) >= 3:
                break
            assert all(p.is_alive() for p in procs), [p.exitcode for p in procs]
            time.sleep(0.05)
        os.kill(procs[1].pid, signal.SIGTERM)
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        assert not any(p.is_alive() for p in procs), f"ranks still ran after {RANK_TIMEOUT} s"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    assert [p.exitcode for p in procs] == [0, 0]
    r0, r1 = (torch.load(o, weights_only=False) for o in outs)
    assert r0["step"] == r1["step"] < 400
    assert r0["latest"] == r1["latest"] and r0["latest"].endswith(f"-step-{r0['step']}")
