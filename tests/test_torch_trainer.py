"""The port's training job (`adt_str_tpu_torch.training.trainer.train` and
`python -m adt_str_tpu_torch.train`) on the CPU.

- Against the root `train.py`: a tiny fp32 TMIDT config (dropout 0, 3
  steps, an eval every step over a holdout) runs in JAX in a subprocess
  (one CPU device, so JAX takes no mesh) and in the port in this process,
  from the same initial weights (`init_model` replaced by JAX's
  `init_params`); the eval losses and the final `model.safetensors` agree.
- The Lakh path (synthesis on, dropout 0.1, the shard read with pyarrow and
  the bank with h5py): 4 straight steps equal 2 steps + auto-resume + 2
  steps bit for bit; the holdout check; SIGTERM saves and stops; the CLI.
"""

import dataclasses
import json
import logging
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from adt_str_tpu.config import FrameworkConfig as JFrameworkConfig
from adt_str_tpu.data.lakh import SCHEMA as LAKH_SCHEMA
from adt_str_tpu.models import adt as jadt
from adt_str_tpu_torch.config import FrameworkConfig
from adt_str_tpu_torch.models.adt import ADTModel
from adt_str_tpu_torch.models.convert import read_safetensors, state_dict_from_jax_params
from adt_str_tpu_torch.synth.bank import save_bank_hdf5
from adt_str_tpu_torch.training import checkpoint as ckpt
from adt_str_tpu_torch.training import trainer

REPO = Path(__file__).resolve().parent.parent
SR = 4000
MODEL = {"enc_layers": 1, "dec_layers": 1, "nhead": 2, "d_query": 16, "dropout": 0.0, "tgt_vocab_size": 1400,
         "n_mels": 16, "compute_dtype": "float32", "max_positions": 64}
SHARED = {"input_sec": 0.64, "time_res": 0.01, "win_length": 256, "sample_rate": SR}


def yaml_text(sections: dict) -> str:
    """Sections of scalars as YAML (both packages' readers take it)."""
    lines = []
    for name, fields in sections.items():
        lines.append(f"{name}:")
        lines.extend(f"  {k}: {json.dumps(v)}" for k, v in fields.items())
    return "\n".join(lines) + "\n"


def subprocess_env() -> dict:
    """This process's environment on one CPU device, the repo importable."""
    flags = " ".join(f for f in os.environ.get("XLA_FLAGS", "").split() if "device_count" not in f)
    return dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=flags,
                PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))


class StepLog(logging.Handler):
    """The `step_metrics` of the trainer's log records. Attached to the
    trainer's own logger: `train` resets the root logger's handlers."""

    def __init__(self):
        super().__init__()
        self.records: list[dict] = []

    def emit(self, record):
        if hasattr(record, "step_metrics"):
            self.records.append(record.step_metrics)

    def losses(self) -> list[dict]:
        return [r for r in self.records if "loss" in r]


@pytest.fixture
def step_log():
    handler = StepLog()
    log = logging.getLogger(trainer.__name__)
    log.addHandler(handler)
    yield handler
    log.removeHandler(handler)


# ------------------------------------------------------------ against root train.py


def write_tmidt_shard(path, n=24):
    rng = np.random.default_rng(0)
    rows = {"audio_id": [], "audio": [], "sample_rate": [], "notes": []}
    for i in range(n):
        k = int(rng.integers(1, 6))
        on = np.sort(rng.uniform(0, 0.5, k))
        rows["audio_id"].append(f"t{i}.mp3")
        rows["audio"].append((rng.normal(size=int(0.64 * SR)) * 0.2).astype(np.float32).tobytes())
        rows["sample_rate"].append(SR)
        rows["notes"].append(np.stack([on, on + 0.05, rng.choice([35, 38, 42, 51], k), rng.integers(30, 128, k)],
                                      1).astype(np.float32).tobytes())
    schema = pa.schema([pa.field("audio_id", pa.string()), pa.field("audio", pa.binary()),
                        pa.field("sample_rate", pa.int32()), pa.field("notes", pa.binary())])
    pq.write_table(pa.table(rows, schema=schema), path)


def tmidt_yaml(tmp_path, out: Path) -> Path:
    data = tmp_path / "tmidt.parquet"
    if not data.exists():
        write_tmidt_shard(data)
    path = out.with_suffix(".yaml")
    path.write_text(yaml_text({
        "shared": SHARED, "model": MODEL, "tokenizer": {"add_velocity": False},
        "training": {"batch_size": 4, "num_epochs": 2, "learning_rate": 1e-3, "warmup_ratio": 0.2, "max_steps": 3},
        "TrainDatasetConfig": {"dataset_path": str(data), "dataset_name": "TMIDT", "empty_tokens_percentage": 0.2,
                               "random_velocity_prob": 0.5, "max_tokens": 24, "holdout_fraction": 0.34},
        "logging": {"output_dir": str(out), "logging_steps": 1, "eval_every_n_steps": 1, "eval_batches": 2},
        "experiment": {"seed": 3, "run_name": "parity"}}))
    return path


def test_trainer_matches_root_train_py(tmp_path, monkeypatch, step_log):
    """Eval losses (within 1e-5 relative) and final weights (within 1e-5;
    the key thirds of the attention input biases, whose gradient is zero by
    construction, within the applied lr sum) equal root `train.py`'s on the
    same config, data and initial weights."""
    jax_yaml = tmidt_yaml(tmp_path, tmp_path / "jax")
    proc = subprocess.run([sys.executable, str(REPO / "train.py"), str(jax_yaml)], cwd=tmp_path,
                          env=subprocess_env(), capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]

    port_yaml = tmidt_yaml(tmp_path, tmp_path / "port")
    jcfg = JFrameworkConfig.from_yaml(jax_yaml)
    sd = state_dict_from_jax_params(jax.tree.map(np.asarray, jadt.init_params(jax.random.PRNGKey(3), jcfg.model)))

    def init_model(cfg, device):
        model = ADTModel(cfg.model, device=device)
        model.load_state_dict(sd, strict=True)
        return model

    monkeypatch.setattr(trainer, "init_model", init_model)
    state = trainer.train(FrameworkConfig.from_yaml(port_yaml), device="cpu")
    assert state.step == 3

    def history(side):
        return [json.loads(line) for line in (tmp_path / side / "parity" / "eval_history.jsonl").read_text().splitlines()]

    got, want = history("port"), history("jax")
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2, 3]
    np.testing.assert_allclose([r["eval_loss"] for r in got], [r["eval_loss"] for r in want], rtol=1e-5)
    assert len({r["eval_loss"] for r in got}) == 3  # the weights moved between evals

    final = {side: ckpt.latest_checkpoint(tmp_path / side / "parity") for side in ("port", "jax")}
    assert Path(final["port"]).name == Path(final["jax"]).name
    port_w = read_safetensors(Path(final["port"]) / "model.safetensors")
    jax_w = read_safetensors(Path(final["jax"]) / "model.safetensors")
    assert sorted(port_w) == sorted(jax_w)
    # the key third of each `in_proj_bias` has a gradient that is zero by
    # construction (softmax is shift-invariant): Adam steps it by +-lr on fp32
    # noise of either sign on both sides, so it is held to the applied lr sum
    # (as in test_torch_train_step.py); every other weight to 1e-5
    lr_sum = sum(r["lr"] for r in step_log.losses())  # the lr each step set for the next update
    assert lr_sum > 0
    moved = 0.0
    for n in jax_w:
        got, want = port_w[n].numpy(), jax_w[n].numpy()
        if n.endswith("in_proj_bias"):
            d = got.shape[0] // 3
            np.testing.assert_allclose(got[d : 2 * d], want[d : 2 * d], rtol=0, atol=lr_sum, err_msg=n + " k")
            got, want = np.delete(got, np.s_[d : 2 * d]), np.delete(want, np.s_[d : 2 * d])
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=n)
        moved = max(moved, float((jax_w[n] - sd[n]).abs().max()))
    assert moved > 1e-4  # three updates applied
    assert [r["step"] for r in step_log.losses()] == [1, 2, 3]


# ------------------------------------------------------------ the Lakh path


def write_lakh_shard(path, n=14):
    rng = np.random.default_rng(0)
    rows = {"midi_id": [], "segment_number": [], "notes": []}
    for i in range(n):
        k = int(rng.integers(1, 12))
        on = np.sort(rng.uniform(0, 0.5, k))
        rows["midi_id"].append(f"id{i}")
        rows["segment_number"].append(0)
        rows["notes"].append(np.stack([on, on + 0.05, rng.choice([36, 38, 42, 49], k), rng.integers(40, 127, k)],
                                      1).astype(np.float32).tobytes())
    pq.write_table(pa.table(rows, schema=LAKH_SCHEMA), path)


@pytest.fixture(scope="module")
def lakh_env(tmp_path_factory):
    d = tmp_path_factory.mktemp("lakh")
    write_lakh_shard(d / "A.parquet")
    rng = np.random.default_rng(1)
    entries = {p: {"gold": [(np.exp(-np.arange(400) / 200) * rng.normal(size=400)).astype(np.float32)
                            for _ in range(2)]} for p in [35, 36, 38, 41, 42, 46, 48, 49]}
    save_bank_hdf5(str(d / f"oneshot@{SR}.hdf5"), entries, SR)
    return d


def lakh_config(env: Path, out, max_steps, **logging_kw) -> FrameworkConfig:
    return FrameworkConfig.from_dict({
        "shared": SHARED, "model": dict(MODEL, dropout=0.1),
        "training": {"batch_size": 4, "num_epochs": 5, "learning_rate": 1e-3, "warmup_ratio": 0.0,
                     "lr_scheduler_type": "constant", "max_steps": max_steps},
        "TrainDatasetConfig": {"dataset_path": str(env), "dataset_name": "Lakh", "empty_tokens_percentage": 0.1,
                               "random_velocity_prob": 0.5, "max_tokens": 32},
        "synthetiser": {"oneshot_path": str(env / "oneshot"), "similarity_threshold": 1.0, "mixup_range": 0.5,
                        "use_fx_prob": 0.5, "max_notes": 16, "max_oneshot_sec": 0.1},
        "logging": {"output_dir": str(out), "logging_steps": 1, "save_every_n_steps": 2, **logging_kw},
        "checkpoint": {"max_checkpoints": 2, "auto_resume": True},
        "experiment": {"seed": 0, "run_name": "lakh"}})


def test_resume_is_bit_equal_to_a_straight_run(lakh_env, tmp_path, step_log):
    """14 rows of 4 make 3 steps an epoch: 4 straight steps cross into epoch
    1; the resumed run restarts mid-epoch 0 (skip 2). Losses, grad norms and
    final weights are bit-equal, at fp32 with dropout and synthesis on."""
    straight = trainer.train(lakh_config(lakh_env, tmp_path / "a", 4), device="cpu")
    straight_log = step_log.losses()
    step_log.records.clear()
    trainer.train(lakh_config(lakh_env, tmp_path / "b", 2), device="cpu")
    resumed = trainer.train(lakh_config(lakh_env, tmp_path / "b", 4), device="cpu")
    resumed_log = step_log.losses()
    assert straight.step == resumed.step == 4
    for s in (straight_log, resumed_log):
        assert [r["step"] for r in s] == [1, 2, 3, 4]
    for a, b in zip(straight_log, resumed_log):
        assert (a["loss"], a["grad_norm"], a["lr"]) == (b["loss"], b["grad_norm"], b["lr"])
    for (n, p), q in zip(straight.model.named_parameters(), resumed.model.parameters()):
        assert torch.equal(p, q), n
    assert len({r["loss"] for r in straight_log}) == 4
    names = sorted(p.name for p in (tmp_path / "b" / "lakh").glob("checkpoint-*"))
    assert names == ["checkpoint-epoch-0-step-2", "checkpoint-epoch-1-step-4"]


def test_lakh_eval_is_fixed_and_the_holdout_is_checked(lakh_env, tmp_path):
    """The Lakh eval stream renders under fixed draws: the same weights give
    the same eval loss. A holdout smaller than one eval batch raises."""
    cfg = lakh_config(lakh_env, tmp_path, 2, eval_every_n_steps=1, eval_batches=1)
    cfg.train_data = dataclasses.replace(cfg.train_data, holdout_fraction=0.3)
    trainer.train(cfg, device="cpu")
    losses = [json.loads(x)["eval_loss"] for x in (tmp_path / "lakh" / "eval_history.jsonl").read_text().splitlines()]
    assert len(losses) == 2 and all(np.isfinite(losses)) and losses[0] != losses[1]
    from adt_str_tpu_torch.data.datasets import LakhDataset
    from adt_str_tpu_torch.domain.tokenizer import MidiTokenizer
    from adt_str_tpu_torch.synth.bank import load_bank_hdf5
    from adt_str_tpu_torch.synth.render import SynthStatics

    ds = LakhDataset(cfg.train_data, MidiTokenizer(cfg.tokenizer), max_notes=cfg.synthetiser.max_notes)
    statics = SynthStatics.from_bank(load_bank_hdf5(str(lakh_env / f"oneshot@{SR}.hdf5"), 400), device="cpu")
    model = ADTModel(cfg.model, device="cpu")
    twice = [trainer.evaluate_loss(model, cfg.model, ds, 4, "cpu", cfg.synthetiser, statics, max_batches=2)
             for _ in range(2)]
    assert twice[0] == twice[1] and np.isfinite(twice[0])

    small = lakh_config(lakh_env, tmp_path / "small", 2, eval_every_n_steps=1)
    small.train_data = dataclasses.replace(small.train_data, holdout_fraction=0.2)
    with pytest.raises(ValueError, match="holdout_fraction=0.2 reserves only 2"):
        trainer.train(small, device="cpu")


def test_sigterm_saves_and_stops(lakh_env, tmp_path):
    """SIGTERM mid-run: the step in flight finishes, a checkpoint is saved at
    it and the run stops; auto-resume continues from it."""
    cfg = lakh_config(lakh_env, tmp_path, 500)

    def fire_when_installed():
        deadline = time.time() + 120
        while time.time() < deadline:
            h = signal.getsignal(signal.SIGTERM)
            if callable(h) and getattr(h, "__name__", "") == "_on_signal":
                time.sleep(0.3)
                os.kill(os.getpid(), signal.SIGTERM)
                return
            time.sleep(0.05)

    trigger = threading.Thread(target=fire_when_installed, daemon=True)
    trigger.start()
    state = trainer.train(cfg, device="cpu")
    trigger.join(timeout=5)
    assert 0 < state.step < 500
    assert signal.getsignal(signal.SIGTERM) is not None and \
        getattr(signal.getsignal(signal.SIGTERM), "__name__", "") != "_on_signal"  # the handler was put back
    latest = ckpt.latest_checkpoint(tmp_path / "lakh")
    assert latest.endswith(f"-step-{state.step}")
    again = trainer.train(lakh_config(lakh_env, tmp_path, state.step + 1), device="cpu")
    assert again.step == state.step + 1


def test_one_device_only_and_no_silent_cpu(lakh_env, tmp_path, monkeypatch):
    cfg = lakh_config(lakh_env, tmp_path, 2)
    cfg.mesh.model_axis = 2  # a model axis runs one process a rank (test_torch_tensor_parallel.py trains it)
    with pytest.raises(ValueError, match="model axis of 2 runs one process a rank"):
        trainer.train(cfg, device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "2")  # a partial torchrun environment never trains as one process
    with pytest.raises(RuntimeError, match="partial torchrun environment"):
        trainer.train(lakh_config(lakh_env, tmp_path, 2), device="cpu")
    monkeypatch.delenv("WORLD_SIZE")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        trainer.train(lakh_config(lakh_env, tmp_path, 2))


def test_train_cli(lakh_env, tmp_path):
    """`python -m adt_str_tpu_torch.train <yaml> --device cpu` trains and
    saves; without --device and without CUDA it refuses."""
    cfg = lakh_config(lakh_env, tmp_path / "out", 2)
    path = tmp_path / "lakh.yaml"
    path.write_text(yaml_text(cfg.raw))
    cmd = [sys.executable, "-m", "adt_str_tpu_torch.train", str(path)]
    proc = subprocess.run([*cmd, "--device", "cpu"], cwd=tmp_path, env=subprocess_env(), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "training complete" in proc.stderr
    assert ckpt.latest_checkpoint(tmp_path / "out" / "lakh").endswith("-step-2")
    if not torch.cuda.is_available():
        proc = subprocess.run(cmd, cwd=tmp_path, env=subprocess_env(), capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0 and "no CUDA" in proc.stderr


def test_profile_window_and_wandb_gate(lakh_env, tmp_path):
    """`logging.profile_steps` [first, last] writes a torch.profiler chrome
    trace of those steps into output_dir/profile; `use_wandb` without the
    wandb package logs locally and trains."""
    cfg = lakh_config(lakh_env, tmp_path, 3)
    cfg.logging.profile_steps = [1, 2]
    cfg.experiment.use_wandb = True
    state = trainer.train(cfg, device="cpu")
    assert state.step == 3
    (trace,) = (tmp_path / "lakh" / "profile").glob("*.json")
    assert trace.name == "trace-steps-1-2.json"
    names = {e.get("name", "") for e in json.loads(trace.read_text())["traceEvents"]}
    assert any("addmm" in n or "mm" in n for n in names)  # the steps' operators are in it
