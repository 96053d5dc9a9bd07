"""Training loop on one device: `train(cfg)`.

Port of `adt_str_tpu/training/trainer.py` (`evaluate_loss`, `train`):

- builds the tokenizer, the dataset (`LakhDataset` with the one-shot bank on
  the device, or `TMIDTDataset`), the model (`init_model`) and the optimizer
  from the merged config; the step count is analytic (`steps_per_epoch` rows
  over the batch, times `num_epochs`, capped by `max_steps`);
- Lakh: the synthesis-fused step renders each batch's audio on the device
  (`make_synth_train_step`); TMIDT: real audio (`make_train_step`);
- each step's dropout site keys and render draws come from generators
  seeded by (`experiment.seed + 1`, step index), counter-based like JAX's
  `fold_in`, so a resumed run replays the same keys;
- epoch order from `np.random.default_rng([seed, epoch])`; a resume skips
  the in-progress epoch's first batches by index (`skip`); batches are
  assembled on a prefetch thread, in pinned host memory on CUDA so that
  their copies to the device do not wait for the step before;
- auto-resume or `resume_from_checkpoint`, saves every
  `save_every_n_steps` (GC to `max_checkpoints`) and at the end; SIGTERM or
  SIGINT finish the step in flight, save and stop;
- `eval_every_n_steps`: the teacher-forced loss over the unshuffled dataset
  prefix (the `holdout_fraction` rows, which training epochs leave out),
  appended to `eval_history.jsonl`; Lakh eval audio is rendered under draws
  fixed per batch index, so every eval sees the same audio;
- deferred step logging: a logging step's loss is read at the next logging
  step (by then it is computed), never on every step, so the host keeps
  queueing work; each log record carries its numbers as
  `record.step_metrics`;
- `logging.profile_steps` traces steps [first, last] with torch.profiler
  into `output_dir/profile`; wandb when asked for and installed.

One device only: a mesh, FSDP or more than one process raises (ROADMAP's
multi-GPU DDP item).
"""

from __future__ import annotations

import json
import logging
import os
import signal
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from adt_str_tpu_torch import resolve_device
from adt_str_tpu_torch.config import FrameworkConfig, ModelConfig, SynthConfig
from adt_str_tpu_torch.data.datasets import LakhDataset, TMIDTDataset, prefetch_batches
from adt_str_tpu_torch.domain.tokenizer import MidiTokenizer
from adt_str_tpu_torch.models.adt import ADTModel, draw_site_keys
from adt_str_tpu_torch.parallel.train_step import (
    TrainState,
    init_train_state,
    make_eval_step,
    make_synth_eval_step,
    make_synth_train_step,
    make_train_step,
)
from adt_str_tpu_torch.synth.bank import OneShotBank, load_bank_hdf5, n_allowed_bins
from adt_str_tpu_torch.synth.render import SynthStatics, draw_render
from adt_str_tpu_torch.training import checkpoint as ckpt_lib
from adt_str_tpu_torch.training.optimizer import make_optimizer
from adt_str_tpu_torch.utils.misc import setup_logging

logger = logging.getLogger(__name__)

EVAL_DRAW_SEED = 0  # the eval stream's render draws: (EVAL_DRAW_SEED, batch index)


def init_model(cfg: FrameworkConfig, device) -> ADTModel:
    """The model a run starts from: seeded random weights (`experiment.seed`)."""
    return ADTModel(cfg.model, seed=cfg.experiment.seed, device=device)


def seeded_generators(seed: int, index: int, device: torch.device) -> tuple[torch.Generator, torch.Generator]:
    """(host generator, generator on `device`) seeded from (seed, index)
    alone: the site keys are host integers, the render draws device tensors."""
    host_seed, device_seed = np.random.SeedSequence([seed, index]).generate_state(2, np.uint64)
    return (torch.Generator().manual_seed(int(host_seed)),
            torch.Generator(device=device).manual_seed(int(device_seed)))


def _device_batch(batch: dict, device: torch.device) -> dict:
    return {k: v.to(device, non_blocking=True) for k, v in batch.items()}


def _host_tensors(batch: dict, pin: bool) -> dict:
    """numpy batch -> CPU tensors, pinned for asynchronous copies when `pin`."""
    out = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
    return {k: v.pin_memory() for k, v in out.items()} if pin else out


def _start_profiler(profile_steps: list[int], device: torch.device, output_dir: Path):
    """A started torch.profiler session that traces steps [first, last] of
    `profile_steps` into `output_dir/profile/trace-steps-{first}-{last}.json`.
    It starts one step early, untraced: the first device kernels of a
    session can fall outside its trace. Call `step()` after every step from
    the one it starts before."""
    first, last = profile_steps[0], profile_steps[-1]
    warm = min(1, first)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    trace = output_dir / "profile" / f"trace-steps-{first}-{last}.json"
    trace.parent.mkdir(exist_ok=True)

    def export(prof) -> None:
        prof.export_chrome_trace(str(trace))
        logger.info("profile of steps %d-%d written to %s", first, last, trace)

    profiler = torch.profiler.profile(
        activities=acts, on_trace_ready=export,
        schedule=torch.profiler.schedule(wait=0, warmup=warm, active=last - first + 1, repeat=1))
    profiler.start()
    return profiler


def _maybe_wandb(cfg: FrameworkConfig):
    if not cfg.experiment.use_wandb:
        return None
    try:
        import wandb
    except ImportError:
        logger.warning("use_wandb=true but wandb is not installed; logging locally only")
        return None
    wandb.init(project=cfg.experiment.project_name, config=cfg.raw, name=cfg.experiment.run_name)
    return wandb


def _one_device(cfg: FrameworkConfig) -> None:
    m = cfg.mesh
    replicas = int(os.environ.get("WORLD_SIZE", "1"))
    if m.model_axis > 1 or m.data_axis > 1 or m.fsdp or replicas > 1:
        raise NotImplementedError(
            f"the port trains on one device (mesh data_axis={m.data_axis}, model_axis={m.model_axis}, "
            f"fsdp={m.fsdp}, WORLD_SIZE={replicas}): multi-GPU training is ROADMAP's multi-GPU DDP item")


def evaluate_loss(model: ADTModel, model_cfg: ModelConfig, dataset, batch_size: int, device=None,
                  synth_config: Optional[SynthConfig] = None, statics: Optional[SynthStatics] = None,
                  max_batches: Optional[int] = None, eval_step=None) -> float:
    """Mean teacher-forced loss over the unshuffled dataset's first batches
    (at most `max_batches`): real-audio batches directly, note-list batches
    rendered on the device under draws fixed per batch index (pass
    `synth_config` and `statics`), so repeated calls see the same audio.
    `eval_step` reuses a step across calls. `device` None: cuda."""
    device = resolve_device(device)
    synth = synth_config is not None and statics is not None
    if eval_step is None:
        eval_step = (make_synth_eval_step(model_cfg, synth_config, statics, device=device) if synth
                     else make_eval_step(model_cfg, device=device))
    n_batches = len(dataset) // batch_size
    if max_batches is not None:
        n_batches = min(n_batches, max_batches)
    total, batches = 0.0, 0
    for batch in dataset.batches(batch_size, np.random.default_rng(0), shuffle=False):
        if batches >= n_batches:
            break
        b = _device_batch(_host_tensors(batch, pin=False), device)
        if "wavs" in b:
            total += float(eval_step(model, b))
        elif "notes" in b and synth:
            _, gen = seeded_generators(EVAL_DRAW_SEED, batches, device)
            total += float(eval_step(model, b, draw_render(statics, b["tokens"].shape[0], synth_config, gen)))
        else:
            raise ValueError("evaluate_loss needs real-audio batches (wavs) or a note-list dataset with "
                             "synth_config and statics for rendering on the device")
        batches += 1
    return total / batches if batches else 0.0


def train(cfg: FrameworkConfig, *, dataset=None, bank: Optional[OneShotBank] = None, device=None) -> TrainState:
    """Run the training job `cfg` describes on `device` (None: cuda) -> the
    final TrainState. `dataset` (a LakhDataset or TMIDTDataset) and `bank`
    (the one-shot bank of a Lakh run) replace what the config names: the
    shards (read with pyarrow) and `<oneshot_path>@<sr>.hdf5` (h5py)."""
    setup_logging(cfg.logging.log_level)
    _one_device(cfg)
    device = resolve_device(device)
    if cfg.train_data is None:
        raise ValueError("a TrainDatasetConfig section is required")
    data_cfg = cfg.train_data
    tokenizer = MidiTokenizer(cfg.tokenizer)
    lakh = data_cfg.dataset_name == "Lakh"
    statics = None
    if lakh:
        sc = cfg.synthetiser
        if sc is None:
            raise ValueError("a synthetiser section is required for the Lakh dataset")
        if bank is None:
            bank = load_bank_hdf5(f"{sc.oneshot_path}@{sc.sample_rate}.hdf5", int(sc.max_oneshot_sec * sc.sample_rate),
                                  n_allowed_bins=n_allowed_bins(sc.similarity_threshold))
        statics = SynthStatics.from_bank(bank, device=device)
        if dataset is None:
            dataset = LakhDataset(data_cfg, tokenizer, max_notes=sc.max_notes)
        w = statics.waveforms
        logger.info("Lakh dataset: %d segments, bank: %d one-shots in %d eligible bins (%.2f GiB on device)",
                    len(dataset), w.shape[0], statics.loaded_bins, w.numel() * w.element_size() / 2**30)
    elif data_cfg.dataset_name == "TMIDT":
        if dataset is None:
            dataset = TMIDTDataset(data_cfg, tokenizer)
        logger.info("TMIDT dataset: %d items", len(dataset))
    else:
        raise ValueError(f"Dataset name {data_cfg.dataset_name} not supported")
    wandb = _maybe_wandb(cfg)

    model_cfg = cfg.model
    model = init_model(cfg, device)
    logger.info("model params: %.2f M", sum(p.numel() for p in model.parameters()) / 1e6)

    batch_size = cfg.training.batch_size
    holdout_rows = int(len(dataset) * data_cfg.holdout_fraction)
    if data_cfg.holdout_fraction > 0 and cfg.logging.eval_every_n_steps and holdout_rows < batch_size:
        # the unshuffled eval stream would run past the holdout into trained rows
        raise ValueError(f"holdout_fraction={data_cfg.holdout_fraction} reserves only {holdout_rows} of "
                         f"{len(dataset)} rows but one eval batch needs {batch_size}; raise holdout_fraction "
                         "or shrink the batch")
    steps_per_epoch = max(1, (len(dataset) - holdout_rows) // batch_size)
    total_steps = int(steps_per_epoch * float(cfg.training.num_epochs))
    if cfg.training.max_steps:
        total_steps = min(total_steps, cfg.training.max_steps)
    logger.info("device=%s batch=%d steps/epoch=%d total_steps=%d", device, batch_size, steps_per_epoch, total_steps)

    opt, schedule = make_optimizer(cfg.training, total_steps, model)
    if lakh:
        step_fn = make_synth_train_step(model_cfg, cfg.synthetiser, statics, opt, device=device)
    else:
        step_fn = make_train_step(model_cfg, opt, device=device)
    state = init_train_state(model, opt)

    output_dir = Path(cfg.logging.output_dir) / cfg.experiment.run_name
    output_dir.mkdir(parents=True, exist_ok=True)
    start_step = 0
    resume = cfg.checkpoint.resume_from_checkpoint
    if not resume and cfg.checkpoint.auto_resume:
        resume = ckpt_lib.latest_checkpoint(output_dir)
    if resume:
        opt_state, start_step, _ = ckpt_lib.restore_checkpoint(resume, model, device)
        state = TrainState(model, opt_state, start_step)
        logger.info("resumed from %s at step %d", resume, start_step)

    eval_every = cfg.logging.eval_every_n_steps
    eval_step_fn = None
    if eval_every:
        eval_step_fn = (make_synth_eval_step(model_cfg, cfg.synthetiser, statics, device=device) if lakh
                        else make_eval_step(model_cfg, device=device))

    def run_eval(step_idx: int) -> None:
        eval_cap = cfg.logging.eval_batches
        if holdout_rows:  # stay inside the held-out prefix
            prefix_batches = max(1, holdout_rows // batch_size)
            eval_cap = min(eval_cap or prefix_batches, prefix_batches)
        e_loss = evaluate_loss(state.model, model_cfg, dataset, batch_size, device,
                               synth_config=cfg.synthetiser if lakh else None, statics=statics,
                               max_batches=eval_cap, eval_step=eval_step_fn)
        logger.info("eval @ step %d: eval_loss=%.4f", step_idx, e_loss,
                    extra={"step_metrics": {"step": step_idx, "eval_loss": e_loss}})
        if wandb:
            wandb.log({"eval_loss": e_loss}, step=step_idx)
        with open(output_dir / "eval_history.jsonl", "a") as f:
            f.write(json.dumps({"step": step_idx, "eval_loss": e_loss}) + "\n")

    # SIGTERM / SIGINT: finish the step in flight, save, stop
    stop_requested = {"flag": False}
    prev_handlers = {}

    def _on_signal(signum, frame):
        stop_requested["flag"] = True
        logger.info("signal %d received: will checkpoint and stop", signum)

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            prev_handlers[sig] = signal.signal(sig, _on_signal)
        except ValueError:  # not the main thread
            pass

    profile_steps = cfg.logging.profile_steps or []
    profiler = None
    step_idx = start_step
    t_last = time.perf_counter()
    pending_log = None  # (step index, metrics) of the last logging step, read at the next one
    last_logged_idx = start_step

    def flush_step_log() -> None:
        nonlocal pending_log, last_logged_idx, t_last
        if pending_log is None:
            return
        idx, m = pending_log
        pending_log = None
        loss = float(m["loss"])  # waits for step `idx` only
        now = time.perf_counter()
        sps = (idx - last_logged_idx) / max(now - t_last, 1e-9)
        last_logged_idx, t_last = idx, now
        lr = float(schedule(idx))
        numbers = {"step": idx, "loss": loss, "grad_norm": float(m["grad_norm"]), "lr": lr, "steps_per_sec": sps}
        skipped = ""
        if "notfinite_total" in m:
            numbers["notfinite_total"] = int(m["notfinite_total"])
            skipped = f" skipped={numbers['notfinite_total']}"
        logger.info("step %d/%d loss=%.4f grad_norm=%.3f lr=%.2e steps/s=%.2f%s", idx, total_steps, loss,
                    numbers["grad_norm"], lr, sps, skipped, extra={"step_metrics": numbers})
        if wandb:
            wandb.log({k: v for k, v in numbers.items() if k not in ("step", "grad_norm")}, step=idx)

    epoch = start_step // steps_per_epoch
    skip = start_step % steps_per_epoch
    last_saved_step = -1
    done = False
    pin = device.type == "cuda"

    def save(tag: str) -> None:
        nonlocal last_saved_step
        path = ckpt_lib.save_checkpoint(output_dir, state.model, state.opt_state, step_idx, epoch,
                                        max_checkpoints=cfg.checkpoint.max_checkpoints)
        last_saved_step = step_idx
        logger.info("%s checkpoint %s", tag, path)

    while not done:
        epoch_rng = np.random.default_rng([cfg.experiment.seed, epoch])
        batches = prefetch_batches(
            (_host_tensors(b, pin) for b in dataset.batches(batch_size, epoch_rng, shuffle=True, skip=skip)),
            depth=max(1, data_cfg.prefetch))
        epoch_budget = steps_per_epoch - skip
        skip = 0
        for batch in batches:
            if step_idx >= total_steps or epoch_budget <= 0:
                done = step_idx >= total_steps
                break
            epoch_budget -= 1
            b = _device_batch(batch, device)
            key_gen, draw_gen = seeded_generators(cfg.experiment.seed + 1, step_idx, device)
            site_keys = draw_site_keys(model_cfg, key_gen)
            if profile_steps and profiler is None and step_idx == max(0, profile_steps[0] - 1):
                profiler = _start_profiler(profile_steps, device, output_dir)
            if lakh:
                draws = draw_render(statics, b["tokens"].shape[0], cfg.synthetiser, draw_gen)
                state, metrics = step_fn(state, b, draws, site_keys)
            else:
                state, metrics = step_fn(state, b, site_keys)
            if profiler is not None:
                if step_idx == profile_steps[-1]:
                    if device.type == "cuda":
                        torch.cuda.synchronize(device)
                    profiler.step()  # the window's end: the trace is written
                    profiler.stop()
                    profiler = None
                else:
                    profiler.step()

            step_idx += 1
            if step_idx % cfg.logging.logging_steps == 0:
                flush_step_log()
                pending_log = (step_idx, metrics)
            if eval_every and step_idx % eval_every == 0:
                flush_step_log()
                run_eval(step_idx)
            if cfg.logging.save_every_n_steps and step_idx % cfg.logging.save_every_n_steps == 0:
                flush_step_log()
                save("saved")
            if stop_requested["flag"]:
                if last_saved_step != step_idx:
                    save("preemption")
                done = True
                break
        epoch += 1
        if step_idx >= total_steps:
            done = True

    flush_step_log()
    if last_saved_step != step_idx:
        save("training complete; final")
    else:
        logger.info("training complete (final step already checkpointed)")
    for sig, handler in prev_handlers.items():
        signal.signal(sig, handler)
    if wandb:
        wandb.finish()
    return state
