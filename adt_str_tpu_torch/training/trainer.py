"""Training loop on one device or data-parallel over ranks: `train(cfg)`.

Port of `adt_str_tpu/training/trainer.py` (`evaluate_loss`, `train`):

- builds the tokenizer, the dataset (`LakhDataset` with the one-shot bank on
  the device, or `TMIDTDataset`), the model (`init_model`) and the optimizer
  from the merged config; the step count is analytic (`steps_per_epoch` rows
  over the batch, times `num_epochs`, capped by `max_steps`);
- Lakh: the synthesis-fused step renders each batch's audio on the device
  (`make_synth_train_step`); TMIDT: real audio (`make_train_step`);
- each step's dropout site keys and render draws come from generators
  seeded by (`experiment.seed + 1`, step index[, data index]),
  counter-based like JAX's `fold_in`, so a resumed run replays the same
  keys; the data index joins the seed only when the data axis has more
  than one entry;
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

Data parallelism (the JAX trainer's multi-process logic): under torchrun
(`python -m torch.distributed.run --nproc_per_node N -m
adt_str_tpu_torch.train <yaml>`) `maybe_initialize_distributed` joins the
process group first and picks each rank's device and backend. Each rank
loads `training.batch_size` rows of its own stride a step, so the global
batch is `batch_size x world`, at which `steps_per_epoch` and the holdout
check are computed; the steps reduce over the ranks
(`parallel/train_step.py`); rank 0's weights are broadcast at start;
`evaluate_loss` gives every rank the same global loss; rank 0 alone logs,
writes the checkpoints and `eval_history.jsonl`, traces the profile window
and starts wandb; a signal sets a local flag whose global OR (one
all-reduce a step, read a step later) stops every rank after one common
save. The group the trainer joined is destroyed at the end, also on
error.

Tensor parallelism (`mesh.model_axis: n`, read as JAX reads it): the
ranks form JAX's `n_data x n_model` grid (`make_mesh`, the ranks of one
model group consecutive), each rank trains its shard of the model
(`ADTModel(..., tp=mesh.model)`), and everything keyed above by the rank
is keyed by the data index (`rank // n_model`) over `n_data`: the
generators, the dataset's stride, the global batch and the holdout check,
so both halves of one model see the same rows, keys and draws. Rank 0 of
the job alone writes; a save gathers the shards
(`training/checkpoint.py`), a resume cuts them again. On one card:
`python -m torch.distributed.run --nproc_per_node 2 -m
adt_str_tpu_torch.train <yaml with mesh.model_axis: 2> --device cuda:0`.

FSDP (`mesh.fsdp: true`, read as JAX reads it): after rank 0's weights
are broadcast, each rank cuts its shards of the data-sharded parameters
(`parallel/fsdp.py:shard_model_`) and its optimizer keeps `mu`, `nu` and
`acc` sharded alike; the steps gather the whole weights, reduce-scatter
the gradients and update the shards (`parallel/train_step.py`), the
in-training eval gathers too; a save gathers the shards (every rank takes
part) and a resume cuts them again. With one rank on the data axis nothing
is sharded. On one card: `python -m torch.distributed.run
--nproc_per_node 2 -m adt_str_tpu_torch.train <yaml with mesh.fsdp: true>
--device cuda:0` (gloo); without `--device`, NCCL a card a rank.
"""

from __future__ import annotations

import json
import logging
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
from adt_str_tpu_torch.parallel import fsdp as fsdp_lib
from adt_str_tpu_torch.parallel import mesh as mesh_lib
from adt_str_tpu_torch.parallel import tensor_parallel as tp_lib
from adt_str_tpu_torch.parallel.mesh import DataMesh
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
    """The model a run starts from: seeded random weights (`experiment.seed`),
    whole (a tensor-parallel rank cuts its shard from it)."""
    return ADTModel(cfg.model, seed=cfg.experiment.seed, device=device)


def seeded_generators(seed: int, index: int, device: torch.device,
                      rank: Optional[int] = None) -> tuple[torch.Generator, torch.Generator]:
    """(host generator, generator on `device`) seeded from (seed, index)
    and, given one, a rank alone: the site keys are host integers, the
    render draws device tensors."""
    entropy = [seed, index] if rank is None else [seed, index, rank]
    host_seed, device_seed = np.random.SeedSequence(entropy).generate_state(2, np.uint64)
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


def _rank_or_none(mesh: Optional[DataMesh]) -> Optional[int]:
    """The data index that joins a generator's seed: none on a data axis of one."""
    return None if mesh is None or mesh.world == 1 else mesh.rank


def evaluate_loss(model: ADTModel, model_cfg: ModelConfig, dataset, batch_size: int, device=None,
                  synth_config: Optional[SynthConfig] = None, statics: Optional[SynthStatics] = None,
                  max_batches: Optional[int] = None, eval_step=None, mesh: Optional[DataMesh] = None) -> float:
    """Mean teacher-forced loss over the unshuffled dataset's first batches
    (at most `max_batches`): real-audio batches directly, note-list batches
    rendered on the device under draws fixed per batch index (pass
    `synth_config` and `statics`), so repeated calls see the same audio.
    `eval_step` reuses a step across calls. `device` None: cuda. Under a
    process-group `mesh` each rank loads its stride of the prefix
    (`batch_size` rows a rank), every rank takes the same analytic number
    of batches, and each gets the same global loss (ranks and world: the
    data axis's; a model group's ranks evaluate the same rows)."""
    device = resolve_device(device)
    synth = synth_config is not None and statics is not None
    if eval_step is None:
        eval_step = (make_synth_eval_step(model_cfg, synth_config, statics, device=device, mesh=mesh) if synth
                     else make_eval_step(model_cfg, device=device, mesh=mesh))
    world, rank = (1, 0) if mesh is None else (mesh.world, mesh.rank)
    n_batches = (len(dataset) // world) // batch_size
    if max_batches is not None:
        n_batches = min(n_batches, max_batches)
    total, batches = 0.0, 0
    for batch in dataset.batches(batch_size, np.random.default_rng(0), shuffle=False, process_index=rank,
                                 process_count=world):
        if batches >= n_batches:
            break
        b = _device_batch(_host_tensors(batch, pin=False), device)
        if "wavs" in b:
            total += float(eval_step(model, b))
        elif "notes" in b and synth:
            _, gen = seeded_generators(EVAL_DRAW_SEED, batches, device, _rank_or_none(mesh))
            total += float(eval_step(model, b, draw_render(statics, b["tokens"].shape[0], synth_config, gen)))
        else:
            raise ValueError("evaluate_loss needs real-audio batches (wavs) or a note-list dataset with "
                             "synth_config and statics for rendering on the device")
        batches += 1
    return total / batches if batches else 0.0


class _WarningsOnly(logging.Filter):
    """Keeps a rank other than 0 from logging below WARNING."""

    def filter(self, record: logging.LogRecord) -> bool:
        return record.levelno >= logging.WARNING


def train(cfg: FrameworkConfig, *, dataset=None, bank: Optional[OneShotBank] = None, device=None) -> TrainState:
    """Run the training job `cfg` describes on `device` (None: cuda; under
    torchrun, `parallel/mesh.py:placement`) -> the final TrainState.
    `dataset` (a LakhDataset or TMIDTDataset) and `bank` (the one-shot bank
    of a Lakh run) replace what the config names: the shards (read with
    pyarrow) and `<oneshot_path>@<sr>.hdf5` (h5py). In a process group
    (joined here from torchrun's environment, or by the caller) it trains
    data-parallel over the ranks."""
    setup_logging(cfg.logging.log_level)
    n_model = max(1, cfg.mesh.model_axis)
    mesh_lib.check_layout(n_model)
    joined = mesh_lib.maybe_initialize_distributed(device)
    quiet = None
    try:
        device = joined if joined is not None else resolve_device(device)
        mesh = None
        if (torch.distributed.is_initialized() and torch.distributed.get_world_size() > 1) or n_model > 1:
            n_data = cfg.mesh.data_axis if cfg.mesh.data_axis > 0 else -1
            mesh = mesh_lib.make_mesh(n_data=n_data, n_model=n_model, devices=[device], fsdp=cfg.mesh.fsdp)
            if mesh.global_rank > 0:
                quiet = _WarningsOnly()
                logger.addFilter(quiet)
        data_axis = 1 if mesh is None else mesh.world
        if cfg.mesh.data_axis > 0 and cfg.mesh.data_axis != data_axis:
            raise ValueError(f"mesh.data_axis={cfg.mesh.data_axis} but the job runs {data_axis} ranks: the port "
                             "runs one rank a data-axis entry (-1 takes every rank)")
        return _train(cfg, dataset, bank, device, mesh)
    finally:
        if quiet is not None:
            logger.removeFilter(quiet)
        if joined is not None:
            mesh_lib.destroy()


def _train(cfg: FrameworkConfig, dataset, bank: Optional[OneShotBank], device: torch.device,
           mesh: Optional[DataMesh]) -> TrainState:
    if cfg.train_data is None:
        raise ValueError("a TrainDatasetConfig section is required")
    data_cfg = cfg.train_data
    world, rank = (1, 0) if mesh is None else (mesh.world, mesh.rank)  # the data axis
    lead = mesh is None or mesh.global_rank == 0  # the job's one writer
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
    wandb = _maybe_wandb(cfg) if lead else None

    model_cfg = cfg.model
    model = init_model(cfg, device)
    if mesh is not None and mesh.model is not None:
        tp_lib.shard_model_(model, mesh.model)
    logger.info("model params: %.2f M", sum(p.numel() for p in model.parameters()) / 1e6)
    mesh_lib.broadcast_model(mesh, model)  # the whole weights, before FSDP cuts them
    if mesh is not None and mesh.fsdp:
        layout = fsdp_lib.shard_model_(model, mesh)
        logger.info("FSDP: %d of %d parameters sharded over %d data ranks (%.2f M elements at rest on this rank)",
                    len(layout.sharded), len(layout.whole), mesh.world,
                    sum(p.numel() for p in model.parameters()) / 1e6)

    batch_size = cfg.training.batch_size  # rows a rank loads a step
    global_batch = batch_size * world
    holdout_rows = int(len(dataset) * data_cfg.holdout_fraction)
    if data_cfg.holdout_fraction > 0 and cfg.logging.eval_every_n_steps and holdout_rows < global_batch:
        # the unshuffled eval stream would run past the holdout into trained rows
        raise ValueError(f"holdout_fraction={data_cfg.holdout_fraction} reserves only {holdout_rows} of "
                         f"{len(dataset)} rows but one eval batch needs {global_batch}; raise holdout_fraction "
                         "or shrink the batch")
    steps_per_epoch = max(1, (len(dataset) - holdout_rows) // global_batch)
    total_steps = int(steps_per_epoch * float(cfg.training.num_epochs))
    if cfg.training.max_steps:
        total_steps = min(total_steps, cfg.training.max_steps)
    logger.info("device=%s mesh=%d x %d batch=%d a data index (%d global) steps/epoch=%d total_steps=%d", device,
                world, 1 if mesh is None else mesh.n_model, batch_size, global_batch, steps_per_epoch, total_steps)

    opt, schedule = make_optimizer(cfg.training, total_steps, model)
    dp = dict(mesh=mesh, comm_dtype=cfg.training.grad_allreduce_dtype,
              ddp_loss_weighting=cfg.training.ddp_loss_weighting)
    if lakh:
        step_fn = make_synth_train_step(model_cfg, cfg.synthetiser, statics, opt, device=device, **dp)
    else:
        step_fn = make_train_step(model_cfg, opt, device=device, **dp)
    state = init_train_state(model, opt)

    output_dir = Path(cfg.logging.output_dir) / cfg.experiment.run_name
    if lead:
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
        eval_step_fn = (make_synth_eval_step(model_cfg, cfg.synthetiser, statics, device=device, mesh=mesh) if lakh
                        else make_eval_step(model_cfg, device=device, mesh=mesh))

    def run_eval(step_idx: int) -> None:
        eval_cap = cfg.logging.eval_batches
        if holdout_rows:  # stay inside the held-out prefix
            prefix_batches = max(1, holdout_rows // global_batch)
            eval_cap = min(eval_cap or prefix_batches, prefix_batches)
        e_loss = evaluate_loss(state.model, model_cfg, dataset, batch_size, device,
                               synth_config=cfg.synthetiser if lakh else None, statics=statics,
                               max_batches=eval_cap, eval_step=eval_step_fn, mesh=mesh)
        logger.info("eval @ step %d: eval_loss=%.4f", step_idx, e_loss,
                    extra={"step_metrics": {"step": step_idx, "eval_loss": e_loss}})
        if wandb:
            wandb.log({"eval_loss": e_loss}, step=step_idx)
        if lead:  # one writer; every rank holds the same loss
            with open(output_dir / "eval_history.jsonl", "a") as f:
                f.write(json.dumps({"step": step_idx, "eval_loss": e_loss}) + "\n")

    # SIGTERM / SIGINT: finish the step in flight, save, stop. A signal lands
    # on one rank: the local flags' global OR (one all-reduce a step, read a
    # step later so it never waits on the step in flight) stops every rank at
    # the same step, into one common save.
    stop_requested = {"flag": False}
    prev_handlers = {}

    def _on_signal(signum, frame):
        stop_requested["flag"] = True
        logger.warning("signal %d received: will checkpoint and stop", signum)

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            prev_handlers[sig] = signal.signal(sig, _on_signal)
        except ValueError:  # not the main thread
            pass

    flag_device = None if mesh is None else (torch.device("cpu") if mesh.backend == "gloo" else device)
    pending_stop = None  # last step's global OR, dispatched

    def stop_now() -> bool:
        nonlocal pending_stop
        if mesh is None:
            return stop_requested["flag"]
        stop = pending_stop is not None and bool(pending_stop.item())
        flag = torch.tensor([int(stop_requested["flag"])], dtype=torch.int32, device=flag_device)
        pending_stop = mesh.all_reduce_job(flag, op=torch.distributed.ReduceOp.MAX)
        return stop

    profile_steps = (cfg.logging.profile_steps or []) if lead else []
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
    key_rank = _rank_or_none(mesh)

    def save(tag: str) -> None:
        nonlocal last_saved_step
        path = ckpt_lib.save_checkpoint(output_dir, state.model, state.opt_state, step_idx, epoch,
                                        max_checkpoints=cfg.checkpoint.max_checkpoints, mesh=mesh)
        last_saved_step = step_idx
        logger.info("%s checkpoint %s", tag, path)

    while not done:
        epoch_rng = np.random.default_rng([cfg.experiment.seed, epoch])
        batches = prefetch_batches(
            (_host_tensors(b, pin) for b in dataset.batches(batch_size, epoch_rng, shuffle=True, skip=skip,
                                                              process_index=rank, process_count=world)),
            depth=max(1, data_cfg.prefetch))
        # every rank takes the analytic steps_per_epoch batches an epoch, so
        # the ranks' epochs end together
        epoch_budget = steps_per_epoch - skip
        skip = 0
        for batch in batches:
            if step_idx >= total_steps or epoch_budget <= 0:
                done = step_idx >= total_steps
                break
            epoch_budget -= 1
            b = _device_batch(batch, device)
            key_gen, draw_gen = seeded_generators(cfg.experiment.seed + 1, step_idx, device, key_rank)
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
            if stop_now():
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
