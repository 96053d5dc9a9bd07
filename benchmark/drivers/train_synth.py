"""Synthesis-fused training (`kind: synth_notes`): the window drives
`parallel/train_step.py:make_synth_train_step`'s step back to back, each
step rendering its batch's audio on the device from note lists (K2, K3,
FX), then K1, the model's forward and backward passes with hash dropout,
and AdamW.

Set-up builds one training state from the benchmark's weights, drives it
through the mix's warm-up steps (the cell's only shapes) and hands that same
state to the window. The reference follows the warm-up steps from the same
weights and inputs; compared are each step's loss, the first gradient as
the optimizer holds it after one step (its first moment over 1 - b1), and
the parameters' change after the warm-up steps, as they stand before the
next step."""

from __future__ import annotations

import gc
import math
import queue
import sys
import threading

import numpy as np
import torch

from benchmark import roofline, traffic, tracing
from benchmark.drivers import Context, check, dims_of, now, sync
from benchmark.reference import true_fp32
from benchmark.reference.adamw import AdamW
from benchmark.reference.checks import kept_leaves, leaf_gaps
from benchmark.reference.mel import out_frames
from benchmark.reference.model import Reference
from benchmark.reference.synth import render as ref_render
from benchmark.weights import make_weights

KERNELS = {"K1": "log_mel_", "K2": "gather_blend_kernel", "K3": "place_notes_kernel"}


def make_bank(synth, rows_per_bin: int, n_bins: int, seed: int, device):
    """The one-shot bank on the device from the seed: for each of the 27
    drum pitches and each eligible similarity bin, `rows_per_bin` decaying
    noise bursts of random length (a pitch's own tone plus noise),
    zero-padded to max_oneshot_sec, in the bank's serving type (bf16 on the
    card). Rows run (pitch, bin, row). The repo holds no curated library."""
    from adt_str_tpu_torch.synth.bank import N_BINS, OneShotBank

    sr, L = synth.sample_rate, int(synth.max_oneshot_sec * synth.sample_rate)
    lo, hi = traffic.SYNTH_PITCHES
    per_pitch = n_bins * rows_per_bin
    n = (hi - lo + 1) * per_pitch
    gen = torch.Generator(device=device).manual_seed(seed)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    waves = torch.empty((n, L), dtype=dtype, device=device)
    t = torch.arange(L, device=device, dtype=torch.float32) / sr
    block = 4096
    for start in range(0, n, block):
        rows = min(block, n - start)
        pitch = torch.arange(start, start + rows, device=device) // per_pitch
        freq = (60.0 + 40.0 * pitch).float()[:, None]
        decay = 5 + 25 * torch.rand(rows, 1, generator=gen, device=device)
        length = torch.randint(L // 4, L, (rows, 1), generator=gen, device=device)
        noise = torch.randn(rows, L, generator=gen, device=device)
        w = torch.exp(-t * decay) * (0.7 * torch.sin(2 * math.pi * freq * t) + 0.3 * noise)
        waves[start : start + rows] = torch.where(torch.arange(L, device=device) < length, w, 0.0).to(dtype)
    offset = np.zeros((128, N_BINS), np.int32)
    count = np.zeros((128, N_BINS), np.int32)
    for i, p in enumerate(range(lo, hi + 1)):
        offset[p, :n_bins] = i * per_pitch + np.arange(n_bins) * rows_per_bin
        count[p, :n_bins] = rows_per_bin
    return OneShotBank(waveforms=waves, lengths=np.full(n, L, np.int32), bin_offset=offset, bin_count=count,
                       max_len=L, loaded_bins=n_bins)


def _on(batch: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def _bounds(rec: list, synth, row_len: int, frames: int, n_mels: int, bins: int) -> dict:
    """Each kernel's least time a step, from the warm-up steps' inputs."""
    chunk = synth.chunk_samples
    k2, k3 = [], []
    for hb, d, _ in rec:
        B = hb["notes"].shape[0]
        ids = torch.cat([d.main_rows.reshape(-1), d.sub_rows.reshape(-1)])
        k2.append(roofline.gather_blend(ids.numel() // 2, int(torch.unique(ids).numel()), row_len))
        onset = np.clip((hb["notes"][..., 0] * np.float32(synth.sample_rate)).astype(np.int32), 0, chunk - 1)
        slot = np.clip(hb["notes"][..., 2].astype(np.int64) - traffic.SYNTH_PITCHES[0], 0, 26)
        macs, row_samples = roofline.place_notes_work(slot, onset, hb["note_mask"], row_len, chunk, 27)
        k3.append(roofline.place_notes(macs, row_samples, B, chunk, slot.size))
    B = rec[0][0]["notes"].shape[0]
    return {"K1": roofline.log_mel(B, chunk, frames, synth.win_length, n_mels, bins),
            "K2": float(np.mean(k2)), "K3": float(np.mean(k3))}


class Program:
    """The system under test, built from the benchmark's own inputs: the
    port's config, the bank, the model and its optimizer, and the training
    step, with the feed that makes each step's rows, draws and keys."""

    def __init__(self, ctx: Context):
        from adt_str_tpu_torch.config import FrameworkConfig
        from adt_str_tpu_torch.models.adt import ADTModel
        from adt_str_tpu_torch.parallel.train_step import init_train_state, make_synth_train_step
        from adt_str_tpu_torch.synth.bank import n_allowed_bins
        from adt_str_tpu_torch.synth.render import SynthStatics
        from adt_str_tpu_torch.training.optimizer import make_optimizer

        self.ctx, self.mix, self.dev, self.seed = ctx, ctx.mix, ctx.device, ctx.seed
        cfg = self.cfg = FrameworkConfig.from_dict(ctx.config["sections"])
        self.mc, self.sc, self.tc = cfg.model, cfg.synthetiser, cfg.training
        self.B, self.T = self.tc.batch_size, cfg.train_data.max_tokens
        self.synth = {k: getattr(self.sc, k) for k in ("mixup_range", "use_fx_prob", "use_reverb_prob",
                                                       "use_compression_prob", "use_limiter_prob")}
        self.n_bins = n_allowed_bins(self.sc.similarity_threshold)
        self.rows_per_bin = ctx.config["assumed"]["bank_rows_per_bin"]
        self.n_sites = 4 * self.mc.enc_layers + 2 + 6 * self.mc.dec_layers + 1
        self.dims = dims_of(self.mc)
        self.bank = make_bank(self.sc, self.rows_per_bin, self.n_bins, self.seed, self.dev)
        self.statics = SynthStatics.from_bank(self.bank, device=self.dev)
        sync(self.dev)
        ctx.mark("bank made")
        self.weights = make_weights(self.dims, self.seed, self.dev)
        self.model = ADTModel(self.mc, seed=0, device=self.dev)
        self.model.load_state_dict(self.weights, strict=True)
        self.opt, _ = make_optimizer(self.tc, total_steps=self.mix["schedule_steps"], model=self.model)
        self.step = make_synth_train_step(self.mc, self.sc, self.statics, self.opt, device=self.dev)
        self.state = init_train_state(self.model, self.opt)
        self.draw_gen = torch.Generator(device=self.dev).manual_seed(self.seed)

    def feed(self, i: int) -> dict:
        """Step i's rows on the host, trimmed to their note bucket."""
        from adt_str_tpu_torch.data.datasets import trim_note_bucket

        hb = traffic.train_batch(self.mix, self.seed, i, self.B, self.sc.max_notes, self.T)
        return {**hb, **trim_note_bucket({"notes": hb["notes"], "note_mask": hb["note_mask"]})}

    def draws(self):
        """-> (the draws as the reference reads them, as the port takes them)."""
        from adt_str_tpu_torch.synth.fx import FxParams
        from adt_str_tpu_torch.synth.render import RenderDraws

        d = traffic.render_draws(self.draw_gen, self.B, self.n_bins, self.rows_per_bin, self.synth)
        return d, RenderDraws(d.main_rows, d.sub_rows, d.slot_ok, d.lam, d.use_fx, FxParams(**d.fx))

    def run_step(self, hb: dict, pd, i: int):
        self.state, metrics = self.step(self.state, _on(hb), pd, traffic.site_keys(self.seed, i, self.n_sites))
        return metrics

    def warm_up(self) -> dict:
        """The mix's warm-up steps (the cell's only shapes), recorded for the
        reference: each step's inputs and loss, the first moment after step 1
        and the parameters after the last."""
        rec, losses, first_moment = [], [], None
        for i in range(self.mix["warmup_steps"]):
            hb = self.feed(i)
            d, pd = self.draws()
            losses.append(self.run_step(hb, pd, i)["loss"])
            rec.append((hb, d, traffic.site_keys(self.seed, i, self.n_sites)))
            if i == 0:
                first_moment = self.state.opt_state.mu  # a later step makes new moments and leaves these
        after = {n: p.detach().clone() for n, p in self.model.named_parameters()}
        return {"rec": rec, "losses": [float(v) for v in losses], "first": first_moment, "after": after}

    def free(self) -> None:
        """Drop the program's state (its model, moments and step) before the
        reference runs; the bank and the weights are the benchmark's."""
        del self.step, self.state, self.opt, self.model
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()


def follow(prog: Program, rec: list, precision: str = "fp32", rows=None) -> dict:
    """The reference through the recorded steps from the same weights and
    inputs -> {"losses", "first" (the clipped first gradient), "after"}.
    `precision` "fp8" is the control; `rows` a slice of each batch's rows
    (the fault that leaves half the batch out)."""
    mc, sc, tc = prog.mc, prog.sc, prog.tc
    with true_fp32():
        params = {n: w.clone().requires_grad_(True) for n, w in prog.weights.items()}
        ref = Reference(params, prog.dims, precision=precision, dropout=mc.dropout)
        adam = AdamW(params, tc.learning_rate, prog.mix["schedule_steps"], tc.warmup_ratio, tc.weight_decay,
                     tc.max_grad_norm)
        losses, first = [], None
        for hb, d, keys in rec:
            t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(prog.dev) for k, v in hb.items()}
            with torch.no_grad():
                wav = ref_render(prog.statics.waveforms, t["notes"], t["note_mask"], d, sc.sample_rate,
                                 sc.chunk_samples, sc.use_fx_prob)
            loss = ref.loss(wav, t["tokens"], t["token_lengths"], [tuple(k) for k in keys.tolist()], train=True,
                            rows=rows)
            grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
            losses.append(float(loss.detach()))
            clipped = adam.step(params, grads)
            first = clipped if first is None else first
            del loss, grads, wav
    return {"losses": losses, "first": first, "after": {n: p.detach() for n, p in params.items()}}


def numbers(weights: dict, got: dict, ref: dict) -> dict:
    """The three numbers that decide `correct`: the worst step's relative
    loss gap, and the worst leaf's gap of the first gradient's norms and of
    the change's norms (leaves whose reference gradient is nought to
    rounding left out)."""
    kept = kept_leaves(ref["first"])
    grad_gap, grad_leaf = leaf_gaps(got["first"], ref["first"], kept)
    change_gap, change_leaf = leaf_gaps({n: got["after"][n] - weights[n] for n in kept},
                                        {n: ref["after"][n] - weights[n] for n in kept}, kept)
    return {"loss_gap": max(abs(p - r) / abs(r) for p, r in zip(got["losses"], ref["losses"])),
            "grad_gap": grad_gap, "change_gap": change_gap,
            "where": {"grad": grad_leaf, "change": change_leaf, "kept_leaves": len(kept)}}


def program_readings(warm: dict, b1: float) -> dict:
    """The warm-up's readings as the numbers take them: the first gradient
    is the first moment after one step over 1 - b1."""
    return {"losses": warm["losses"], "first": {n: m / (1 - b1) for n, m in warm["first"].items()},
            "after": warm["after"]}


def _close(prof: tracing.Profile):
    prof.__exit__(None, None, None)
    return tracing.summarize(prof.events(), lambda device: tracing.between(
        device, lambda e: KERNELS["K2"] in e.get("name", "")))


def run(ctx: Context) -> dict:
    mix, dev = ctx.mix, ctx.device
    prog = Program(ctx)
    ctx.mark("model and step built")
    warm = prog.warm_up()
    if ctx.trace and dev.type == "cuda":
        tracing.warm_up()
    sync(dev)
    setup_s = now() - ctx.t_start
    ctx.mark("warmed up")

    # the window: back-to-back steps, the next batch made on the host meanwhile
    feed_q: queue.Queue = queue.Queue(maxsize=mix["prefetch"])
    stop = threading.Event()

    def producer() -> None:
        i = mix["warmup_steps"]
        while not stop.is_set():
            item = prog.feed(i)
            while not stop.is_set():
                try:
                    feed_q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    pass
            i += 1

    worker = threading.Thread(target=producer, name="bench-feed", daemon=True)
    worker.start()
    peak_setup = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    summary, prof, traced, tries = None, None, 0, 0
    i, last = mix["warmup_steps"], None
    untraced_s, untraced_steps = 0.0, 0  # the window's time and steps outside the traced sessions
    t0 = now()
    seg_t, seg_i = t0, i  # the untraced stretch open now, if any
    marks = [t0]  # host time after each step's dispatch
    while now() - t0 < ctx.seconds:
        if ctx.trace and prof is None and summary is None and tries < mix["trace_tries"] \
                and now() - t0 >= mix["trace_after"] * ctx.seconds:
            sync(dev)
            untraced_s, untraced_steps, seg_t = untraced_s + now() - seg_t, untraced_steps + i - seg_i, None
            prof = tracing.Profile(ctx.work_dir / "trace.json").__enter__()
            threading.Event().wait(tracing.SETTLE_S)
        hb = feed_q.get()
        _, pd = prog.draws()
        last, i = prog.run_step(hb, pd, i)["loss"], i + 1
        marks.append(now())
        if prof is not None:
            traced += 1
            if traced == mix["trace_steps"]:
                summary, prof, traced, tries = _close(prof), None, 0, tries + 1
                seg_t, seg_i = now(), i  # _close waited for the device
    if prof is not None:  # the window closed first: read what the trace holds
        summary, prof = _close(prof), None
    sync(dev)
    t_end = now()
    window_s = t_end - t0
    if seg_t is not None:
        untraced_s, untraced_steps = untraced_s + t_end - seg_t, untraced_steps + i - seg_i
    if ctx.trace and summary is None:
        raise RuntimeError(f"no trace of {max(tries, 1)} held two of the render's launches")
    steps = i - mix["warmup_steps"]
    gaps = np.diff(marks)
    if len(gaps) >= 8:
        q = np.percentile(gaps, [5, 25, 50, 75, 95])
        half = len(marks) // 2
        print(f"window: {steps} steps; host s a step, percentiles 5-25-50-75-95: "
              + " ".join(f"{v:.4f}" for v in q)
              + f"; first half {(marks[half] - marks[0]) / half:.4f}, second {(marks[-1] - marks[half]) / (len(marks) - 1 - half):.4f}",
              file=sys.stderr)
    peak_window = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    stop.set()
    worker.join(timeout=10)
    last_finite = math.isfinite(float(last))
    b1 = prog.opt.b1
    prog.free()

    got = program_readings(warm, b1)
    t_ref = now()
    nums = numbers(prog.weights, got, follow(prog, warm["rec"]))
    print(f"reference: {len(warm['rec'])} steps in {now() - t_ref:.1f} s", file=sys.stderr)
    limits = mix["limits"]
    checks = dict(check(k, nums[k], limits[k]) for k in limits)
    correct = last_finite and all(v <= lim for v, lim in checks.values())

    mc, sc = prog.mc, prog.sc
    frames = out_frames(sc.chunk_samples, mc.win_length, mc.hop_length)
    bins = roofline.used_bins(mc.win_length, mc.n_mels, mc.sample_rate)
    units = summary["units"] if summary else 0
    per_step = _bounds(warm["rec"], sc, prog.bank.max_len, frames, mc.n_mels, bins)
    layer = {"trace": summary, "peak_mem_window": peak_window, "kernel_keys": KERNELS,
             "bound_span_s": {k: v * units for k, v in per_step.items()},
             "flops_unit": roofline.train_step_flops(prog.B, frames, prog.T - 1, mc.d_model, mc.ffn_dim,
                                                     mc.enc_layers, mc.dec_layers, mc.n_mels, mc.tgt_vocab_size),
             "unit_s": untraced_s / untraced_steps if untraced_steps else None}
    return {"e2e": {"setup_s": setup_s, "train_audio_s_per_s": steps * prog.B * sc.input_sec / window_s},
            "layer": layer, "correct": correct, "checks": checks, "attempted": steps,
            "failed": 0 if last_finite else steps, "memory_peak_bytes": max(peak_setup, peak_window),
            "trace": summary}
