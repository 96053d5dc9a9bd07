"""Offline transcription of song libraries (`kind: song_backlog`): client
threads chunk whole songs at the configuration's chunk length and submit
every chunk to `serving/engine.py:ServingEngine`, keeping at least
`min_queued` chunks queued beyond the batch being decoded, so every batch
fills the largest bucket; each client decodes and merges a song's notes
once its chunks are back, as `ServingEngine.transcribe` does. The engine
decodes greedily or with the mix's beam (`models/decode.py`).

Set-up warms the cell's one shape with one full batch. The window's rate
counts the chunks of the batches that completed inside it, between the
first completion and the last, over that time. Afterwards a sample of the
finished chunks, drawn from the seed, goes to the reference, which reads
the logits along each served row (`reference/checks.py:served_gap`)."""

from __future__ import annotations

import sys
import threading

import numpy as np
import torch

from benchmark import roofline, traffic, tracing
from benchmark.drivers import Context, check, dims_of, now, sync
from benchmark.reference import true_fp32
from benchmark.reference.beam import beam_search
from benchmark.reference.checks import served_gap
from benchmark.reference.mel import out_frames
from benchmark.reference.model import Reference
from benchmark.weights import make_weights

KERNELS = {"K1": "log_mel_", "K5f": "attention_fwd_kernel", "layer_norm": "layer_norm_",
           "linear": "linear_bf16_kernel", "attention_rows": "attention_rows_"}
GAP = 0.05  # seconds between completions that start a new batch


class Backlog:
    """The clients, the submitted chunks and their completions."""

    def __init__(self, engine, mix: dict, seed: int, sample_rate: int, chunk: int, bucket: int, pool: np.ndarray):
        self.engine, self.mix, self.seed, self.sr, self.chunk, self.bucket = engine, mix, seed, sample_rate, chunk, bucket
        self.pool = pool
        self.lock = threading.Condition()
        self.songs: list[tuple[np.ndarray, list]] = []  # (audio, [(start, future, chunk id, song)])
        self.submitted = self.completed = 0
        self.done_at: list[tuple[float, int]] = []  # (completion time, chunk id)
        self.min_queued: int | None = None
        self.measuring = False
        self.stop = threading.Event()
        self.hold_next_end = False  # the traced run stops the dispatcher at a batch's end ...
        self.holding = False  # ... and it waits there while this is set
        self.lengths = traffic.song_seconds(mix, seed, mix["songs"])
        self.next_song = 0
        self.threads: list[threading.Thread] = []

    def _done(self, cid: int, fut) -> None:
        t = now()
        with self.lock:
            self.completed += 1
            self.done_at.append((t, cid))
            if self.completed % self.bucket == 0:  # a batch's last answer: the dispatcher has not begun the next
                if self.measuring:
                    queued = self.submitted - self.completed - self.bucket
                    self.min_queued = queued if self.min_queued is None else min(self.min_queued, queued)
                # hold only the dispatcher: a client that adds its callback to a future already
                # done runs it itself, and the dispatcher would go on decoding in a traced session
                if self.hold_next_end and threading.current_thread() not in self.threads:
                    self.hold_next_end, self.holding = False, True
            self.lock.notify_all()
            self.lock.wait_for(lambda: not self.holding, 600.0)

    def hold(self, timeout: float) -> bool:
        """Stop the dispatcher at the end of the next batch -> whether it stopped."""
        with self.lock:
            self.hold_next_end = True
            return self.lock.wait_for(lambda: self.holding, timeout)

    def release(self) -> None:
        with self.lock:
            self.holding = False
            self.lock.notify_all()

    def submit_song(self, audio: np.ndarray) -> list:
        from adt_str_tpu_torch.domain.segmenter import chunk_wave

        futures = []
        with self.lock:
            song = len(self.songs)
            self.songs.append((audio, futures))
        for start, piece, _ in chunk_wave(audio, self.chunk):
            with self.lock:
                cid = self.submitted
                self.submitted += 1
            fut = self.engine.submit_chunk(piece)
            fut.add_done_callback(lambda f, cid=cid: self._done(cid, f))
            futures.append((start, fut, cid, song))
        return futures

    def _client(self) -> None:
        from adt_str_tpu_torch.evaluation.notes import decode_tokens_to_notes, merge_chunk_notes

        target = self.mix["min_queued"] + 2 * self.bucket
        while not self.stop.is_set():
            with self.lock:
                while not self.stop.is_set() and self.submitted - self.completed >= target:
                    self.lock.wait(0.1)
                if self.stop.is_set():
                    return
                index = self.next_song
                self.next_song += 1
            audio = traffic.song(self.pool, self.seed, index, float(self.lengths[index % len(self.lengths)]), self.sr)
            futures = self.submit_song(audio)
            notes = []
            for start, fut, _, _ in futures:
                chunk_notes = decode_tokens_to_notes(self.engine.tokenizer, fut.result())
                if len(chunk_notes):
                    chunk_notes[:, 0:2] += start / self.sr
                    notes.append(chunk_notes)
            merge_chunk_notes(notes)

    def start(self, clients: int) -> None:
        for k in range(clients):
            th = threading.Thread(target=self._client, name=f"bench-client-{k}", daemon=True)
            th.start()
            self.threads.append(th)

    def wait_completed(self, n: int, timeout: float) -> bool:
        with self.lock:
            return self.lock.wait_for(lambda: self.completed >= n, timeout)

    def close(self, timeout: float) -> None:
        self.stop.set()
        with self.lock:
            self.lock.notify_all()
        for th in self.threads:
            th.join(timeout)

    def chunk_of(self, cid: int) -> tuple[np.ndarray, object]:
        for audio, futures in self.songs:
            for start, fut, c, _ in futures:
                if c == cid:
                    piece = audio[start : start + self.chunk]
                    return np.pad(piece, (0, self.chunk - len(piece))), fut
        raise KeyError(cid)


def batches(done_at: list[tuple[float, int]], lo: float, hi: float) -> list[tuple[float, int]]:
    """Completions inside (lo, hi] grouped into batches -> [(end time, chunks)]:
    a batch's chunks resolve together; a gap of GAP seconds starts the next."""
    times = sorted(t for t, _ in done_at if lo < t <= hi)
    out: list[list] = []
    for t in times:
        if out and t - out[-1][0] <= GAP:
            out[-1][0], out[-1][1] = t, out[-1][1] + 1
        else:
            out.append([t, 1])
    return [(t, n) for t, n in out]


def window_rate(groups: list[tuple[float, int]], audio_s: float) -> float | None:
    """Audio seconds a second between the first and the last completion in
    the window: the chunks of every batch after the first, over that time."""
    if len(groups) < 2:
        return None
    return sum(n for _, n in groups[1:]) * audio_s / (groups[-1][0] - groups[0][0])


def _bounds(B: int, K: int, step_ids: list, encodes: int, frames: int, mc) -> dict:
    """Each kernel's least time for `encodes` encodes of a B-chunk batch and
    the decode steps `step_ids` of K beams (1: greedy)."""
    d, H, layers = mc.d_model, mc.nhead, mc.dec_layers
    hd, R = d // H, B * K
    bins = roofline.used_bins(mc.win_length, mc.n_mels, mc.sample_rate)
    rows = B * frames  # the encoder's LayerNorms: two a layer with the residual fused, then the last
    ln = encodes * (mc.enc_layers * 2 * roofline.layer_norm(rows, d, fused_add=True) + roofline.layer_norm(rows, d)) \
        + len(step_ids) * layers * 3 * roofline.layer_norm(R, d, fused_add=True)
    lin = len(step_ids) * (layers * (roofline.linear(R, 3 * d, d) + 3 * roofline.linear(R, d, d)
                                     + roofline.linear(R, mc.ffn_dim, d) + roofline.linear(R, d, mc.ffn_dim))
                           + roofline.linear(R, mc.tgt_vocab_size, d))
    rows_attn = sum(roofline.attention_rows(R * H, 1, s + 1, hd) + roofline.attention_rows(B * H, K, frames, hd)
                    for s in step_ids)
    return {"K1": encodes * roofline.log_mel(B, mc.chunk_samples, frames, mc.win_length, mc.n_mels, bins),
            "K5f": encodes * mc.enc_layers * roofline.attention_fwd(B * H, frames, frames, hd),
            "layer_norm": ln, "linear": lin, "attention_rows": layers * rows_attn}


def _flops(B: int, K: int, step_ids: list, encodes: int, frames: int, mc) -> float:
    """The products of `encodes` encodes (with their cross K and V) and of the decode steps `step_ids`."""
    return encodes * (roofline.encoder_flops(B, frames, mc.d_model, mc.ffn_dim, mc.enc_layers, mc.n_mels)
                      + roofline.cross_kv_flops(B, frames, mc.d_model, mc.dec_layers)) + sum(
        roofline.decode_step_flops(B * K, s + 1, frames, mc.d_model, mc.ffn_dim, mc.dec_layers, mc.tgt_vocab_size)
        for s in step_ids)


def whole_batch(device: list, token_bytes: int, steps: int) -> dict | None:
    """The traced span of one batch: from its encode's first kernel (K1) to
    the end of the copy of its tokens to the host, holding its `steps` exit
    tests (a one-byte copy to the host before each decode step) -> {"lo",
    "hi", "units" (1)}, or None where the trace lost part of it."""
    starts = sorted(float(e["ts"]) for e in device if KERNELS["K1"] in e.get("name", ""))
    if not starts:
        return None

    def copies(n):
        return sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))) for e in device
                      if e.get("cat") == "gpu_memcpy" and "DtoH" in e.get("name", "")
                      and e.get("args", {}).get("bytes") == n and float(e["ts"]) > starts[0])

    done = copies(token_bytes)
    tests = len([t for t, _ in copies(1) if done and t < done[0][0]])
    if not done or tests != steps:
        print(f"trace: a batch's span needs its token copy and {steps} exit tests; found "
              f"{len(done)} and {tests}", file=sys.stderr)
        return None
    return {"lo": starts[0], "hi": done[0][1], "units": 1}


def trace_batch(ctx: Context, log: "Backlog", engine, token_bytes: int, steps: int, timeout: float) -> dict:
    """Profile one whole batch: hold the dispatcher at a batch's end, start
    the profiler and let it settle, let one batch run, hold again at its end,
    and read the trace while the dispatcher waits -> {"summary" (or None),
    "stats" (the engine's counters over the batch), "held", "resumed" (the
    host times at which the dispatcher stopped and went on)}."""
    if not log.hold(timeout):
        raise RuntimeError("the dispatcher did not reach a batch's end to trace")
    held = now()
    before = engine.stats()
    with tracing.Profile(ctx.work_dir / "trace.json") as prof:
        threading.Event().wait(tracing.SETTLE_S)
        with log.lock:
            log.hold_next_end = True
        log.release()
        if not log.hold(timeout):
            raise RuntimeError("the traced batch did not end")
    t_read = now()
    summary = tracing.summarize(prof.events(), lambda device: whole_batch(device, token_bytes, steps))
    print(f"trace: read in {now() - t_read:.1f} s", file=sys.stderr)
    log.release()
    # the engine counts a batch once its answers are out: wait for the held batch's and the traced one's
    while engine.stats()["n_batches"] < before["n_batches"] + 2 and now() < held + timeout:
        threading.Event().wait(0.005)
    after = engine.stats()
    return {"summary": summary, "stats": {k: after[k] - before[k] for k in ("decode_seconds", "n_batches")},
            "held": held, "resumed": now()}


def untraced_period(groups: list[tuple[float, int]], held: float | None, resumed: float | None) -> float | None:
    """Seconds from one batch's completion to the next, over the pairs that
    no trace touched: both before the dispatcher was held, or both after it
    went on (the first batch after it began then)."""
    ends = [t for t, _ in groups]
    if held is None:
        pairs = list(zip(ends, ends[1:]))
    else:
        pre = [t for t in ends if t <= held + GAP]
        post = [t for t in ends if t > resumed]
        pairs = list(zip(pre, pre[1:])) + list(zip(post, post[1:]))
    return sum(b - a for a, b in pairs) / len(pairs) if pairs else None


def beam_rule(cfg, beam: bool) -> dict:
    """The decode the configuration states: beams, tokens, length penalty."""
    return {"K": cfg.serving.beam_size if beam else 1,
            "max_length": cfg.serving.max_length or cfg.inference.max_length,
            "bos": cfg.tokenizer.BOS_token, "eos": cfg.tokenizer.EOS_token,
            "length_penalty": cfg.serving.length_penalty if beam else 0.0}


def reference_beams(weights: dict, dims: dict, waves: list, rule: dict, block: int, device,
                    precision: str = "fp32") -> torch.Tensor:
    """The reference's own decode of each chunk by the rule -> (n, K,
    max_length) rows, best first. `precision` "fp8" is the control."""
    rows = []
    with true_fp32(), torch.no_grad():
        ref = Reference(weights, dims, precision=precision)
        for i in range(0, len(waves), block):
            w = torch.from_numpy(np.stack(waves[i : i + block])).to(device)
            rows.append(beam_search(ref, w, rule["K"], rule["max_length"], rule["bos"], rule["eos"],
                                    rule["length_penalty"]).cpu())
    return torch.cat(rows)


def row_gaps(weights: dict, dims: dict, waves: list, rows: list, rule: dict, block: int, device) -> torch.Tensor:
    """Each served row's widest gap below the reference's K-th best logit -> (n,)."""
    out = []
    with true_fp32(), torch.no_grad():
        ref = Reference(weights, dims)
        for i in range(0, len(rows), block):
            w = torch.from_numpy(np.stack(waves[i : i + block])).to(device)
            tok = torch.from_numpy(np.stack(rows[i : i + block]).astype(np.int64)).to(device)
            out.append(served_gap(ref.causal_logits(w, tok), tok[:, 1:], rule["K"]).cpu())
    return torch.cat(out)


def sample(finished: list[int], seed: int, n: int) -> list[int]:
    """The seed's sample of n finished chunks' ids, in order."""
    rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 5])
    return sorted(rng.choice(finished, size=min(n, len(finished)), replace=False).tolist())


def build(ctx: Context) -> dict:
    """The system under test from the cell's configuration and the seed:
    the benchmark's weights loaded into the port's model, and its serving
    engine; with the decode rule and the mix's segment pool."""
    from adt_str_tpu_torch.config import FrameworkConfig
    from adt_str_tpu_torch.models.adt import ADTModel
    from adt_str_tpu_torch.serving.engine import ServingEngine

    cfg = FrameworkConfig.from_dict(ctx.config["sections"])
    dims = dims_of(cfg.model)
    weights = make_weights(dims, ctx.seed, ctx.device, eos_bias=ctx.config["assumed"]["eos_logit_bias"],
                           eos=cfg.tokenizer.EOS_token)
    model = ADTModel(cfg.model, seed=0, device=ctx.device)
    model.load_state_dict(weights, strict=True)
    engine = ServingEngine.from_config(model, cfg, device=ctx.device, use_beam=ctx.mix["beam"])
    sr = cfg.shared.sample_rate
    return {"cfg": cfg, "dims": dims, "weights": weights, "model": model, "engine": engine,
            "rule": beam_rule(cfg, ctx.mix["beam"]),
            "pool": traffic.segment_pool(ctx.seed, ctx.mix["pool"], cfg.shared.input_sec, sr)}


def run(ctx: Context) -> dict:
    mix, dev, seed = ctx.mix, ctx.device, ctx.seed
    system = build(ctx)
    cfg, dims, weights, model, engine, rule, pool = (system[k] for k in ("cfg", "dims", "weights", "model", "engine",
                                                                           "rule", "pool"))
    mc, K = cfg.model, rule["K"]
    bucket, chunk, sr = engine.buckets[-1], engine.chunk_samples, cfg.shared.sample_rate
    steps = engine.max_length - 1
    log = Backlog(engine, mix, seed, sr, chunk, bucket, pool)

    # the tracer loads while the dispatcher is idle: a session that starts or
    # stops while another thread runs operations can abort the process
    if ctx.trace and dev.type == "cuda":
        tracing.warm_up()
    # warm-up: one full batch of the largest bucket; the clients fill the queue meanwhile
    warm_futures = [engine.submit_chunk(w) for w in pool[:bucket]]
    log.start(mix["clients"])
    ctx.mark("model and engine built")
    for f in warm_futures:
        f.result()
    sync(dev)
    t0 = now()
    setup_s = t0 - ctx.t_start
    ctx.mark("warmed up")
    stats0 = engine.stats()
    if dev.type == "cuda":
        peak_setup = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    else:
        peak_setup = 0
    with log.lock:
        log.measuring = True
        done0 = log.completed

    summary, profiled, held, resumed = None, {"decode_seconds": 0.0, "n_batches": 0}, None, None
    if ctx.trace:  # a whole batch traced, after two untraced ones; again where the trace lost part of it
        log.wait_completed(done0 + 2 * bucket, ctx.seconds)
        for _ in range(mix["trace_tries"]):
            got = trace_batch(ctx, log, engine, bucket * engine.max_length * 4, steps, 600.0)
            summary, held, resumed = got["summary"], held or got["held"], got["resumed"]
            profiled = {k: profiled[k] + got["stats"][k] for k in profiled}
            if summary is not None:
                break
        if summary is None:
            raise RuntimeError(f"no trace of {mix['trace_tries']} held a whole batch")
    remaining = t0 + ctx.seconds - now()
    if remaining > 0:
        threading.Event().wait(remaining)
    t1 = t0 + ctx.seconds
    with log.lock:
        log.measuring = False
        groups = batches(log.done_at, t0, t1)
        min_queued = log.min_queued
    stats1 = engine.stats()
    peak_window = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    rate = window_rate(groups, cfg.shared.input_sec)
    full = all(n == bucket for _, n in groups) and set(stats1["occupancy"]) - set(stats0["occupancy"]) <= {bucket}
    full = full and stats1["occupancy"].get(bucket, 0) - stats0["occupancy"].get(bucket, 0) == \
        stats1["n_batches"] - stats0["n_batches"]

    # the window has closed: the clients stop, the engine answers what it took
    log.close(timeout=1.0)
    engine.close(timeout=600.0)
    for th in log.threads:
        th.join(600.0)
    del engine, model, system
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the reference reads a seeded sample of the finished chunks
    with log.lock:
        finished = sorted(cid for t, cid in log.done_at if t0 < t <= t1)
    failed = sum(1 for cid in finished if log.chunk_of(cid)[1].exception() is not None)
    pick = sample(finished, seed, mix["check_chunks"])
    waves, rows = [], []
    for cid in pick:
        wave, fut = log.chunk_of(cid)
        waves.append(wave)
        rows.append(fut.result())
    t_ref = now()
    read = {"served_gap": float(row_gaps(weights, dims, waves, rows, rule, mix["check_block"], dev).max())} \
        if pick else {}
    print(f"reference: {len(pick)} chunks in {now() - t_ref:.1f} s", file=sys.stderr)
    checks = dict(check(k, read.get(k, float("inf")), lim) for k, lim in mix["limits"].items())
    correct = bool(pick) and failed == 0 and all(v <= lim for v, lim in checks.values())

    frames = out_frames(chunk, mc.win_length, mc.hop_length)
    n_batches = stats1["n_batches"] - stats0["n_batches"]
    traced = 1 if summary else 0
    layer = {"trace": summary, "peak_mem_window": peak_window, "kernel_keys": KERNELS,
             "bound_span_s": _bounds(bucket, K, list(range(steps)) * traced, traced, frames, mc),
             "flops_unit": _flops(bucket, K, list(range(steps)), 1, frames, mc),
             "unit_s": untraced_period(groups, held, resumed),
             "decode_step_s": (stats1["decode_seconds"] - stats0["decode_seconds"] - profiled["decode_seconds"])
             / max((n_batches - profiled["n_batches"]) * steps, 1)}
    if not full or min_queued is None or min_queued < mix["min_queued"] or rate is None:
        raise RuntimeError(f"the backlog did not hold: batches {groups}, occupancy {stats0['occupancy']} -> "
                           f"{stats1['occupancy']}, fewest queued at a batch's end {min_queued} "
                           f"(the mix asks {mix['min_queued']})")
    return {"e2e": {"setup_s": setup_s, "transcribe_audio_s_per_s": rate}, "layer": layer, "correct": correct,
            "checks": checks, "attempted": len(finished), "failed": failed,
            "memory_peak_bytes": max(peak_setup, peak_window), "trace": summary}
