"""Dynamic micro-batching engine over the greedy or beam decode.

Port of `adt_str_tpu/serving/engine.py:ServingEngine`, with the same
contract:

- requests are fixed-size audio chunks (`config.shared.chunk_samples`); each
  micro-batch is zero-padded up to the smallest configured bucket, so the
  device sees a few fixed batch shapes; `precompile()` runs every bucket once
  at startup (it builds the kernels and warms the device);
- one dispatcher thread owns the device: client threads only enqueue numpy
  arrays and wait on futures;
- after the first request of a batch, the dispatcher drains what is queued
  and then waits at most `max_wait_ms` for stragglers (capped at the largest
  bucket);
- `max_queue` > 0 bounds the queue: `submit_chunk` then blocks while it is
  full (0: unbounded);
- `use_beam` decodes with `beam_search_decode` (`beam_size`,
  `length_penalty`), the eval harness's beam, with the same buckets;
- `close()` drains the queue so every accepted request is answered.

`stats()` counts requests, batches, padded rows, the seconds spent
decoding, each bucket's batches and `queue_wait_seconds`, the sum over
requests of the time from `submit_chunk` to the dispatcher taking the
request into a batch. With spans on (`utils/spans.py`) the dispatcher
records `serve.collect`, and `serve.batch` (ids batch, bucket, rows)
around the decode (`decode.*`), the tokens' copy to the host
(`serve.tokens_out`) and the answers (`serve.answer`, whose futures'
callbacks run on the dispatcher thread).

Tokens come back to the host as numpy int32. With a `mesh`
(`parallel/mesh.py:DataMesh` over this process's cards) every bucket must
be divisible by its data axis, and each micro-batch decodes through the
sharded decoders (`models/decode.py`): each card its own rows.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field

import numpy as np
import torch

from adt_str_tpu_torch import resolve_device
from adt_str_tpu_torch.config import FrameworkConfig
from adt_str_tpu_torch.domain.segmenter import chunk_wave
from adt_str_tpu_torch.domain.tokenizer import MidiTokenizer
from adt_str_tpu_torch.evaluation.notes import decode_tokens_to_notes, merge_chunk_notes
from adt_str_tpu_torch.models import decode as decode_lib
from adt_str_tpu_torch.models.adt import ADTModel
from adt_str_tpu_torch.parallel.mesh import DataMesh
from adt_str_tpu_torch.utils import spans

_SHUTDOWN = object()


@dataclass
class EngineStats:
    """Serve-time counters (monotonic; read with `ServingEngine.stats`)."""

    n_requests: int = 0
    n_batches: int = 0
    n_padded_rows: int = 0
    decode_seconds: float = 0.0
    queue_wait_seconds: float = 0.0  # summed over requests: from submit_chunk to a batch taking it
    occupancy: dict[int, int] = field(default_factory=dict)  # bucket -> batches

    def as_dict(self) -> dict:
        return {
            "n_requests": self.n_requests,
            "n_batches": self.n_batches,
            "n_padded_rows": self.n_padded_rows,
            "decode_seconds": round(self.decode_seconds, 6),
            "queue_wait_seconds": round(self.queue_wait_seconds, 6),
            "mean_batch": round(self.n_requests / self.n_batches, 3) if self.n_batches else 0.0,
            "occupancy": dict(sorted(self.occupancy.items())),
        }


class ServingEngine:
    """Micro-batching transcription engine on one device or over a mesh.

    `submit_chunk(wave)` returns a Future resolving to the `(max_length,)`
    int32 token row of one audio chunk; `transcribe` chunks a whole song,
    submits, and merges notes — concurrent songs share micro-batches.
    `device` None means cuda (raises without one), or the mesh's first
    device."""

    def __init__(
        self,
        model: ADTModel,
        config: FrameworkConfig,
        *,
        device=None,
        max_length: int | None = None,
        buckets: tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64),
        max_wait_ms: float = 2.0,
        max_queue: int = 0,
        mesh=None,
        use_beam: bool = False,
        beam_size: int = 5,
        length_penalty: float = 1.0,
    ) -> None:
        if not buckets or list(buckets) != sorted(set(buckets)):
            raise ValueError(f"buckets must be sorted unique sizes, got {buckets!r}")
        if mesh is not None:
            if not isinstance(mesh, DataMesh) or mesh.group is not None:
                raise ValueError("the engine serves in one process: pass a DataMesh over this process's devices")
            bad = [b for b in buckets if b % mesh.n_data]
            if bad:
                raise ValueError(f"buckets {bad} not divisible by the mesh data axis ({mesh.n_data})")
            device = mesh.device if device is None else device
        self._mesh = mesh
        self.device = resolve_device(device)
        self.config = config
        self.tokenizer = MidiTokenizer(config.tokenizer)
        self.max_length = int(max_length if max_length is not None else config.inference.max_length)
        self.chunk_samples = int(config.shared.chunk_samples)
        self.buckets = tuple(int(b) for b in buckets)
        self.max_wait_s = float(max_wait_ms) / 1000.0
        self.use_beam = bool(use_beam)
        self.beam_size = int(beam_size)
        self.length_penalty = float(length_penalty)
        self._model = model.to(self.device).eval()
        self._queue: queue.Queue = queue.Queue(maxsize=max_queue)
        self._stats = EngineStats()
        self._stats_lock = threading.Lock()
        self._batch_ids = itertools.count()
        self._closed = False
        self._thread = threading.Thread(
            target=self._dispatch_loop, name="adt-serving-dispatch", daemon=True
        )
        self._thread.start()

    # ---------------------------------------------------------------- public

    @classmethod
    def from_config(cls, model: ADTModel, config: FrameworkConfig, *, device=None, mesh=None,
                    **overrides) -> "ServingEngine":
        """Build from the config's `serving:` section; kwargs override YAML."""
        s = config.serving
        kw = dict(
            max_length=s.max_length,
            buckets=s.buckets,
            max_wait_ms=s.max_wait_ms,
            use_beam=s.use_beam_search,
            beam_size=s.beam_size,
            length_penalty=s.length_penalty,
        )
        kw.update({k: v for k, v in overrides.items() if v is not None})
        return cls(model, config, device=device, mesh=mesh, **kw)

    def precompile(self) -> float:
        """Run every bucket once (blocking): builds the kernels and warms the
        device so no live request pays for it. Returns the wall seconds."""
        t0 = time.monotonic()
        for b in self.buckets:
            silent = np.zeros((b, self.chunk_samples), np.float32)
            futs: list[Future] = [Future() for _ in range(b)]
            self._run_batch([(silent[i], futs[i], None) for i in range(b)])
            futs[0].result()  # surface a failed warm-up
        return time.monotonic() - t0

    def submit_chunk(self, wave: np.ndarray) -> Future:
        """Enqueue one audio chunk (1-D float, <= chunk_samples; shorter is
        zero-padded). The Future resolves to the (max_length,) int32 tokens."""
        if self._closed:
            raise RuntimeError("engine is closed")
        wave = np.asarray(wave, dtype=np.float32).reshape(-1)
        if wave.shape[0] > self.chunk_samples:
            raise ValueError(
                f"chunk has {wave.shape[0]} samples > chunk_samples="
                f"{self.chunk_samples}; use transcribe() for whole songs"
            )
        if wave.shape[0] < self.chunk_samples:
            wave = np.pad(wave, (0, self.chunk_samples - wave.shape[0]))
        fut: Future = Future()
        self._queue.put((wave, fut, time.monotonic()))
        return fut

    def transcribe(self, wave: np.ndarray, hop_sec: float | None = None) -> np.ndarray:
        """Whole-song transcription through the micro-batcher: the merged
        (N, 4) float64 note array."""
        hop = int(hop_sec * self.config.shared.sample_rate) if hop_sec else None
        triples = chunk_wave(np.asarray(wave, np.float32).reshape(-1), self.chunk_samples, hop)
        futures = [(start, self.submit_chunk(chunk)) for start, chunk, _ in triples]
        all_notes = []
        for start, fut in futures:
            notes = decode_tokens_to_notes(self.tokenizer, fut.result())
            if len(notes):
                notes[:, 0:2] += start / self.config.shared.sample_rate
                all_notes.append(notes)
        return merge_chunk_notes(all_notes, snap_to_grid=hop_sec is not None)

    def stats(self) -> dict:
        with self._stats_lock:
            return self._stats.as_dict()

    def close(self, timeout: float = 30.0) -> None:
        """Drain the queue, stop the dispatcher, fail any later submits."""
        if self._closed:
            return
        self._closed = True
        self._queue.put((_SHUTDOWN, None, None))
        self._thread.join(timeout=timeout)

    def __enter__(self) -> "ServingEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------- internals

    def _decode_device(self, waves: np.ndarray) -> np.ndarray:
        """One decode of a padded (bucket, chunk_samples) batch, each mesh
        entry decoding its own rows when there is a mesh."""
        dev = torch.from_numpy(waves).to(self.device)
        bos, eos = self.tokenizer.BOS_token, self.tokenizer.EOS_token
        if self._mesh is not None:
            if self.use_beam:
                tokens = decode_lib.beam_search_decode_sharded(
                    self._model, dev, self._mesh, beam_size=self.beam_size, max_length=self.max_length,
                    start_token=bos, end_token=eos, length_penalty=self.length_penalty)
            else:
                tokens = decode_lib.greedy_decode_sharded(self._model, dev, self._mesh, max_length=self.max_length,
                                                          start_token=bos, end_token=eos)
        elif self.use_beam:
            tokens = decode_lib.beam_search_decode(
                self._model, dev, max_length=self.max_length, beam_size=self.beam_size,
                start_token=bos, end_token=eos, length_penalty=self.length_penalty,
            )
        else:
            tokens = decode_lib.greedy_decode(self._model, dev, max_length=self.max_length,
                                              start_token=bos, end_token=eos)
        with spans.span("serve.tokens_out"):
            tokens = tokens.cpu()
        return tokens.numpy().astype(np.int32, copy=False)

    def _collect_batch(self, first) -> tuple[list, bool]:
        """Drain the queue, then wait up to max_wait_s for stragglers; stop
        at the largest bucket. Returns (batch, saw_shutdown)."""
        batch = [first]
        cap = self.buckets[-1]
        deadline = time.monotonic() + self.max_wait_s
        saw_shutdown = False
        while len(batch) < cap:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    item = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
            if item[0] is _SHUTDOWN:
                saw_shutdown = True
                break
            batch.append(item)
        self._add_wait(batch)
        return batch, saw_shutdown

    def _add_wait(self, items: list) -> None:
        """Count the queue wait of requests the dispatcher just took."""
        taken = time.monotonic()
        with self._stats_lock:
            self._stats.queue_wait_seconds += sum(taken - put for _, _, put in items)

    def _run_batch(self, batch: list) -> None:
        n = len(batch)
        bucket = next(b for b in self.buckets if b >= n)
        with spans.span("serve.batch", batch=next(self._batch_ids), bucket=bucket, rows=n):
            waves = np.zeros((bucket, self.chunk_samples), np.float32)
            for i, (wave, _, _) in enumerate(batch):
                waves[i] = wave
            t0 = time.monotonic()
            try:
                tokens = self._decode_device(waves)
            except Exception as exc:  # propagate one failure to every waiter
                for _, fut, _ in batch:
                    if fut is not None and not fut.cancelled():
                        fut.set_exception(exc)
                return
            dt = time.monotonic() - t0
            with spans.span("serve.answer"):
                for i, (_, fut, _) in enumerate(batch):
                    if fut is not None and not fut.cancelled():
                        fut.set_result(tokens[i])
        with self._stats_lock:
            s = self._stats
            s.n_requests += n
            s.n_batches += 1
            s.n_padded_rows += bucket - n
            s.decode_seconds += dt
            s.occupancy[bucket] = s.occupancy.get(bucket, 0) + 1

    def _drain_on_shutdown(self) -> None:
        """Resolve items that raced past the closed check so no waiter hangs."""
        leftovers = []
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item[0] is not _SHUTDOWN:
                leftovers.append(item)
        self._add_wait(leftovers)
        cap = self.buckets[-1]
        while leftovers:
            self._run_batch(leftovers[:cap])
            leftovers = leftovers[cap:]

    def _dispatch_loop(self) -> None:
        while True:
            item = self._queue.get()
            if item[0] is _SHUTDOWN:
                self._drain_on_shutdown()
                return
            with spans.span("serve.collect"):
                batch, saw_shutdown = self._collect_batch(item)
            self._run_batch(batch)
            if saw_shutdown:
                self._drain_on_shutdown()
                return
