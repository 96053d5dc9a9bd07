"""Smoke run of the PyTorch port on one NVIDIA GPU: `python3 chip_smoke.py`.

Drives the port's serving path (`adt_str_tpu_torch`) at full width and holds
its hand-written CUDA kernels against their plain PyTorch versions. Imports
no JAX and nothing of the JAX package. Phases, each printing one JSON line:

1. the card: `nvidia-smi` name and power limit, `torch.cuda.get_device_name`;
2. the kernel build (`csrc/*.cu`, one nvcc each, in parallel) and its time;
3. each kernel at the serving shapes (B = 1, the bucket the serving phase
   fills, and the largest bucket, 64) against its plain version on the
   card: max/mean abs error against the stated tolerance,
   kernel/plain/library medians over 12 timed calls (each on other inputs,
   after warm-up) and the least time the card could take (`bound_ms`);
4. the slice: the ENSTserving model (4+4 layers, d_model 768, vocab 1400)
   from seeded random weights, served by the port's HTTP server on
   127.0.0.1; 3 concurrent POSTs of 10 s of seeded raw f32 PCM must answer
   200 with well-formed notes, both kernels' launch counters must rise, and
   the kernel-path encoder memory must agree with the port's CPU path
   (which the tests hold against the JAX package);
5. one `{"kernels": [...]}` line, at the serving phase's batch shape.

Then the card's `nvidia-smi` line, and last `{"ok": true, "device": ...}`.
Any failed phase raises: no `ok` line and a nonzero exit.
"""

from __future__ import annotations

import copy
import json
import math
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

from adt_str_tpu_torch.config import FrameworkConfig
from adt_str_tpu_torch.models.adt import ADTModel, mel_params
from adt_str_tpu_torch.models.decode import greedy_decode_from_memory
from adt_str_tpu_torch.ops import _build, cuda_attention, cuda_mel
from adt_str_tpu_torch.serve import build_engine
from adt_str_tpu_torch.serving.http import make_server, start_in_thread

# configs/serve/ENSTserving.yaml merged over configs/config_default.yaml, as
# a dict: the machine with the card has no PyYAML (a test checks the two agree).
SERVING_CONFIG = {
    "shared": {"input_sec": 2.56, "time_res": 0.01, "win_length": 2048, "sample_rate": 24000},
    "model": {
        "enc_layers": 4, "dec_layers": 4, "nhead": 6, "d_query": 128, "dropout": 0.1,
        "tgt_vocab_size": 1400, "plain": True, "n_mels": 128, "param_dtype": "float32",
        "compute_dtype": "bfloat16", "use_pallas_mel": True, "use_flash_attention": True,
    },
    "tokenizer": {"ADTOF_mapping": True, "BOS_token": 2, "EOS_token": 3, "pad_token": 1,
                  "silence_token": 0, "add_velocity": True},
    "inference": {"checkpoint_path": "checkpoints/setting-1", "batch_size": 16, "max_length": 512,
                  "beam_size": 5, "use_beam_search": False, "output_path": "results/ENST/"},
    "serving": {"buckets": [1, 2, 4, 8, 16, 32, 64], "max_wait_ms": 2.0, "host": "127.0.0.1",
                "port": 8321, "precompile": True},
}

# H100 SXM data-sheet peaks (dense): bf16 tensor cores, fp32 CUDA cores, HBM3
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
REPS = 12
SEED = 0
N_REQUESTS = 3
REQUEST_SEC = 10.0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def median_ms(fn, inputs) -> float:
    """Median of per-call CUDA-event times, one call per staged input."""
    fn(*inputs[0])  # warm-up
    torch.cuda.synchronize()
    events = []
    for args in inputs:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def bound(flops_by_peak: list[tuple[float, float]], n_bytes: float) -> tuple[float, str]:
    ops_s = sum(f / peak for f, peak in flops_by_peak)
    bytes_s = n_bytes / PEAK_BYTES
    return max(ops_s, bytes_s) * 1e3, ("operations" if ops_s >= bytes_s else "bytes")


def phase_card() -> tuple[str, str]:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    emit({"phase": "card", "nvidia_smi": smi, "device": name, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return smi, name


def phase_build() -> None:
    t0 = time.monotonic()
    reports = _build.build_all()
    secs = time.monotonic() - t0
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas {name}] {line.strip()}", flush=True)
    emit({"phase": "build", "kernels": sorted(reports), "seconds": round(secs, 3)})


def mel_library(wave, params):
    """torch.stft + the mel matmul + the log tail: the library yardstick of K1."""
    window = torch.hann_window(params.n_fft, periodic=True, device=wave.device)
    spec = torch.stft(wave, params.n_fft, params.hop_length, window=window, center=True,
                      pad_mode="reflect", return_complex=True)
    power = spec.real**2 + spec.imag**2  # (B, n_freqs, frames)
    fb = cuda_mel._device_constants(params, wave.device)[2][: params.n_freqs]
    mel = torch.matmul(power.transpose(1, 2), fb)
    logmel = torch.clamp(torch.log(mel + params.log_floor), params.clamp_lo, params.clamp_hi)
    p = params.window_pad_idxs
    return ((logmel - params.clamp_lo) / (params.clamp_hi - params.clamp_lo))[:, p : mel.shape[1] - p - 1]


def main_path_bucket(cfg: FrameworkConfig) -> int:
    """The bucket the serving phase's requests fill when they share one batch."""
    chunks = N_REQUESTS * math.ceil(REQUEST_SEC * cfg.shared.sample_rate / cfg.shared.chunk_samples)
    return next(b for b in cfg.serving.buckets if b >= chunks)


def phase_mel(params, batch: int, gen) -> dict:
    T = 61440
    inputs = [(torch.randn(batch, T, generator=gen, device="cuda") * 0.3, params) for _ in range(REPS)]
    before = cuda_mel.log_mel.launches
    out = cuda_mel.log_mel(*inputs[0])
    ref = cuda_mel.log_mel_plain(*inputs[0])
    torch.cuda.synchronize()
    if cuda_mel.log_mel.launches != before + 1:
        raise RuntimeError("log_mel did not launch its kernel")
    err = (out - ref).abs()
    tol = 1e-4  # same bf16 operands, fp32 accumulation in another order
    res = {"max_abs_err": err.max().item(), "mean_abs_err": err.mean().item(), "tol": tol}
    if not (torch.isfinite(out).all() and res["max_abs_err"] <= tol):
        raise RuntimeError(f"log_mel kernel disagrees with its plain version: {res}")
    res["ms"] = median_ms(cuda_mel.log_mel, inputs)
    res["plain_ms"] = median_ms(cuda_mel.log_mel_plain, inputs)
    res["library_ms"] = median_ms(mel_library, inputs)
    rows, k = batch * params.out_frames(T), params.n_freqs
    res["bound_ms"], res["bound_by"] = bound(
        [(4.0 * rows * params.n_fft * k, PEAK_BF16), (2.0 * rows * k * params.n_mels, PEAK_FP32)],
        batch * T * 4 + 2 * params.n_fft * k * 2 + k * params.n_mels * 4 + rows * params.n_mels * 4,
    )
    emit({"phase": "kernel", "name": "log_mel", "batch": batch, **res})
    return res


def phase_attention(batch: int, gen) -> dict:
    H, T, D = 6, 246, 128

    def qkv():
        return tuple(torch.randn(batch, H, T, D, generator=gen, device="cuda").to(torch.bfloat16) for _ in range(3))

    inputs = [qkv() for _ in range(REPS)]
    before = cuda_attention.fused_attention.launches
    out, lse = cuda_attention.fused_attention(*inputs[0])
    ref, ref_lse = cuda_attention.attention_plain(*inputs[0])
    torch.cuda.synchronize()
    if cuda_attention.fused_attention.launches != before + 1:
        raise RuntimeError("fused_attention did not launch its kernel")
    err = (out.float() - ref.float()).abs()
    tol = 1.6e-2  # p rounds to bf16 on both sides; a rare ulp flip moves out by ~1 bf16 ulp
    res = {"max_abs_err": err.max().item(), "mean_abs_err": err.mean().item(), "tol": tol,
           "lse_max_abs_err": (lse - ref_lse).abs().max().item()}
    if not (torch.isfinite(out.float()).all() and res["max_abs_err"] <= tol and res["lse_max_abs_err"] <= 1e-4):
        raise RuntimeError(f"attention kernel disagrees with its plain version: {res}")
    res["ms"] = median_ms(cuda_attention.fused_attention, inputs)
    res["plain_ms"] = median_ms(cuda_attention.attention_plain, inputs)
    res["library_ms"] = median_ms(torch.nn.functional.scaled_dot_product_attention, inputs)
    n = batch * H * T * D
    res["bound_ms"], res["bound_by"] = bound([(4.0 * batch * H * T * T * D, PEAK_BF16)], 4 * n * 2 + batch * H * T * 4)
    emit({"phase": "kernel", "name": "fused_attention", "batch": batch, **res})
    return res


def _post(url: str, body: bytes, results: list, i: int) -> None:
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": "application/octet-stream"})
    t0 = time.monotonic()
    with urllib.request.urlopen(req, timeout=600) as resp:
        results[i] = (resp.status, resp.read(), time.monotonic() - t0)


def check_notes(payload: dict, duration: float, vocab: int) -> None:
    notes = np.asarray(payload["notes"], dtype=np.float64).reshape(-1, 4)
    if payload["n_notes"] != len(notes) or not np.isfinite(notes).all():
        raise RuntimeError(f"malformed notes: n_notes={payload['n_notes']} rows={len(notes)}")
    if len(notes) and not (
        (notes[:, 0] >= 0).all() and (notes[:, 0] <= duration + 2.56).all()
        and np.allclose(notes[:, 1] - notes[:, 0], 0.1)
        and ((notes[:, 2] >= 0) & (notes[:, 2] < 100)).all()
        and ((notes[:, 3] >= 0) & (notes[:, 3] < vocab - 400)).all()  # random weights use the whole vocab
    ):
        raise RuntimeError("notes out of their ranges")


def decode_breakdown(model: ADTModel, cfg: FrameworkConfig, batch: int) -> dict:
    """Where one served batch's time goes: encode against the greedy decode
    loop (CUDA events), then the device's busy share of a 64-step decode
    under torch.profiler (kernel time over host wall time; the profiler's
    own host cost makes the idle share an upper bound)."""
    bucket = next(b for b in cfg.serving.buckets if b >= batch)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    wave = torch.randn(bucket, cfg.shared.chunk_samples, generator=gen, device="cuda") * 0.3
    eos, max_len = cfg.tokenizer.EOS_token, cfg.inference.max_length
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    with torch.inference_mode():
        model.encode(wave)  # warm-up at this batch shape
        ev[0].record()
        memory = model.encode(wave)
        ev[1].record()
        tokens = greedy_decode_from_memory(model, memory, max_len, cfg.tokenizer.BOS_token, eos)
        ev[2].record()
        torch.cuda.synchronize()
        # the loop ran until the last row's first EOS (or the length budget)
        first_eos = torch.where(tokens[:, 1:] == eos, torch.arange(1, max_len, device="cuda"), max_len)
        steps = int(min(first_eos.min(dim=1).values.max().item(), max_len - 1))
        out = {"bucket": bucket, "encode_ms": ev[0].elapsed_time(ev[1]), "decode_ms": ev[1].elapsed_time(ev[2]),
               "decode_steps": steps}
        out["ms_per_step"] = out["decode_ms"] / max(steps, 1)
        trace = _build.BUILD_DIR.parent / "decode_trace.json"
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.monotonic()
            greedy_decode_from_memory(model, memory, 65, cfg.tokenizer.BOS_token, eos)
            torch.cuda.synchronize()
            wall_us = (time.monotonic() - t0) * 1e6
        prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text()).get("traceEvents", [])
    kernels = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    busy_us = sum(float(e.get("dur", 0)) for e in kernels)
    out["profiled_max_steps"] = 64
    out["device_kernels"] = len(kernels)
    out["device_busy_share"] = busy_us / wall_us if kernels else None  # None: the profiler saw no device
    return out


def phase_serving(cfg: FrameworkConfig) -> dict:
    t0 = time.monotonic()
    model = ADTModel(cfg.model, seed=SEED, device="cuda")
    build_s = time.monotonic() - t0

    # the kernel path against the port's CPU path (plain versions) on one chunk
    chunk = torch.from_numpy(
        (np.random.default_rng(SEED).normal(size=(1, cfg.shared.chunk_samples)) * 0.3).astype(np.float32)
    )
    with torch.inference_mode():
        mem_gpu = model.encode(chunk.cuda()).float().cpu()
        mem_cpu = copy.deepcopy(model).to("cpu").encode(chunk).float()
    mem_err = (mem_gpu - mem_cpu).abs()
    # bf16 activations round differently on the two devices through 4 layers
    mem = {"max_abs_err": mem_err.max().item(), "mean_abs_err": mem_err.mean().item(),
           "tol_max": 0.5, "tol_mean": 2e-2, "shape": list(mem_gpu.shape)}
    if not (torch.isfinite(mem_gpu).all() and mem["max_abs_err"] <= 0.5 and mem["mean_abs_err"] <= 2e-2):
        raise RuntimeError(f"kernel-path encoder memory disagrees with the CPU path: {mem}")

    engine = build_engine(cfg, model)
    server = make_server(engine, "127.0.0.1", 0)
    start_in_thread(server)
    host, port = server.server_address[:2]
    url = f"http://{host}:{port}/v1/transcribe"
    rng = np.random.default_rng(SEED + 1)
    n = int(REQUEST_SEC * cfg.shared.sample_rate)
    bodies = [(rng.normal(size=n) * 0.3).astype("<f4").tobytes() for _ in range(N_REQUESTS)]
    results: list = [None] * N_REQUESTS
    try:
        cuda_mel.log_mel.launches = 0
        cuda_attention.fused_attention.launches = 0
        t0 = time.monotonic()
        threads = [threading.Thread(target=_post, args=(url, b, results, i)) for i, b in enumerate(bodies)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.monotonic() - t0
        launches = {"log_mel": cuda_mel.log_mel.launches,
                    "fused_attention": cuda_attention.fused_attention.launches}
        stats = engine.stats()
    finally:
        server.shutdown()
        server.server_close()
        engine.close()
    for i, r in enumerate(results):
        if r is None or r[0] != 200:
            raise RuntimeError(f"request {i} failed: {r}")
        check_notes(json.loads(r[1]), REQUEST_SEC, cfg.model.tgt_vocab_size)
    if not all(launches.values()):
        raise RuntimeError(f"a kernel of the path was not launched while serving: {launches}")
    breakdown = decode_breakdown(model, cfg, batch=stats["n_requests"])
    res = {
        "phase": "serving", "requests": N_REQUESTS, "request_sec": REQUEST_SEC,
        "model_params": sum(p.numel() for p in model.parameters()), "model_build_s": round(build_s, 3),
        "wall_s": round(wall, 3), "request_s": [round(r[2], 3) for r in results],
        "n_notes": [json.loads(r[1])["n_notes"] for r in results],
        "launches": launches, "engine_stats": stats, "memory_vs_cpu": mem, "breakdown": breakdown,
    }
    emit(res)
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # plain fp32 products stay fp32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.monotonic()
    smi, name = phase_card()
    phase_build()
    cfg = FrameworkConfig.from_dict(SERVING_CONFIG)
    params = mel_params(cfg.model)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    # the main path's batch shape, a lone chunk, and the largest bucket
    bucket = main_path_bucket(cfg)
    batches = sorted({1, bucket, cfg.serving.buckets[-1]})
    mel = {b: phase_mel(params, b, gen) for b in batches}
    att = {b: phase_attention(b, gen) for b in batches}
    serving = phase_serving(cfg)
    keys = ("max_abs_err", "tol", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [
        {"name": "log_mel", "route": "cuda", "source": "adt_str_tpu_torch/csrc/log_mel.cu",
         "replaces": "adt_str_tpu/ops/pallas_mel.py:112 pallas_log_mel",
         "launches": serving["launches"]["log_mel"], "batch": bucket, **{k: mel[bucket][k] for k in keys}},
        {"name": "fused_attention", "route": "cuda", "source": "adt_str_tpu_torch/csrc/attention.cu",
         "replaces": "adt_str_tpu/ops/pallas_attention.py:99 _fwd",
         "launches": serving["launches"]["fused_attention"], "batch": bucket, **{k: att[bucket][k] for k in keys}},
    ], "total_s": round(time.monotonic() - t_start, 3)})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
