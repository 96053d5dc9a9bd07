"""Smoke run of the PyTorch port on one NVIDIA GPU: `python3 chip_smoke.py`.

Drives the port's serving path, its real-audio training step and its
synthesis-fused training step (`adt_str_tpu_torch`) at full width and holds
its hand-written CUDA kernels against their plain PyTorch versions. Imports
no JAX and nothing of the JAX package. Phases, each printing one JSON line:

1. the card: `nvidia-smi` name and power limit, `torch.cuda.get_device_name`;
2. the kernel build (`csrc/*.cu` with the shared `csrc/hopper.cuh`, one
   nvcc each, in parallel), its time and each kernel's ptxas registers and
   spills;
3. each kernel against its plain version on the card, at the shapes the
   main paths give it: K1 log-mel and K5f attention at the serving batches
   (B = 1, the bucket the serving phase fills, 64); K5f, K5b (attention
   backward) at the training shapes (B = 64: encoder 246 x 246, decoder
   self 511 x 511 with the causal + padding mask, cross 511 x 246); K4
   (fused FFN + dropout) at N = 64 * 246 and 64 * 511 rows. Each line:
   max/mean abs error against the stated tolerance, kernel/plain/library
   medians over 12 timed calls (each on other inputs, after warm-up) and
   the least time the card could take (`bound_ms`, `bound_by`); for K1,
   K4, K5f and K5b also each device kernel's own time (`device_ms`,
   torch.profiler);
4. synthesis (setting-1, `configs/train/setting-1.yaml`): a production-size
   one-shot bank built on the card from a seed (27 pitches x the 3 bins the
   similarity threshold 0.8 allows x 1,235 rows = 100,035 rows of 1.28 s at
   24 kHz in bf16, 5.72 GiB; the repo has no curated library); K2 (gather +
   mixup blend) at N = 64 * 27 requests from it and K3 (note placement) at
   B = 64, 128 notes, each bit-equal to its plain version and timed as in 3;
   then `render_batch` at B = 64: the kernel-path render must equal the
   plain-path render on the same draws, a few rows must agree with the
   port's CPU render, and the median render time is split into draw / K2 /
   K3 / FX / normalise;
5. training, one phase per configuration (`TRAIN_CONFIGS`: TMIDT at full
   width, batch 64, with K4 or with K5; then `synth-setting-1`, the
   synthesis-fused step of setting-1 on the bank of 4): 5 steps of the
   port's `make_train_step` / `make_synth_train_step` on one seeded batch
   (random 2.56 s waves, or random note lists, and random 512-token
   sequences), at a constant learning rate of 1e-4 with no warmup (so every
   update applies). It fails unless every loss is finite, the last loss is
   below the first, the slice's kernels launched exactly as often as the
   step calls them, and the first step's loss and grad_norm agree with the
   same step through the plain versions on the card. It reports the median
   step time, the device-busy share of one profiled step and where that
   step's device time goes;
6. serving: the ENSTserving model (4+4 layers, d_model 768, vocab 1400)
   from seeded random weights, served by the port's HTTP server on
   127.0.0.1; 3 concurrent POSTs of 10 s of seeded raw f32 PCM must answer
   200 with well-formed notes, both serving kernels' launch counters must
   rise, and the kernel-path encoder memory must agree with the port's CPU
   path (which the tests hold against the JAX package);
7. one `{"kernels": [...]}` line: each kernel at the main-path shape named
   in its entry, with its launches in every main-path run.

Then the card's `nvidia-smi` line, and last `{"ok": true, "device": ...}`.
Any failed phase raises: no `ok` line and a nonzero exit.
"""

from __future__ import annotations

import contextlib
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

from adt_str_tpu_torch.config import FrameworkConfig, TrainingConfig
from adt_str_tpu_torch.models import transformer as T
from adt_str_tpu_torch.models.adt import ADTModel, collate_token_lengths, draw_site_keys, mel_params
from adt_str_tpu_torch.models.decode import greedy_decode_from_memory
from adt_str_tpu_torch.ops import _build, cuda_attention, cuda_ffn, cuda_mel, cuda_place, ffn
from adt_str_tpu_torch.ops.dropout_hash import seed_from_key
from adt_str_tpu_torch.ops.place import gather_blend_plain, place_notes_plain
from adt_str_tpu_torch.parallel.train_step import init_train_state, make_synth_train_step, make_train_step
from adt_str_tpu_torch.serve import build_engine
from adt_str_tpu_torch.synth import render
from adt_str_tpu_torch.synth.bank import N_BINS, OneShotBank, n_allowed_bins
from adt_str_tpu_torch.training.optimizer import make_optimizer
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

# configs/train/TMIDT-{fused-ffn,flash}.yaml merged over configs/config_default.yaml
# (the sections the step reads; a test checks each against its YAML)
_TMIDT_MODEL = {
    "enc_layers": 4, "dec_layers": 4, "nhead": 6, "d_query": 128, "tgt_vocab_size": 1400, "plain": True,
    "n_mels": 128, "param_dtype": "float32", "compute_dtype": "bfloat16", "use_pallas_mel": True,
}
_TMIDT = {
    "shared": {"input_sec": 2.56, "time_res": 0.01, "win_length": 2048, "sample_rate": 24000},
    "tokenizer": {"ADTOF_mapping": False, "BOS_token": 2, "EOS_token": 3, "pad_token": 1,
                  "silence_token": 0, "add_velocity": False},
    "training": {"learning_rate": 1e-4, "min_learning_rate": 1e-5, "warmup_ratio": 0.1,
                 "gradient_accumulation_steps": 1, "weight_decay": 1e-5, "max_grad_norm": 1.0, "optim": "adamw",
                 "lr_scheduler_type": "cosine"},
}
TRAIN_CONFIGS = {
    "fused-ffn": {**_TMIDT, "model": {**_TMIDT_MODEL, "dropout": 0.1, "use_pallas_ffn": True}},
    "flash": {**_TMIDT, "model": {**_TMIDT_MODEL, "dropout": 0.0, "use_flash_attention": True}},
}
# configs/train/setting-1.yaml merged over configs/config_default.yaml (the
# sections the synthesis-fused step reads; a test checks it against the
# YAML). No one-shot library: the bank is built on the card.
SYNTH_CONFIG = {
    "shared": {"input_sec": 2.56, "time_res": 0.01, "win_length": 2048, "sample_rate": 24000},
    "tokenizer": {"ADTOF_mapping": False, "BOS_token": 2, "EOS_token": 3, "pad_token": 1,
                  "silence_token": 0, "add_velocity": True},
    "model": {**_TMIDT_MODEL, "dropout": 0.1},
    "training": {"learning_rate": 1e-4, "warmup_ratio": 0.1, "gradient_accumulation_steps": 1,
                 "weight_decay": 1e-5, "max_grad_norm": 1.0, "optim": "adamw", "lr_scheduler_type": "cosine"},
    "synthetiser": {"similarity_threshold": 0.8, "mixup_range": 0.8, "use_fx_prob": 0.3,
                    "use_reverb_prob": 0.5, "use_compression_prob": 0.5, "use_limiter_prob": 0.5,
                    "max_notes": 128, "max_oneshot_sec": 1.28},
}
SYNTH_NAME = "synth-setting-1"
BANK_ROWS_PER_BIN = 1235  # 27 pitches x 3 bins x 1,235 = 100,035 rows: the ~100k-one-shot production bank
BANK_BUILD_ROWS = 4096  # rows generated at once (a 0.5 GB f32 intermediate)
TRAIN_BATCH = 64  # configs/train/setting-1.yaml's batch size
TRAIN_TOKENS = 512  # TrainDatasetConfig.max_tokens: decoder inputs of 511 tokens
TRAIN_STEPS = 5
TRAIN_LR = 1e-4

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


def device_ms(fn, inputs) -> dict:
    """Device time of each kernel `fn` launches, per call, over the staged
    inputs under torch.profiler: the kernel alone, without the host's launch
    cost that `median_ms` includes when one call cannot fill the card."""
    fn(*inputs[0])
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for args in inputs:
            fn(*args)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_time_total > 0:
            name = e.key.replace("(anonymous namespace)::", "").split("(")[0]
            out[name] = out.get(name, 0.0) + e.device_time_total / len(inputs) / 1e3
    return out


def bound(flops_by_peak: list[tuple[float, float]], n_bytes: float) -> tuple[float, str]:
    """The least time in ms and what sets it: the tensor-core and CUDA-core
    pipes and the memory run at once, so the slowest of the three binds."""
    ops_s = max(f / peak for f, peak in flops_by_peak)
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
            if any(k in line for k in ("entry function", "registers", "spill", "serialized")):
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
    res["device_ms"] = device_ms(cuda_mel.log_mel, inputs)  # the main kernel and, when split, the reduction
    res["plain_ms"] = median_ms(cuda_mel.log_mel_plain, inputs)
    res["library_ms"] = median_ms(mel_library, inputs)
    rows, k = batch * params.out_frames(T), params.n_freqs
    res["bound_ms"], res["bound_by"] = bound(
        [(4.0 * rows * params.n_fft * k, PEAK_BF16), (2.0 * rows * k * params.n_mels, PEAK_FP32)],
        batch * T * 4 + 2 * params.n_fft * k * 2 + k * params.n_mels * 4 + rows * params.n_mels * 4,
    )
    emit({"phase": "kernel", "name": "log_mel", "batch": batch, **res})
    return res


def _attention_mask(batch: int, tq: int, tk: int, causal: bool, gen):
    """None, or the decoder's causal + key-padding mask as (B, Tq, Tk) at
    random token lengths (Tq == Tk)."""
    if not causal:
        return None
    lengths = torch.randint(tk // 4, tk + 1, (batch,), generator=gen, device="cuda")
    return (T.causal_mask_additive(tq, device="cuda") + T.padding_mask_additive(lengths, tk))[:, 0].contiguous()


def _qkv(batch: int, tq: int, tk: int, gen):
    H, D = 6, 128
    return tuple(torch.randn(batch, H, t, D, generator=gen, device="cuda").to(torch.bfloat16) for t in (tq, tk, tk))


def _sdpa(q, k, v, mask, n_virtual):
    """One library call for the same function (the virtual keys add 0 here)."""
    am = None if mask is None else mask[:, None].to(q.dtype)
    return torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=am)


def phase_attention(batch: int, tq: int, tk: int, causal: bool, gen, shape: str) -> dict:
    """K5f at one shape; the keys the JAX caller pads on are counted as the model counts them."""
    n_virtual = cuda_attention.virtual_keys(tq, tk)
    inputs = [(*_qkv(batch, tq, tk, gen), _attention_mask(batch, tq, tk, causal, gen), n_virtual) for _ in range(REPS)]
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
        raise RuntimeError(f"attention kernel disagrees with its plain version at {shape}: {res}")
    res["ms"] = median_ms(cuda_attention.fused_attention, inputs)
    res["device_ms"] = device_ms(cuda_attention.fused_attention, inputs)
    res["plain_ms"] = median_ms(cuda_attention.attention_plain, inputs)
    res["library_ms"] = median_ms(_sdpa, inputs)
    bh = batch * 6
    res["bound_ms"], res["bound_by"] = bound(
        [(4.0 * bh * tq * tk * 128, PEAK_BF16), (5.0 * bh * tq * tk, PEAK_FP32)],  # products; scale, mask, max, exp, sum
        2 * bh * (tq + tk) * 128 * 2 + (0 if not causal else batch * tq * tk * 4) + bh * tq * 4,
    )
    emit({"phase": "kernel", "name": "fused_attention", "shape": shape, "batch": batch, "tq": tq, "tk": tk,
          "mask": causal, "n_virtual": n_virtual, **res})
    return res


def _sdpa_grads(out, q, k, v, do):
    return torch.autograd.grad(out, (q, k, v), do, retain_graph=True)


def phase_attention_bwd(batch: int, tq: int, tk: int, causal: bool, gen, shape: str) -> dict:
    """K5b at one shape, on the forward kernel's out and lse."""
    n_virtual = cuda_attention.virtual_keys(tq, tk)
    inputs = []
    for _ in range(REPS):
        q, k, v = _qkv(batch, tq, tk, gen)
        mask = _attention_mask(batch, tq, tk, causal, gen)
        out, lse = cuda_attention.fused_attention(q, k, v, mask, n_virtual)
        do = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
        inputs.append((q, k, v, mask, out, lse, do))
    before = cuda_attention.fused_attention_bwd.launches
    got = cuda_attention.fused_attention_bwd(*inputs[0])
    refs = cuda_attention.attention_bwd_plain(*inputs[0])
    torch.cuda.synchronize()
    if cuda_attention.fused_attention_bwd.launches != before + 1:
        raise RuntimeError("fused_attention_bwd did not launch its kernels")
    # p and ds enter the kernel's products as bf16 (relative 2^-9) where the
    # plain version keeps fp32, and both round dq, dk, dv to bf16 (2^-8)
    tol_rel = 2.0**-6
    errs = {n: (g.float() - r.float()).abs() for n, g, r in zip(("dq", "dk", "dv"), got, refs)}
    scale = {n: r.float().abs().max().item() for n, r in zip(("dq", "dk", "dv"), refs)}
    res = {"max_abs_err": max(e.max().item() for e in errs.values()),
           "mean_abs_err": statistics.mean(e.mean().item() for e in errs.values()),
           "max_rel_to_largest": {n: errs[n].max().item() / max(scale[n], 1e-30) for n in errs}, "tol_rel": tol_rel}
    if not (all(torch.isfinite(g.float()).all() for g in got) and max(res["max_rel_to_largest"].values()) <= tol_rel):
        raise RuntimeError(f"attention backward kernel disagrees with its plain version at {shape}: {res}")
    res["tol"] = tol_rel * max(scale.values())
    res["ms"] = median_ms(cuda_attention.fused_attention_bwd, inputs)
    res["device_ms"] = device_ms(cuda_attention.fused_attention_bwd, inputs)  # the delta pass and the main kernel
    res["plain_ms"] = median_ms(cuda_attention.attention_bwd_plain, inputs)
    lib_inputs = []
    for q, k, v, mask, _, _, do in inputs:
        q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
        lib_inputs.append((_sdpa(q, k, v, mask, n_virtual), q, k, v, do))
    res["library_ms"] = median_ms(_sdpa_grads, lib_inputs)  # autograd through SDPA, same mask
    del lib_inputs
    bh = batch * 6
    res["bound_ms"], res["bound_by"] = bound(
        [(10.0 * bh * tq * tk * 128, PEAK_BF16), (8.0 * bh * tq * tk, PEAK_FP32)],  # 5 products; p and ds
        4 * bh * (tq + tk) * 128 * 2 + (0 if not causal else batch * tq * tk * 4) + bh * tq * 4,
    )
    emit({"phase": "kernel", "name": "fused_attention_bwd", "shape": shape, "batch": batch, "tq": tq, "tk": tk,
          "mask": causal, "n_virtual": n_virtual, **res})
    return res


def _ffn_library(x, w1, b1, w2, b2, *_):
    """Two cuBLAS GEMMs with F.gelu between, masks excluded: K4's library yardstick."""
    return torch.nn.functional.linear(torch.nn.functional.gelu(torch.nn.functional.linear(x, w1, b1)), w2, b2)


def phase_ffn(rows: int, gen, shape: str, d: int = 768, d_ff: int = 3072, keep: float = 0.9) -> dict:
    """K4 at one shape (the training config's dropout 0.1)."""
    cpu = torch.Generator().manual_seed(SEED + rows)

    def args():
        x = torch.randn(rows, d, generator=gen, device="cuda").to(torch.bfloat16)
        w1 = (torch.randn(d_ff, d, generator=gen, device="cuda") / math.sqrt(d)).to(torch.bfloat16)
        w2 = (torch.randn(d, d_ff, generator=gen, device="cuda") / math.sqrt(d_ff)).to(torch.bfloat16)
        b1 = (torch.randn(d_ff, generator=gen, device="cuda") * 0.1).to(torch.bfloat16)
        b2 = (torch.randn(d, generator=gen, device="cuda") * 0.1).to(torch.bfloat16)
        words = torch.randint(0, 2**32, (2, 2), generator=cpu).tolist()
        return x, w1, b1, w2, b2, seed_from_key(words[0]) + seed_from_key(words[1]), keep, keep

    inputs = [args() for _ in range(REPS)]
    before = cuda_ffn.ffn_dropout.launches
    out, pre = cuda_ffn.ffn_dropout(*inputs[0])
    ref, ref_pre = ffn.ffn_dropout_plain(*inputs[0])
    torch.cuda.synchronize()
    if cuda_ffn.ffn_dropout.launches != before + 1:
        raise RuntimeError("ffn_dropout did not launch its kernel")
    # the same bf16 operands with fp32 accumulation in another order: pre and
    # out may each flip one bf16 rounding (<= 2^-7 of the value); pre also
    # carries the fp32 cancellation error near 0; the masks are the same hash
    err, pre_err = (out.float() - ref.float()).abs(), (pre.float() - ref_pre.float()).abs()
    tol = 2.0**-7 * ref.float().abs().max().item()
    pre_ok = bool((pre_err <= 2.0**-7 * ref_pre.float().abs() + 1e-4 * ref_pre.float().abs().max()).all())
    res = {"max_abs_err": err.max().item(), "mean_abs_err": err.mean().item(), "tol": tol,
           "pre_max_abs_err": pre_err.max().item(), "pre_within_1ulp": pre_ok,
           "zero_pattern_equal": bool(torch.equal(out == 0, ref == 0)),
           "dropped_share": (out == 0).float().mean().item()}
    if not (torch.isfinite(out.float()).all() and res["max_abs_err"] <= tol and pre_ok and res["zero_pattern_equal"]):
        raise RuntimeError(f"FFN kernel disagrees with its plain version at {shape}: {res}")
    res["ms"] = median_ms(cuda_ffn.ffn_dropout, inputs)
    res["device_ms"] = device_ms(cuda_ffn.ffn_dropout, inputs)  # GEMM 1 and GEMM 2
    res["plain_ms"] = median_ms(ffn.ffn_dropout_plain, inputs)
    res["library_ms"] = median_ms(_ffn_library, inputs)
    res["library"] = "two cuBLAS GEMMs + F.gelu, masks excluded"
    res["bound_ms"], res["bound_by"] = bound(
        # the two products; ~30 fp32-rate operations per hidden element (A-S
        # gelu, the hash, scaling) and ~12 per output element
        [(4.0 * rows * d * d_ff, PEAK_BF16), (30.0 * rows * d_ff + 12.0 * rows * d, PEAK_FP32)],
        2 * (rows * d * 2 + d * d_ff * 2) + 2 * (d_ff + d) + rows * d_ff * 2,
    )
    emit({"phase": "kernel", "name": "ffn_dropout", "shape": shape, "rows": rows, "d": d, "d_ff": d_ff, **res})
    return res


def build_card_bank(cfg, seed: int) -> OneShotBank:
    """The production-size bank, generated on the card in chunks: for each
    of the 27 pitches and each of the 3 bins the threshold allows,
    BANK_ROWS_PER_BIN exponentially decaying noise bursts (as
    `synth/bank.py:make_test_bank` makes them) of random length, zero-padded
    to max_oneshot_sec, stored in bf16."""
    sr, L = cfg.sample_rate, int(cfg.max_oneshot_sec * cfg.sample_rate)
    n_bins = n_allowed_bins(cfg.similarity_threshold)
    pitches = range(render.PITCH_LO, render.PITCH_HI + 1)
    per_pitch = n_bins * BANK_ROWS_PER_BIN
    n = len(pitches) * per_pitch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    waves = torch.empty((n, L), dtype=torch.bfloat16, device="cuda")
    t = torch.arange(L, device="cuda", dtype=torch.float32) / sr
    for start in range(0, n, BANK_BUILD_ROWS):
        rows = min(BANK_BUILD_ROWS, n - start)
        pitch = render.PITCH_LO + torch.arange(start, start + rows, device="cuda") // per_pitch
        freq = (60 + 40 * (pitch - render.PITCH_LO)).float()[:, None]
        decay = 5 + 25 * torch.rand(rows, 1, generator=gen, device="cuda")
        length = torch.randint(L // 4, L, (rows, 1), generator=gen, device="cuda")
        noise = torch.randn(rows, L, generator=gen, device="cuda")
        w = torch.exp(-t * decay) * (0.7 * torch.sin(2 * math.pi * freq * t) + 0.3 * noise)
        waves[start : start + rows] = torch.where(torch.arange(L, device="cuda") < length, w, 0.0).to(torch.bfloat16)
    bin_offset = np.zeros((128, N_BINS), np.int32)
    bin_count = np.zeros((128, N_BINS), np.int32)
    for i, p in enumerate(pitches):
        bin_offset[p, :n_bins] = i * per_pitch + np.arange(n_bins) * BANK_ROWS_PER_BIN
        bin_count[p, :n_bins] = BANK_ROWS_PER_BIN
    return OneShotBank(waveforms=waves, lengths=np.full(n, L, np.int32), bin_offset=bin_offset,
                       bin_count=bin_count, max_len=L, loaded_bins=n_bins)


def random_notes(cfg, batch: int, seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, max_notes, 4) note lists and their mask on the card: 8 to
    max_notes notes a row (row 0 empty, row 1 full), pitches 35..61,
    velocities 1..127, onsets uniform in [0, input_sec) s, 0.1 s long."""
    g = torch.Generator().manual_seed(seed)
    m = cfg.max_notes
    count = torch.randint(8, m + 1, (batch,), generator=g)
    count[0], count[1] = 0, m
    mask = torch.arange(m)[None] < count[:, None]
    onset = torch.rand(batch, m, generator=g) * cfg.input_sec
    pitch = torch.randint(render.PITCH_LO, render.PITCH_HI + 1, (batch, m), generator=g).float()
    velocity = torch.randint(1, 128, (batch, m), generator=g).float()
    notes = torch.stack([onset, onset + 0.1, pitch, velocity], -1) * mask[..., None]
    return notes.cuda(), mask.cuda()


def _blend_library(table, idx_main, idx_sub, lam):
    """index_select x2 + torch.lerp in the table's dtype: K2's library yardstick."""
    return torch.lerp(table.index_select(0, idx_main), table.index_select(0, idx_sub), lam[:, None].to(table.dtype))


def phase_gather_blend(statics: render.SynthStatics, cfg, gen) -> dict:
    """K2 at the training shape: N = 64 * 27 blends of rows drawn from the
    production-size bank, each timed call on other draws."""
    table = statics.waveforms
    inputs = []
    for _ in range(REPS):
        d = render.draw_render(statics, TRAIN_BATCH, cfg, gen)
        inputs.append((table, d.main_rows.reshape(-1), d.sub_rows.reshape(-1), d.lam.reshape(-1)))
    before = cuda_place.gather_blend.launches
    out = cuda_place.gather_blend(*inputs[0])
    ref = gather_blend_plain(*inputs[0])
    torch.cuda.synchronize()
    if cuda_place.gather_blend.launches != before + 1:
        raise RuntimeError("gather_blend did not launch its kernel")
    # the same f32 operations, each rounded on its own: bit-equal
    res = {"max_abs_err": (out.float() - ref.float()).abs().max().item(), "tol": 0.0,
           "equal": bool(torch.equal(out, ref))}
    if not (res["equal"] and torch.isfinite(out.float()).all()):
        raise RuntimeError(f"gather_blend kernel disagrees with its plain version: {res}")
    res["ms"] = median_ms(cuda_place.gather_blend, inputs)
    res["plain_ms"] = median_ms(gather_blend_plain, inputs)
    res["library_ms"] = median_ms(_blend_library, inputs)
    res["library"] = "index_select x2 + torch.lerp"
    n, L = inputs[0][1].shape[0], table.shape[1]
    # each distinct bank row of the draws read once (averaged over the inputs), one row written per request
    rows_read = statistics.mean(torch.unique(torch.cat([im, isub])).numel() for _, im, isub, _ in inputs)
    res["bound_ms"], res["bound_by"] = bound(
        [(3.0 * n * L, PEAK_FP32)],  # (1 - lam) m + lam s
        (rows_read + n) * L * table.element_size() + n * 12,  # rows read, rows written; ids and lam
    )
    emit({"phase": "kernel", "name": "gather_blend", "requests": n, "L": L, "bank_rows": table.shape[0],
          "bank_gib": table.numel() * table.element_size() / 2**30, "dtype": str(table.dtype), **res})
    return res


def _place_library(blend, slot, onset, gain, chunk):
    """The rfft convolution of the JAX package's portable path: per-slot
    impulse trains convolved with the blends in the frequency domain."""
    B, S, L = blend.shape
    P = chunk + L
    imp = torch.zeros(B, S, P, device=blend.device)
    rows = torch.arange(B, device=blend.device)[:, None].expand_as(slot)
    imp.index_put_((rows.reshape(-1), slot.reshape(-1).long(), onset.reshape(-1).long()), gain.reshape(-1),
                   accumulate=True)
    spec = (torch.fft.rfft(imp, n=P) * torch.fft.rfft(blend.float(), n=P)).sum(1)
    return torch.fft.irfft(spec, n=P)[:, :chunk]


def phase_place_notes(statics: render.SynthStatics, cfg, gen) -> dict:
    """K3 at the training shape: B = 64 segments of up to 128 notes over
    27 blend rows of 30720 bf16, chunk 61440; the inputs are those the
    render gives it (`blend_notes` on random note lists and draws)."""
    chunk = cfg.chunk_samples
    inputs = []
    for r in range(REPS):
        notes, mask = random_notes(cfg, TRAIN_BATCH, SEED + 40 + r)
        d = render.draw_render(statics, TRAIN_BATCH, cfg, gen)
        blend, slot, onset, gain = render.blend_notes(statics, notes, mask, d, chunk, cfg.sample_rate)
        inputs.append((blend.to(torch.bfloat16), slot, onset, gain, chunk))
    before = cuda_place.place_notes.launches
    out = cuda_place.place_notes(*inputs[0])
    ref = place_notes_plain(*inputs[0])
    torch.cuda.synchronize()
    if cuda_place.place_notes.launches != before + 1:
        raise RuntimeError("place_notes did not launch its kernel")
    # the same f32 products added in the same order: bit-equal
    res = {"max_abs_err": (out - ref).abs().max().item(), "tol": 0.0, "equal": bool(torch.equal(out, ref))}
    if not (res["equal"] and torch.isfinite(out).all() and out.abs().max() > 0):
        raise RuntimeError(f"place_notes kernel disagrees with its plain version: {res}")
    res["ms"] = median_ms(cuda_place.place_notes, inputs)
    res["plain_ms"] = median_ms(place_notes_plain, inputs)
    res["library_ms"] = median_ms(_place_library, inputs)
    res["library"] = "rfft convolution of per-slot impulse trains (torch.fft)"
    blend, slot, onset, gain, _ = inputs[0]
    B, S, L = blend.shape
    # what these inputs need, averaged over them: each sounding note puts min(L, chunk - onset) samples in the
    # chunk (one multiply-add each); a blend row is read once, up to the longest extent of its sounding notes
    extents = [torch.clamp(chunk - o.long(), max=L) * (g != 0) for _, _, o, g, _ in inputs]
    macs = statistics.mean(float(e.sum()) for e in extents)
    row_samples = statistics.mean(
        float(torch.zeros(B, S, dtype=torch.long, device=e.device).scatter_reduce_(1, s.long(), e, "amax").sum())
        for e, (_, s, _, _, _) in zip(extents, inputs))
    res["bound_ms"], res["bound_by"] = bound(
        [(2.0 * macs, PEAK_FP32)],
        row_samples * blend.element_size() + B * chunk * 4 + slot.numel() * 12,  # rows read, out once, metadata
    )
    emit({"phase": "kernel", "name": "place_notes", "batch": B, "notes": slot.shape[1], "L": L, "chunk": chunk,
          "stream": str(blend.dtype), "mean_multiply_adds": macs, "mean_row_samples_read": row_samples, **res})
    return res


def _render_on_cpu(statics: render.SynthStatics, notes, mask, draws, cfg, rows: torch.Tensor) -> dict:
    """The card's render of segments `rows` against the port's CPU render
    (plain versions, fp32 FX products on the CPU) of the same segments, on
    the same draws and the same bf16 bank rows."""
    d = render.RenderDraws(*(x[rows] for x in draws[:5]), draws.fx.take(rows))
    used = torch.unique(torch.cat([d.main_rows.reshape(-1), d.sub_rows.reshape(-1)]))
    d = d._replace(main_rows=torch.searchsorted(used, d.main_rows), sub_rows=torch.searchsorted(used, d.sub_rows))
    small = statics._replace(waveforms=statics.waveforms[used].contiguous())
    card = render.render_batch(small, notes[rows], mask[rows], d, cfg).cpu()
    cpu = render.render_batch(
        render.SynthStatics(*(x.cpu() for x in small[:6]), small.loaded_bins), notes[rows].cpu(), mask[rows].cpu(),
        render.RenderDraws(*(x.cpu() for x in d[:5]), render.FxParams(*(x.cpu() for x in d.fx))), cfg)
    err = (card - cpu).abs()
    # K2 and K3 give the same bits on both devices; the FX products sum in
    # another order (outputs lie in [-1, 1])
    out = {"rows": rows.tolist(), "fx_rows": int(d.use_fx.sum()), "max_abs_err": err.max().item(), "tol": 1e-4}
    if not out["max_abs_err"] <= out["tol"]:
        raise RuntimeError(f"the card's render disagrees with the CPU render: {out}")
    return out


def phase_render(statics: render.SynthStatics, cfg, gen) -> dict:
    """`render_batch` at B = 64 with setting-1's FX probabilities: kernel
    path against plain path, a few rows against the CPU, output checks, and
    the median render time split by stage (CUDA events)."""
    chunk, sr = cfg.chunk_samples, cfg.sample_rate
    runs = [(*random_notes(cfg, TRAIN_BATCH, SEED + 60 + r), render.draw_render(statics, TRAIN_BATCH, cfg, gen))
            for r in range(REPS)]
    notes, mask, draws = runs[0]
    before = {k: c.launches for k, c in kernel_counters().items()}
    out = render.render_batch(statics, notes, mask, draws, cfg)
    with plain_kernels():
        ref = render.render_batch(statics, notes, mask, draws, cfg)
    torch.cuda.synchronize()
    after = {k: c.launches for k, c in kernel_counters().items()}
    if (after["gather_blend"] - before["gather_blend"], after["place_notes"] - before["place_notes"]) != (1, 1):
        raise RuntimeError(f"the render did not launch K2 and K3 once each: {before} -> {after}")
    peak = out.abs().amax(1)
    master = render.vel_to_vol(torch.where(mask, notes[..., 3], 0.0).amax(1))
    res = {"batch": TRAIN_BATCH, "chunk": chunk, "fx_rows": int(draws.use_fx.sum()),
           "fx_budget": render.fx_budget(TRAIN_BATCH, cfg.use_fx_prob),
           "equal_to_plain_path": bool(torch.equal(out, ref)), "max_abs_err_vs_plain": (out - ref).abs().max().item(),
           "peak_vs_master_max_rel_err": ((peak[1:] - master[1:]).abs() / master[1:]).max().item()}
    if not (res["equal_to_plain_path"] and out.shape == (TRAIN_BATCH, chunk) and torch.isfinite(out).all()
            and (out[0] == 0).all() and res["peak_vs_master_max_rel_err"] <= 1e-5):
        raise RuntimeError(f"render check failed: {res}")
    fx_rows = torch.nonzero(draws.use_fx[2:])[:2, 0] + 2
    res["vs_cpu"] = _render_on_cpu(statics, notes, mask, draws, cfg,
                                   torch.cat([torch.tensor([0, 1], device="cuda"), fx_rows]))

    stages = ("draw", "K2 blend + gains", "K3 place", "FX", "normalise")
    times = {s: [] for s in (*stages, "total")}
    for r in range(REPS + 1):  # the first is a warm-up
        notes, mask, _ = runs[r % REPS]
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(stages) + 1)]
        ev[0].record()
        d = render.draw_render(statics, TRAIN_BATCH, cfg, gen)
        ev[1].record()
        blend, slot, onset, gain = render.blend_notes(statics, notes, mask, d, chunk, sr)
        ev[2].record()
        wav = render.place_blend(blend, slot, onset, gain, chunk)
        ev[3].record()
        wav = render.apply_fx(wav, d, sr, cfg.use_fx_prob)
        ev[4].record()
        render.normalise(wav, notes, mask, gain)
        ev[5].record()
        torch.cuda.synchronize()
        if r:
            for i, s in enumerate(stages):
                times[s].append(ev[i].elapsed_time(ev[i + 1]))
            times["total"].append(ev[0].elapsed_time(ev[-1]))
    res["median_ms"] = {s: statistics.median(v) for s, v in times.items()}
    res["render_batch_ms"] = median_ms(lambda n, m, d: render.render_batch(statics, n, m, d, cfg), runs)
    emit({"phase": "render", **res})
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


@contextlib.contextmanager
def plain_kernels():
    """Route every kernel wrapper to its plain version, for the reference
    step: the model code calls the wrappers through their modules."""
    names = [(cuda_mel, "log_mel", cuda_mel.log_mel_plain),
             (cuda_attention, "fused_attention", cuda_attention.attention_plain),
             (cuda_attention, "fused_attention_bwd", cuda_attention.attention_bwd_plain),
             (cuda_ffn, "ffn_dropout", ffn.ffn_dropout_plain),
             (cuda_place, "gather_blend", gather_blend_plain), (cuda_place, "place_notes", place_notes_plain)]
    saved = [getattr(mod, name) for mod, name, _ in names]
    try:
        for mod, name, plain in names:
            setattr(mod, name, plain)
        yield
    finally:
        for (mod, name, _), fn in zip(names, saved):
            setattr(mod, name, fn)


def kernel_counters() -> dict:
    return {"log_mel": cuda_mel.log_mel, "fused_attention": cuda_attention.fused_attention,
            "fused_attention_bwd": cuda_attention.fused_attention_bwd, "ffn_dropout": cuda_ffn.ffn_dropout,
            "gather_blend": cuda_place.gather_blend, "place_notes": cuda_place.place_notes}


def train_batch(cfg: FrameworkConfig, seed: int) -> dict:
    """TRAIN_BATCH random 2.56 s waves and `token_batch`'s tokens."""
    g = torch.Generator().manual_seed(seed)
    wave = torch.randn(TRAIN_BATCH, cfg.shared.chunk_samples, generator=g) * 0.3
    return {"wavs": wave.cuda(), **token_batch(cfg, g)}


def token_batch(cfg: FrameworkConfig, g: torch.Generator) -> dict:
    """TRAIN_BATCH random token rows: BOS, random tokens, EOS at a random
    length (one row full), PAD; collated lengths."""
    tok = cfg.tokenizer
    eos_at = torch.randint(TRAIN_TOKENS // 4, TRAIN_TOKENS, (TRAIN_BATCH,), generator=g)
    eos_at[0] = TRAIN_TOKENS - 1
    pos = torch.arange(TRAIN_TOKENS)[None]
    body = torch.randint(4, cfg.model.tgt_vocab_size, (TRAIN_BATCH, TRAIN_TOKENS), generator=g)
    tokens = torch.where(pos < eos_at[:, None], body, tok.pad_token)
    tokens = torch.where(pos == eos_at[:, None], tok.EOS_token, tokens)
    tokens[:, 0] = tok.BOS_token
    return {"tokens": tokens.cuda(), "token_lengths": collate_token_lengths(eos_at + 1).cuda()}


def _group(name: str) -> str:
    """The part of a training step a device kernel belongs to. The port's
    own kernels come first: K4's `ffn_dropout_kernel_gemm1/2` are GEMMs
    that the library rule below would file under cuBLAS."""
    for key, group in (("attention_fwd_kernel", "K5f attention fwd"), ("attention_bwd", "K5b attention bwd"),
                       ("attention_delta", "K5b attention bwd"), ("ffn_dropout_kernel", "K4 fused FFN"),
                       ("log_mel_", "K1 log-mel"), ("gather_blend_kernel", "K2 gather + blend"),
                       ("place_notes_kernel", "K3 note placement")):
        if key in name:
            return group
    low = name.lower()
    if any(k in low for k in ("gemm", "xmma", "cutlass", "sm90_", "cublas", "nvjet")):
        return "GEMM (cuBLAS)"
    if "<long" in low or "arange" in low:
        return "int64 elementwise (dropout hash)"
    if "softmax" in low:
        return "softmax"
    if "fft" in low:
        return "FFT"
    if "reduce" in low:
        return "reductions (LayerNorm, sums, norms)"
    if "indexing_backward" in low or "embedding" in low:
        return "embedding"
    if any(k in low for k in ("copy", "memcpy", "memset", "cast")):
        return "copies, casts"
    return "other elementwise"


def step_profile(fn, label: str) -> dict:
    """Device time of one call of `fn` under torch.profiler: the busy share
    (kernel time over host wall time; the profiler's own host cost makes
    the idle share an upper bound) and the time by kernel group."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    trace = _build.BUILD_DIR.parent / f"train_trace_{label}.json"
    trace.parent.mkdir(parents=True, exist_ok=True)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    prof.export_chrome_trace(str(trace))
    kernels = [e for e in json.loads(trace.read_text()).get("traceEvents", [])
               if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    groups: dict = {}
    by_name: dict = {}
    for e in kernels:
        dur = float(e.get("dur", 0)) / 1e3
        groups[_group(e.get("name", ""))] = groups.get(_group(e.get("name", "")), 0.0) + dur
        by_name[e.get("name", "")[:90]] = by_name.get(e.get("name", "")[:90], 0.0) + dur
    busy_ms = sum(groups.values())
    return {"wall_ms": wall_us / 1e3, "device_kernels": len(kernels), "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms * 1e3 / wall_us if kernels else None,  # None: the profiler saw no device
            "by_group_ms": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
            "top_kernels_ms": sorted(by_name.items(), key=lambda kv: -kv[1])[:8]}


def _constant_lr(cfg: FrameworkConfig) -> TrainingConfig:
    """A constant lr with no warmup: every one of the few updates applies."""
    return TrainingConfig(learning_rate=TRAIN_LR, warmup_ratio=0.0, lr_scheduler_type="constant",
                          weight_decay=cfg.training.weight_decay, max_grad_norm=cfg.training.max_grad_norm)


def run_training(name: str, mc, per_step: dict, fresh, call, extra: dict) -> dict:
    """TRAIN_STEPS steps of `call(step, state, i) -> (state, metrics)` from
    `fresh() -> (step, state)`, checked against the first step through the
    plain versions (from the same weights and randomness) and the kernels'
    expected launches."""
    step, state = fresh()
    with plain_kernels():
        _, m = call(step, state, 0)
        plain0 = {k: float(v) for k, v in m.items()}
    del step, state, m
    torch.cuda.empty_cache()

    step, state = fresh()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    losses, norms, step_ms = [], [], []
    for i in range(TRAIN_STEPS):
        t0 = time.monotonic()
        state, m = call(step, state, i)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        torch.cuda.synchronize()
        step_ms.append((time.monotonic() - t0) * 1e3)
    launches = {k: c.launches for k, c in counters.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    expected = {k: per_step.get(k, 0) * TRAIN_STEPS for k in counters}
    # bf16 training: the kernel path rounds at other points than the plain
    # path (K5b's bf16 p and ds, pre and p rounding flips); measured on the
    # H100, 3e-6 of the loss and 1e-4 of the gradient norm at most
    tol = {"loss_rtol": 1e-4, "grad_norm_rtol": 2e-3}
    vs_plain = {"loss": losses[0], "plain_loss": plain0["loss"], "grad_norm": norms[0],
                "plain_grad_norm": plain0["grad_norm"], **tol}
    profile = step_profile(lambda: call(step, state, TRAIN_STEPS), name)
    res = {"phase": "training", "config": name, "batch": TRAIN_BATCH, "tokens": TRAIN_TOKENS,
           "steps": TRAIN_STEPS, "lr": f"constant {TRAIN_LR}, no warmup (every update applies)",
           "dropout": mc.dropout, **extra, "losses": losses, "grad_norms": norms, "step_ms": step_ms,
           "median_step_ms": statistics.median(step_ms), "launches": launches, "expected_launches": expected,
           "vs_plain_first_step": vs_plain, "peak_mem_gib": peak_gib, "profile_one_step": profile,
           "model_params": sum(p.numel() for p in state.model.parameters())}
    emit(res)
    if not all(math.isfinite(x) for x in losses + norms):
        raise RuntimeError(f"{name}: a loss or gradient norm is not finite")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"{name}: the loss did not fall over {TRAIN_STEPS} steps: {losses}")
    if launches != expected:
        raise RuntimeError(f"{name}: kernel launches {launches}, expected {expected}")
    if not (abs(losses[0] - plain0["loss"]) <= tol["loss_rtol"] * abs(plain0["loss"])
            and abs(norms[0] - plain0["grad_norm"]) <= tol["grad_norm_rtol"] * plain0["grad_norm"]):
        raise RuntimeError(f"{name}: the kernel path disagrees with the plain path: {vs_plain}")
    del step, state
    torch.cuda.empty_cache()
    return res


def phase_training(name: str) -> dict:
    """TRAIN_STEPS steps of one real-audio training configuration through its kernels."""
    cfg = FrameworkConfig.from_dict(TRAIN_CONFIGS[name])
    mc = cfg.model
    per_step = {"log_mel": 1}
    if mc.use_pallas_ffn and mc.dropout > 0:
        per_step["ffn_dropout"] = mc.enc_layers + mc.dec_layers
    if mc.use_flash_attention and mc.dropout == 0:
        per_step["fused_attention"] = per_step["fused_attention_bwd"] = mc.enc_layers + 2 * mc.dec_layers
    tcfg = _constant_lr(cfg)
    batch = train_batch(cfg, SEED + 10)
    gen = torch.Generator().manual_seed(SEED + 11)
    keys = [draw_site_keys(mc, gen) for _ in range(TRAIN_STEPS + 1)]

    def fresh():
        model = ADTModel(mc, seed=SEED, device="cuda")
        opt, _ = make_optimizer(tcfg, TRAIN_STEPS, model)
        return make_train_step(mc, opt, device="cuda"), init_train_state(model, opt)

    return run_training(name, mc, per_step, fresh, lambda step, state, i: step(state, batch, keys[i]), {})


def phase_synth_training(statics: render.SynthStatics) -> dict:
    """TRAIN_STEPS synthesis-fused steps of setting-1: render (K2, K3, FX) ->
    K1 -> the 4+4-layer model with dropout 0.1 -> AdamW."""
    cfg = FrameworkConfig.from_dict(SYNTH_CONFIG)
    mc, sc = cfg.model, cfg.synthetiser
    per_step = {"log_mel": 1, "gather_blend": 1, "place_notes": 1}
    tcfg = _constant_lr(cfg)
    notes, mask = random_notes(sc, TRAIN_BATCH, SEED + 12)
    batch = {"notes": notes, "note_mask": mask, **token_batch(cfg, torch.Generator().manual_seed(SEED + 13))}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    draws = [render.draw_render(statics, TRAIN_BATCH, sc, gen) for _ in range(TRAIN_STEPS + 1)]
    kgen = torch.Generator().manual_seed(SEED + 15)
    keys = [draw_site_keys(mc, kgen) for _ in range(TRAIN_STEPS + 1)]

    def fresh():
        model = ADTModel(mc, seed=SEED, device="cuda")
        opt, _ = make_optimizer(tcfg, TRAIN_STEPS, model)
        return make_synth_train_step(mc, sc, statics, opt, device="cuda"), init_train_state(model, opt)

    extra = {"max_notes": sc.max_notes, "notes_per_row": [int(n) for n in mask.sum(1).tolist()][:8],
             "fx_rows_per_step": [int(d.use_fx.sum()) for d in draws[:TRAIN_STEPS]],
             "fx_budget": render.fx_budget(TRAIN_BATCH, sc.use_fx_prob)}
    return run_training(SYNTH_NAME, mc, per_step, fresh,
                        lambda step, state, i: step(state, batch, draws[i], keys[i]), extra)


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
    counters = kernel_counters()
    try:
        for c in counters.values():
            c.launches = 0
        t0 = time.monotonic()
        threads = [threading.Thread(target=_post, args=(url, b, results, i)) for i, b in enumerate(bodies)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.monotonic() - t0
        launches = {k: c.launches for k, c in counters.items()}
        stats = engine.stats()
    finally:
        server.shutdown()
        server.server_close()
        engine.close()
    for i, r in enumerate(results):
        if r is None or r[0] != 200:
            raise RuntimeError(f"request {i} failed: {r}")
        check_notes(json.loads(r[1]), REQUEST_SEC, cfg.model.tgt_vocab_size)
    if not (launches["log_mel"] and launches["fused_attention"]):
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


# the training shapes of K5 at B = 64: (Tq, Tk, causal + padding mask)
TRAIN_ATTENTION = {"encoder": (246, 246, False), "decoder-self": (511, 511, True), "cross": (511, 246, False)}
TRAIN_FFN_ROWS = {"encoder": TRAIN_BATCH * 246, "decoder": TRAIN_BATCH * 511}


def phase_synthesis() -> dict:
    """Phases 4 and the synthesis-fused training phase, on one bank built on the card."""
    sc = FrameworkConfig.from_dict(SYNTH_CONFIG).synthetiser
    t0 = time.monotonic()
    statics = render.SynthStatics.from_bank(build_card_bank(sc, SEED + 50), device="cuda")
    torch.cuda.synchronize()
    table = statics.waveforms
    emit({"phase": "bank", "rows": table.shape[0], "samples": table.shape[1], "dtype": str(table.dtype),
          "gib": table.numel() * table.element_size() / 2**30, "loaded_bins": statics.loaded_bins,
          "build_s": round(time.monotonic() - t0, 3)})
    gen = torch.Generator(device="cuda").manual_seed(SEED + 51)
    out = {"gather_blend": phase_gather_blend(statics, sc, gen), "place_notes": phase_place_notes(statics, sc, gen),
           "render": phase_render(statics, sc, gen), "training": phase_synth_training(statics)}
    del statics, table
    torch.cuda.empty_cache()
    return out


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
    att = {b: phase_attention(b, 246, 246, False, gen, "encoder") for b in batches}
    att_train = {s: phase_attention(TRAIN_BATCH, *shape, gen, s) for s, shape in TRAIN_ATTENTION.items()}
    bwd_train = {s: phase_attention_bwd(TRAIN_BATCH, *shape, gen, s) for s, shape in TRAIN_ATTENTION.items()}
    ffn_train = {s: phase_ffn(rows, gen, s) for s, rows in TRAIN_FFN_ROWS.items()}
    synth = phase_synthesis()
    training = {c: phase_training(c) for c in TRAIN_CONFIGS}
    training[SYNTH_NAME] = synth["training"]
    serving = phase_serving(cfg)
    by_path = {"serving": serving["launches"], **{f"training-{c}": r["launches"] for c, r in training.items()}}

    def entry(kname, source, replaces, shape, res):
        keys = ("max_abs_err", "tol", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
        per_path = {p: n.get(kname, 0) for p, n in by_path.items()}
        return {"name": kname, "route": "cuda", "source": source, "replaces": replaces,
                "launches": sum(per_path.values()), "launches_by_path": per_path, "shape": shape,
                **{k: res[k] for k in keys}}

    emit({"kernels": [
        entry("log_mel", "adt_str_tpu_torch/csrc/log_mel.cu", "adt_str_tpu/ops/pallas_mel.py:112 pallas_log_mel",
              f"B={TRAIN_BATCH} chunks of 2.56 s (training; largest serving bucket)", mel[TRAIN_BATCH]),
        entry("fused_attention", "adt_str_tpu_torch/csrc/attention.cu",
              "adt_str_tpu/ops/pallas_attention.py:99 _fwd",
              f"B={TRAIN_BATCH}, 6 heads, decoder self 511 x 511, causal + padding mask", att_train["decoder-self"]),
        entry("fused_attention_bwd", "adt_str_tpu_torch/csrc/attention_bwd.cu",
              "adt_str_tpu/ops/pallas_attention.py:156 _vjp_bwd",
              f"B={TRAIN_BATCH}, 6 heads, decoder self 511 x 511, causal + padding mask", bwd_train["decoder-self"]),
        entry("ffn_dropout", "adt_str_tpu_torch/csrc/ffn_dropout.cu",
              "adt_str_tpu/ops/pallas_ffn.py:132 _fwd_call",
              f"N={TRAIN_FFN_ROWS['decoder']} rows (B={TRAIN_BATCH} x 511), d 768, d_ff 3072", ffn_train["decoder"]),
        entry("gather_blend", "adt_str_tpu_torch/csrc/gather_blend.cu",
              "adt_str_tpu/synth/pallas_place.py:99 gather_blend",
              f"N={TRAIN_BATCH} x 27 requests of 30720 bf16 from a 100,035-row bank (5.72 GiB)",
              synth["gather_blend"]),
        entry("place_notes", "adt_str_tpu_torch/csrc/place_notes.cu",
              "adt_str_tpu/synth/pallas_place.py:189 place_notes",
              f"B={TRAIN_BATCH}, 128 note slots, 27 blend rows of 30720 bf16, chunk 61440", synth["place_notes"]),
    ], "serving_bucket": bucket, "serving_at_bucket": {"log_mel": mel[bucket]["ms"], "fused_attention": att[bucket]["ms"]},
        "total_s": round(time.monotonic() - t_start, 3)})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
