"""Smoke run of the PyTorch port on one NVIDIA GPU: `python3 chip_smoke.py`.

Drives the port's serving path, its real-audio training step, its
synthesis-fused training step, its training job (`trainer.train`: epochs,
checkpoints, resume, in-training eval), its evaluation harness with greedy
and beam decoding, its offline transcription CLI, its bench, its data
parallelism (two gloo ranks on the one card, one NCCL rank, decode split
over a mesh), its tensor parallelism and FSDP (gloo ranks on the one
card), its CLAP curation CLI and its YouTube demo CLI (`adt_str_tpu_torch`)
at full width,
holds its hand-written CUDA kernels against their plain PyTorch versions,
and holds a chunk's decoded tokens independent of the rows decoded beside
it.
Imports no JAX and nothing of the JAX package. Its five configs come from
`configs/` through the port's own YAML reader (`SERVING_YAML`,
`TRAIN_YAMLS`, `SYNTH_YAML`, `EVAL_YAML`; a `config` line prints each value
the smoke overrides beside the config's). Phases, each printing one JSON
line:

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
   torch.profiler); K1 also its frequency split and its time with the split
   chosen as before the batch-invariance repair (from the batch);
   then the batch-invariance kernels, which no TPU kernel is behind
   (LayerNorm alone and with the residual add fused, the inference
   product, the inference attention): each
   against its plain version at the serving bucket's decode step (every
   product of the step: the in-projection, the 768 -> 768 projections,
   FFN 1 and 2, the generator; self- and cross-attention) and encoder and
   at the beam's rows (its in-projection, its cross rows, its gathered self
   rows), each row bit-equal at every row count of 1-64, timed as above;
   the self-attention also as the decode step reads it (`valid_keys`, the
   valid cache rows only), bit-equal to the masked read of the whole cache
   at decode steps 0-511; the same kernels at fp32 at the fp32 serving
   config's decode step (`phase_repairs_fp32`: the fused LayerNorm, every
   product of the step and the beam's in-projection, each within 1e-5 of
   fp64 and its rows bit-equal at 1-64 (beam 1-16 items), attention_rows'
   split-key design self, cross and beam cross; each batch-invariance row
   also with the library call's own device time, `library_device_ms`);
   and (`phase_domain_kernels`) the variants that take what the shipped
   configs do not send: K1's any_hop route (44.1 kHz hop 441, 22.05 kHz
   hop 220) and long_hop route (48 kHz hop 960) at B = 16, each bit-equal
   at every split; K5f and K5b in fp32 (3xTF32 on the tensor cores) at the
   training shapes and at 3 heads of 256 (bf16 and fp32), each fp32 row
   with the device time of SDPA's own fp32 kernels by name; the tensor-core K5f and
   K5b past 512 keys (1,014 and 1,023, B = 64; K5f at the long serving
   batch of 4); K4 in fp32 (3xTF32 on the tensor cores) at N = 64 * 246 and
   64 * 511;
4. synthesis (setting-1, `configs/train/setting-1.yaml`): a production-size
   one-shot bank built on the card from a seed (27 pitches x the 3 bins the
   similarity threshold 0.8 allows x 1,235 rows = 100,035 rows of 1.28 s at
   24 kHz in bf16, 5.72 GiB; the repo has no curated library); K2 (gather +
   mixup blend) at N = 64 * 27 requests from it and K3 (note placement) at
   B = 64, 128 notes, each bit-equal to its plain version and timed as in 3
   (K3 also with each launch's device time, its L2-read floor at the L2
   rate of a `copy_` measured here, its grid and ring depth, and its ptxas
   lines);
   then `render_batch` at B = 64: the kernel-path render must equal the
   plain-path render on the same draws, a few rows must agree with the
   port's CPU render, and the median render time is split into draw / K2 /
   K3 / FX / normalise; on the same bank, after the setting-1 training
   phase of 5:
   - eval (`configs/eval/ENSTinference.yaml` with K1 and K5 on, seeded
     random weights): `run_inference` over 34 items held in memory (32
     drum-like 2.56 s chunks rendered with the bank, a 1 s tail, an empty
     reference); TP, FN and FP, counted again from the token rows the
     harness decoded, must give its aggregate; `metrics.json` and
     `confusion_matrix.csv` are read back and must count every reference
     and predicted note once (TP + FN, TP + FP); K1 and K5f launch once a
     batch and once an encoder layer a batch; the F-measure of random weights is printed, not held to
     anything; decode ms a step;
   - inference: `python -m adt_str_tpu_torch.inference` on 30 s of drum
     audio and a seeded checkpoint, plain and with a 1.28 s hop, must
     write its MIDI file; then `transcribe` (K1, K5f) and the resynthesis
     (K2, K3) of the transcribed notes in this process: the CLI's MIDI
     must equal this process's; at the CLI's chunk batches (B = 12 plain,
     24 hopped) K1 must agree with its plain version and the encoder
     memory through K1 and K5f with the plain path's, and the 12-chunk
     resynthesis must equal the plain path's;
   - trainer: the training job on setting-1 at batch 64 (in-memory Lakh
     rows, a one-batch holdout, the bank): 10 steps saving and evaluating
     after 5 and 10, then a run resumed from the step-5 checkpoint; the
     resumed steps and weights must equal the straight run's, the saved
     `model.safetensors` the model, K1/K2/K3 launch once a step and an eval
     batch, one trainer batch renders bit-equal to the plain path and one
     trainer step agrees with a plain-path step; the logged steps/s, and a
     save and a restore timed on their own;
   - trainer_tmidt: the training job on TMIDT-flash at batch 64 over audio
     rendered with the bank, 6 steps at trimmed token buckets (K1, K5f,
     K5b; the 3rd traced by the trainer's `logging.profile_steps`, and
     the trace must hold every kernel of the step), then K5f and K5b
     against their plain versions at one bucket;
   - beam: `run_inference` with beam search (beam 5) over the eval items,
     every row well formed, beam 1 equal to greedy on one batch, the HTTP
     server around a beam engine answering 3 concurrent requests, decode ms
     a step and the device's busy share;
   - decode_dp: `run_inference` over a mesh of two entries of cuda:0
     (`make_mesh(devices=["cuda:0", "cuda:0"])`), greedy and beam 5: tokens,
     metrics.json and the confusion CSV equal to the one-device run at the
     entries' batch of 8, and no row different from the one-device run at
     batch 16; each entry launches K1 and K5f for its half of a batch;
   - repair_cost: greedy decode ms and device ops a step at buckets 1 and
     16, beam 5 ms a step, encode ms and the eval wall, before the
     batch-invariance repair (`before_repair`) and after it;
   - the data-parallel phases of two rank processes (multiprocessing spawn,
     torchrun's environment, gloo, both on cuda:0; each rank builds its own
     bank), after this process's single-process references and one rank of
     NCCL here (`phase_ddp`): ddp_step (full width, 32 rows a rank: the
     setting-1 and TMIDT-flash steps equal the one-process step on the same
     64 rows within 1e-4 / 2e-3, the ranks' weights bit-equal; setting-1
     as shipped for 3 steps; TMIDT-fused-ffn (K4); `ddp_loss_weighting`;
     bf16 transport; NCCL equal to the no-mesh step; step ms, busy share,
     all-reduce ms by backend and dtype), trainer_ddp (`trainer.train` in
     both ranks, 6 steps with a save and an eval at 3, a resumed run
     bit-equal, rank 0 the only writer, steps/s) and eval_ddp
     (`run_inference` over the ranks: the one-process run at batch 8);
5. training, one phase per configuration (`TRAIN_YAMLS`: TMIDT at full
   width, batch 64, with K4 or with K5; then `synth-setting-1`, the
   synthesis-fused step of setting-1 on the bank of 4): 5 steps of the
   port's `make_train_step` / `make_synth_train_step` on one seeded batch
   (random 2.56 s waves, or random note lists, and random 512-token
   sequences), at a constant learning rate of 1e-4 with no warmup (so every
   update applies). It fails unless every loss is finite, the last loss is
   below the first, the slice's kernels launched exactly as often as the
   step calls them, and the first step's loss and grad_norm agree with the
   same step through the plain versions on the card. It reports the median
   step time;
6. serving: the ENSTserving model (4+4 layers, d_model 768, vocab 1400)
   from seeded random weights, served by the port's HTTP server on
   127.0.0.1; 3 concurrent POSTs of 10 s of seeded raw f32 PCM must answer
   200 with well-formed notes, both serving kernels' launch counters must
   rise, and the kernel-path encoder memory must agree with the port's CPU
   path (which the tests hold against the JAX package);
   then decode_dp's serving part: a `ServingEngine` over the two-entry mesh
   (its even buckets; a bucket of 1 must raise) answers the same requests
   with the one-device engine's notes;
   then batch_invariance: 4 chunks decoded alone and in batches of 2, 4,
   8, 16 and 64 (greedy), 2 alone and in a batch of 16 (beam 5), the
   requests one at a time and concurrently through `ServingEngine`: equal
   tokens and notes; and the op probe (`batch_probe`: every op of the
   encoder, the greedy and the beam decode steps at 1-64 rows against the
   first rows of the largest) before the repair and after it, when it
   must list no op;
7. bench: the port's bench (`adt_str_tpu_torch/bench.py`'s `main`) with
   its whole workload prints its JSON line on a line of its own, with
   every window's time, the launches of K1, K2 and K3 in the timed
   windows (once a step each);
   one bench batch (48 note slots, the 192-row bank) rendered through K2
   and K3 must equal its plain-path render on the same draws;
8. clap (`configs/preprocess/clap.yaml` at laion/clap-htsat-fused's widths,
   `ClapAudioArch()` and `ClapTextArch()`, on seeded random weights: no
   CLAP checkpoint is in the repo): K1 at CLAP's frontend, (32, 480000),
   48 kHz, n_fft 1024, hop 480, 64 mels, dB, no trim, against its plain
   version within 1e-3 dB and timed as in 3; a checkpoint written by the
   port (`config.json` + `model.safetensors`, 153.5 M parameters); a
   synthetic library of 1,024 one-shots of 0.2-1.0 s (as
   `tools/bench_curation.py` makes them) and a reference tree of the 48
   `REFERENCE_CLASSES` with 2 WAVs each; `python -m
   adt_str_tpu_torch.scripts.augment_data_with_clap` on them (wall s,
   files/s); the same curation in this process (K1 once a batch and no
   other kernel; the embeddings kept): every library file copied once into
   the `<class>/<bin>` that the port's assignment of the kept embeddings
   gives, that assignment equal to an fp64 argmax but for near ties
   (top-two margin < 1e-6), the CLI's tree equal to this one but for near
   ties or bin edges; a batch's time by part (host padding, upload, K1,
   tower), the decode, the assignment, the device busy share over an
   encode, peak memory; one batch's embeddings through K1 and through its
   plain version (cosine >= 0.9999), 4 clips on the card against the CPU
   on the same route (< 1e-3), a mesh of two entries of cuda:0 against one
   device at the entries' batch, and 8 token rows of 16-77 through the
   text tower on the card against the CPU, `semantic_match` rows summing
   to 1;
9. tp (`phase_tp`): tensor parallelism at full width. The kernels
   at a rank's shapes against their plain versions (K1 at the TP batch of
   8; K5f and K5b at 3 heads of 128; K4 at d_ff 1536 from col0 0 and 1536
   of 3072 in its partial mode); two rank processes on cuda:0 over gloo (a
   1 x 2 mesh) train TMIDT-flash and TMIDT-fused-ffn for 2 steps from the
   same seeded weights, the first step within 1e-3 (loss) and 1e-2 (grad
   norm) of the one-process step on the same weights, batch and keys, the
   ranks' numbers and replicated weights bit-equal, the kernels launched
   as the steps need; `trainer.train` at `mesh.model_axis: 2` for 2 steps
   and a run resumed from the first save, bit-equal, its checkpoint
   written whole and loading into a one-process model whose shards are the
   ranks' weights; NCCL a card a rank where there are two cards, else a
   line that says it was not run;
10. fsdp (`phase_fsdp`): FSDP at full width (`mesh.fsdp: true`). Two
   rank processes on cuda:0 over gloo (a 2 x 1 mesh, 4 of the 8 rows
   each) train TMIDT-flash and TMIDT-fused-ffn for 2 steps from the same
   seeded weights: the first step within 1e-3 (loss) and 1e-2 (grad norm)
   of the one-process step on the same weights, rows and keys, and
   against the DDP step on the same ranks the loss bit-equal and the grad
   norm within 1e-5; each rank's resting bytes (parameters, mu, nu) under
   FSDP and DDP, its peak memory, step ms and the two collectives' ms; four
   ranks (2 x 2, TP inside FSDP) against the same one-process step;
   `trainer.train` at `mesh.fsdp: true` for 2 steps and a run resumed from
   the first save, bit-equal, its checkpoint written whole and loading into
   a one-process model whose FSDP shards are the ranks' weights; NCCL a
   card a rank where there are two cards, else a line that says it was
   not run;
11. youtube (`phase_youtube`): the demo CLI on 30 s of seeded drum-like
   audio with `--skip-demucs`, the serving config and a checkpoint from the
   port's writer, plain and with a 1.28 s hop (its MIDI and preview WAV
   written, its note count equal to this process's); each chunk decoded
   alone equal to its row of the batch; `--url` without yt-dlp fails; a
   one-hot multi-hot `decode_logits` on the card equal to the id path's;
12. the configs JAX's gates send to its kernels beyond the shipped
   ones: 3 steps of TMIDT-flash and TMIDT-fused-ffn at `compute_dtype:
   float32` (64 x 512; the 3xTF32 K5f and K5b, or fp32 K4), each step
   within 1e-5 (loss) and 1e-4 (grad norm) of the plain fp32 path;
   TMIDT-flash at `input_sec: 10.24` and 1,024 tokens for 3 steps at batch
   64 (K5 past 512 keys), held as the bf16 training phases are; the
   serving config at fp32 (3 x 10 s: greedy tokens equal to the plain fp32
   path's, a differing row only where the plain path's top two logits at
   its first differing step lie within 1e-4), at 10.24 s chunks and
   max_length 1,024 (a 30 s request each; the encoder memory against the
   plain path, the tokens reported) and at 44.1 kHz (K1's any_hop route
   within 1e-4 of its plain version; the memory against the plain path;
   the tokens held as at fp32, a tie at bf16 rounding being a top two
   within 2^-5 of the top logit) and at 48 kHz with `time_res: 0.02` (hop
   960: K1's long_hop route; held as at 44.1 kHz), each served over HTTP
   with its kernel variants launched;
   then (`phase_fp16_and_wide_heads`) fp16 and head dims past 128 at full width: 3
   TMIDT-flash steps at 3 heads of 256 (bf16: the head-dim-256
   tensor-core K5f and K5b) and 3 steps each of TMIDT-flash and
   TMIDT-fused-ffn at `compute_dtype: float16`, every step within 1e-4
   (loss) and 2e-3 (grad norm) of the plain path's step from the same
   weights (at fp16 the grad norm within 2e-3 plus a tenth of the plain
   fp16 step's own distance from the fp32 step's: fp16 without loss
   scaling underflows; `run_training`); the serving config at
   fp16 and at 2 heads of 384 (the wide K5f and attention_rows), 3 x
   10 s each, tokens held as at 44.1 kHz; at each, 4 chunks decoded alone
   and spread in a batch of 16, bit-equal. The kernel phases before it
   also hold and time K5 at fp16 (head dim 128), at head dim 256 (bf16,
   fp16: the tensor cores; fp32) and past it (2 heads of 384, 1 of 768),
   K4 at fp16 and at d_ff 1000 and 1036 (padded in the wrapper), and the
   batch-invariance kernels at fp16 and attention_rows at 2 heads of 384
   (`phase_repairs_fp16`);
   then (`phase_export_serving`) the compile-once serving export
   (`scripts/export_serving.py`): the serving config exported at bucket
   16 and at the symbolic batch in bf16 and at bucket 16 in fp32, and two
   1+1-layer artifacts at d 768 for K1's any_hop and long_hop routes and
   K5f at head dims 256 and 384 (64 tokens); each saved to bytes and run,
   all in one fresh process that imports only `torch` and
   `adt_str_tpu_torch.ops` (`scripts/run_artifact.py`), on the chunks of
   the serving phase's requests (padded to the bucket with zero rows):
   tokens bit-equal to the eager `greedy_decode`'s (the symbolic artifact
   at 1, 16 and 64 rows), each op of an artifact's graph launched in its
   run and every registered op in one; export, save and load seconds,
   bytes, and wall and device ms a decode step (with the device kernels
   that took most) of the artifact and of the eager loop at bucket 16;
13. one `{"kernels": [...]}` line: each kernel variant (the TPU kernels'
   by route, dtype and core, then the three batch-invariance kernels) at
   the main-path shape named in its entry, with its launches in every
   main-path run (serving, the three
   training steps, bench, eval, inference, trainer, trainer-resumed,
   trainer_tmidt, beam, beam-serving, the data-parallel phases summed over
   their ranks, the NCCL step, decode_dp greedy, beam and serving, clap,
   batch_invariance's greedy runs, the tp phase's steps and trainer, the
   fsdp phase's steps, 2 x 2 grid and trainer, the youtube phase's batched
   decodes, the fp32 and long training steps, the fp32, long, 44.1 kHz
   and 48 kHz serving runs, the 3-head and fp16 training steps, the fp16
   and 2-head serving runs and their alone-and-batched decodes, and each
   export_serving artifact's runs);
   K1's entry also holds its numbers at CLAP's frontend
   (`at_clap_frontend`), K5f's and K5b's at 3 heads (`at_3_heads`) and past
   512 keys (`past_512_keys`), K4's in its partial mode
   (`partial_d_ff_1536`) and at fp16 and odd d_ff, K5's at fp16, the
   head-dim-256 K5's at fp16, the 3xTF32 K5's other shapes
   (`other_shapes`: fp32, and bf16 and fp16 past head dim 256), the
   batch-invariance kernels' at fp16 (and attention_rows' at 2 heads of
   384, and at fp32), `attention_rows_split`'s entry is the decode
   self-attention at d 2,048 with its 2-head, d-2,048 cross and fp32 rows
   beside it, and `layer_norm`'s entry is the
   fused call the decode step makes (LayerNorm(x + r)), its one-input
   entry and the encoder's fused call beside it.

Then the card's `nvidia-smi` line, and last `{"ok": true, "device": ...}`.
Any failed phase raises: no `ok` line and a nonzero exit.

`python3 chip_smoke.py --compare LABEL=DIR [LABEL=DIR ...] --order
LABEL,LABEL,...` runs none of that: it measures the decode step's
LayerNorm (and the fused add, where a tree has it), product (bf16 and
fp32) and attention kernels of several trees (the roots of `git
archive`s, each building into its own `build/kernels/`) and their decode
loops (the serving config's, and the d-2,048, 2-head and fp32 configs'
device ms a step, and the fp32 TMIDT-fused-ffn step, where the tree has
them), one process a run in the given order, and groups the runs by
bit-equal outputs on seeded inputs (LayerNorms, products in bf16 and fp32,
attentions, greedy and beam tokens at bf16 and on the fp32 serving config;
`compare_trees`).

`python3 chip_smoke.py --fp32-drift` runs none of it either: the 3xTF32
K5's and K4's fp32 rows, an fp64 witness for a fully masked row, and
TMIDT-flash and TMIDT-fused-ffn at fp32 on separate 3-step trajectories
from the same weights (the kernel path; the plain path with its products in
emulated 3xTF32, in another fp32 order, or, flash, through fp32 SDPA), each
held to the plain path's, with Adam's first-step sign flips per leaf
(`fp32_drift`).
"""

from __future__ import annotations

import contextlib
import copy
import csv
import dataclasses
import hashlib
import json
import logging
import math
import multiprocessing
import os
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from adt_str_tpu_torch import bench as port_bench
from adt_str_tpu_torch import torch_dtype
from adt_str_tpu_torch import inference as port_inference
from adt_str_tpu_torch.clap import curation as clap_curation
from adt_str_tpu_torch.clap import features as clap_features
from adt_str_tpu_torch.clap import model as clap_model
from adt_str_tpu_torch.clap.audio_model import ClapAudioArch
from adt_str_tpu_torch.clap.text_model import ClapTextArch
from adt_str_tpu_torch.clap.text_model import get_text_features as clap_text_features
from adt_str_tpu_torch.config import FrameworkConfig, TrainingConfig
from adt_str_tpu_torch.data.datasets import LakhDataset, TMIDTDataset
from adt_str_tpu_torch.domain.segmenter import chunk_wave
from adt_str_tpu_torch.domain.tokenizer import MidiTokenizer
from adt_str_tpu_torch.evaluation.harness import run_inference
from adt_str_tpu_torch.evaluation.metrics import aggregate_metrics, compute_metrics
from adt_str_tpu_torch.evaluation.notes import decode_tokens_to_notes
from adt_str_tpu_torch.models import transformer as T
from adt_str_tpu_torch.models.adt import ADTModel, collate_token_lengths, draw_site_keys, mel_params
from adt_str_tpu_torch.models.convert import read_safetensors, write_safetensors
from adt_str_tpu_torch.models.decode import (
    beam_search_decode,
    beam_search_decode_from_memory,
    decode_step,
    greedy_decode,
    greedy_decode_from_memory,
    init_caches,
)
from adt_str_tpu_torch.ops import _build, attention_rows, cuda_attention, cuda_ffn, cuda_mel, cuda_place, ffn, op_wrappers
from adt_str_tpu_torch.ops import layer_norm as ln_ops
from adt_str_tpu_torch.ops import linear as linear_ops
from adt_str_tpu_torch.ops.dropout_hash import seed_from_key
from adt_str_tpu_torch.ops.mel import MelFrontendParams
from adt_str_tpu_torch.ops.place import gather_blend_plain, place_notes_plain
from adt_str_tpu_torch.parallel import fsdp as fsdp_lib
from adt_str_tpu_torch.parallel import mesh as mesh_lib
from adt_str_tpu_torch.parallel import tensor_parallel as tp_lib
from adt_str_tpu_torch.parallel import train_step as port_step
from adt_str_tpu_torch.parallel.train_step import init_train_state, make_synth_train_step, make_train_step
from adt_str_tpu_torch.serve import build_engine
from adt_str_tpu_torch.scripts import export_serving as texport
from adt_str_tpu_torch.scripts import youtube_drum_pipeline as youtube_demo
from adt_str_tpu_torch.scripts.run_artifact import decode_steps, loop_figures
from adt_str_tpu_torch.synth import render
from adt_str_tpu_torch.synth.bank import N_BINS, OneShotBank, n_allowed_bins
from adt_str_tpu_torch.training import checkpoint as trainer_ckpt
from adt_str_tpu_torch.training import trainer
from adt_str_tpu_torch.training.optimizer import make_optimizer
from adt_str_tpu_torch.serving.http import make_server, start_in_thread
from adt_str_tpu_torch.utils.audio_io import load_and_resample, normalize, write_wav
from adt_str_tpu_torch.utils.mappings import ADTOF_LABEL_MAPPING
from adt_str_tpu_torch.utils.midi_io import write_midi

REPO = Path(__file__).resolve().parent
# the repo's configs, read on the card's machine by the port's own YAML reader
SERVING_YAML = "configs/serve/ENSTserving.yaml"
TRAIN_YAMLS = {"fused-ffn": "configs/train/TMIDT-fused-ffn.yaml", "flash": "configs/train/TMIDT-flash.yaml"}
SYNTH_YAML = "configs/train/setting-1.yaml"
SYNTH_NAME = "synth-setting-1"
EVAL_YAML = "configs/eval/ENSTinference.yaml"  # the eval and inference phases' config, with K1 and K5 on
KERNELS_ON = {"use_pallas_mel": True, "use_flash_attention": True}
EVAL_CHUNKS = 32  # full 2.56 s items; a short tail item and an empty-reference item join them
EVAL_TAIL_SEC = 1.0
EVAL_GM_PITCHES = [35, 36, 38, 40, 41, 42, 44, 45, 46, 48, 49, 51, 56]  # GM standard drums
INFERENCE_SEC = 30.0
INFERENCE_HOP_SEC = 1.28
BANK_ROWS_PER_BIN = 1235  # 27 pitches x 3 bins x 1,235 = 100,035 rows: the ~100k-one-shot production bank
BANK_BUILD_ROWS = 4096  # rows generated at once (a 0.5 GB f32 intermediate)
TRAIN_BATCH = 64  # configs/train/setting-1.yaml's batch size; the TMIDT configs' 128 is overridden
TRAIN_TOKENS = 512  # TrainDatasetConfig.max_tokens: decoder inputs of 511 tokens
TRAIN_STEPS = 5
TRAIN_LR = 1e-4
TRAINER_ROWS = 512  # the trainer phase's in-memory Lakh rows
TRAINER_HOLDOUT = 0.125  # 64 rows: one eval batch
TRAINER_STEPS = 10  # 7 steps an epoch; saved and evaluated after 5 and 10; the resumed run takes 6-10
TMIDT_STEPS = 6
TMIDT_PROFILED = 2  # the step index `logging.profile_steps` traces (the 3rd step)
BEAM_SIZE = 5

# H100 SXM data-sheet peaks (dense): bf16 and TF32 tensor cores, fp32 CUDA cores, HBM3
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
PEAK_FP32 = 67e12
# an fp32-accurate product on the card: three TF32 products (3xTF32) on the tensor cores, faster than one
# fp32 FMA on the CUDA cores (3 / 495e12 < 1 / 67e12), so fp32 products are priced at the TF32 rate
TF32_PRODUCTS = 3
PEAK_BYTES = 3.35e12
REPS = 12
SEED = 0
# the bf16 kernel path's step tolerances (PERF.md §2): it rounds at other points than the plain path
# (K5b's bf16 p and ds, pre and p rounding flips); measured on the H100, 3e-6 of the loss and 1e-4 of
# the gradient norm at most
PARITY_TOL = {"loss_rtol": 1e-4, "grad_norm_rtol": 2e-3}
N_REQUESTS = 3
REQUEST_SEC = 10.0


T0 = time.monotonic()


def emit(obj) -> None:
    """One JSON line; a phase's line also gives the seconds since the smoke began (`t_s`)."""
    if "phase" in obj:
        obj = {**obj, "t_s": round(time.monotonic() - T0, 1)}
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
    cost that `median_ms` includes when one call cannot fill the card. A
    profiler session now and then records no device event at all, or only
    some of the calls' kernels (a kernel seen fewer times than there are
    calls); such a session is taken again, up to 3 times."""
    fn(*inputs[0])
    torch.cuda.synchronize()
    out: dict = {}
    for _ in range(3):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for args in inputs:
                fn(*args)
            torch.cuda.synchronize()
        out, seen = {}, {}
        for e in prof.key_averages():
            if e.device_time_total > 0:
                name = e.key.replace("(anonymous namespace)::", "").split("(")[0]
                out[name] = out.get(name, 0.0) + e.device_time_total / len(inputs) / 1e3
                seen[name] = seen.get(name, 0) + e.count
        if out and min(seen.values()) >= len(inputs):
            break
    return out


def bound(flops_by_peak: list[tuple[float, float]], n_bytes: float) -> tuple[float, str]:
    """The least time in ms and what sets it: the tensor-core and CUDA-core
    pipes and the memory run at once, so the slowest of the three binds."""
    ops_s = max(f / peak for f, peak in flops_by_peak)
    bytes_s = n_bytes / PEAK_BYTES
    return max(ops_s, bytes_s) * 1e3, ("operations" if ops_s >= bytes_s else "bytes")


def product_cost(flops: float, dtype) -> tuple[float, float]:
    """(operations, peak) of matrix products of `flops` whose operands are
    `dtype`: bf16 and fp16 on the tensor cores at bf16's rate; fp32 as
    TF32_PRODUCTS TF32 products, the least an fp32-accurate product takes."""
    if dtype == torch.float32:
        return TF32_PRODUCTS * flops, PEAK_TF32
    return flops, PEAK_BF16


def load_config(path: str, train: bool = False, show: bool = True, **sections: dict) -> FrameworkConfig:
    """`path` (relative to the repo) through the port's YAML reader, with the
    fields of `sections` ({"model": {"use_pallas_mel": True}, ...}) replaced;
    prints the values the smoke overrides, each beside the config's own
    (unless `show` is off, as in the rank processes)."""
    cfg = FrameworkConfig.from_yaml(REPO / path)
    overrides = {}
    for section, fields in sections.items():
        old = getattr(cfg, section)
        for k, v in fields.items():
            overrides[f"{section}.{k}"] = {"config": getattr(old, k), "smoke": v}
        setattr(cfg, section, dataclasses.replace(old, **fields))
        if section == "shared":  # `shared` is splatted into these sections (`FrameworkConfig.from_dict`)
            for part in ("model", "synthetiser", "train_data", "eval_data"):
                sub = getattr(cfg, part)
                names = {f.name for f in dataclasses.fields(sub)} if sub is not None else set()
                if fields.keys() & names:
                    setattr(cfg, part, dataclasses.replace(sub, **{k: v for k, v in fields.items() if k in names}))
    if train:
        t = cfg.training
        overrides["training.schedule"] = {
            "config": f"{t.lr_scheduler_type} from {t.learning_rate}, warmup {t.warmup_ratio}",
            "smoke": f"constant {TRAIN_LR}, no warmup"}
        overrides["training.batch_size"] = {"config": cfg.raw["training"].get("batch_size"), "smoke": TRAIN_BATCH}
        overrides["TrainDatasetConfig.max_tokens"] = {
            "config": cfg.raw.get("TrainDatasetConfig", {}).get("max_tokens"), "smoke": TRAIN_TOKENS}
    if cfg.synthetiser is not None:
        overrides["synthetiser.max_notes"] = {"config": cfg.raw["synthetiser"]["max_notes"],
                                              "smoke": cfg.synthetiser.max_notes}
    if show:
        emit({"phase": "config", "path": path, "overrides": overrides})
    return cfg


def phase_card() -> tuple[str, str]:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    emit({"phase": "card", "nvidia_smi": smi, "device": name, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return smi, name


def phase_build() -> dict:
    """-> each kernel's ptxas lines (entry, registers, spills, serialisation)."""
    t0 = time.monotonic()
    reports = _build.build_all()
    secs = time.monotonic() - t0
    ptxas = {name: [line.strip() for line in log.splitlines()
                    if any(k in line for k in ("entry function", "registers", "spill", "serialized"))]
             for name, log in reports.items()}
    for name, lines in ptxas.items():
        for line in lines:
            print(f"[ptxas {name}] {line}", flush=True)
    emit({"phase": "build", "kernels": sorted(reports), "seconds": round(secs, 3)})
    return ptxas


def copy_rate(n_bytes: int, copies: int = 50) -> float:
    """Bytes per second that `dst.copy_(src)` moves (read plus written) for
    an f32 tensor of `n_bytes`: a CUDA graph of `copies` copies replayed
    between two events, median of 5 replays, so the host's launch cost
    (which a copy that fits in L2 does not hide) stays out."""
    src = torch.randn(n_bytes // 4, device="cuda")
    dst = torch.empty_like(src)
    dst.copy_(src)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(copies):
            dst.copy_(src)
    graph.replay()
    times = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / 1e3 / copies)
    return 2 * n_bytes / statistics.median(times)


def mel_library(wave, params, trim=True):
    """torch.stft + the mel matmul + the log tail: the library yardstick of K1."""
    window = torch.hann_window(params.n_fft, periodic=True, device=wave.device)
    spec = torch.stft(wave, params.n_fft, params.hop_length, window=window, center=True,
                      pad_mode="reflect", return_complex=True)
    power = spec.real**2 + spec.imag**2  # (B, n_freqs, frames)
    fb = cuda_mel._device_constants(params, wave.device)[2][: params.n_freqs]
    mel = torch.matmul(power.transpose(1, 2), fb)
    if params.log_mode == "db":
        out = 10.0 * torch.log10(torch.clamp(mel, min=params.log_floor))
    else:
        logmel = torch.clamp(torch.log(mel + params.log_floor), params.clamp_lo, params.clamp_hi)
        out = (logmel - params.clamp_lo) / (params.clamp_hi - params.clamp_lo)
    if not trim:
        return out
    p = params.window_pad_idxs
    return out[:, p : mel.shape[1] - p - 1]


def main_path_bucket(cfg: FrameworkConfig) -> int:
    """The bucket the serving phase's requests fill when they share one batch."""
    chunks = N_REQUESTS * math.ceil(REQUEST_SEC * cfg.shared.sample_rate / cfg.shared.chunk_samples)
    return next(b for b in cfg.serving.buckets if b >= chunks)


def time_log_mel(inputs: list, tol: float, frame_tol: float | None = None) -> dict:
    """K1 against its plain version on the first of `inputs` ((wave, params,
    trim) each), then its kernel, device, plain and library times over all
    of them and the least time the card could take. Each output must lie
    within `tol`; with `frame_tol` (dB outputs), a band may instead lie
    within `frame_tol` of its frame's total mel power on the power scale: the
    two sum the same fp32 products in other orders, and where a band's power
    is a deep dip of the spectrum (a cancelling sum) that order moves its dB
    value by more than the loud bands' tolerance."""
    wave, params, trim = inputs[0]
    route = cuda_mel.frames_route(params)
    counter = cuda_mel.ROUTE_WRAPPERS[route]
    before = counter.launches
    out = cuda_mel.log_mel(*inputs[0])
    ref = cuda_mel.log_mel_plain(*inputs[0])
    torch.cuda.synchronize()
    if counter.launches != before + 1:
        raise RuntimeError(f"log_mel did not launch its {route} kernel")
    err = (out - ref).abs()
    res = {"route": route, "max_abs_err": err.max().item(), "mean_abs_err": err.mean().item(), "tol": tol}
    ok = err <= tol
    if frame_tol is not None:
        power, ref_power = 10.0 ** (out.double() / 10), 10.0 ** (ref.double() / 10)
        frame_err = (power - ref_power).abs() / ref_power.sum(dim=-1, keepdim=True)
        ok |= frame_err <= frame_tol
        res.update(tol={"db": tol, "or_power_over_frame_power": frame_tol},
                   max_power_err_over_frame_power=frame_err.max().item(),
                   bands_over_db_tol=int((err > tol).sum().item()), bands=err.numel())
    if not (torch.isfinite(out).all() and bool(ok.all())):
        raise RuntimeError(f"log_mel kernel disagrees with its plain version: {res}")
    res["ms"] = median_ms(cuda_mel.log_mel, inputs)
    res["device_ms"] = device_ms(cuda_mel.log_mel, inputs)  # the main kernel and, when split, the reduction
    res["plain_ms"] = median_ms(cuda_mel.log_mel_plain, inputs)
    res["library_ms"] = median_ms(mel_library, inputs)
    B, T = wave.shape
    res.update(log_mel_splits(inputs, out))
    rows, k = B * out.shape[1], cuda_mel.used_bins(params)  # the bins the mel bands weigh
    res["bound_ms"], res["bound_by"] = bound(
        [(4.0 * rows * params.n_fft * k, PEAK_BF16), (2.0 * rows * k * params.n_mels, PEAK_FP32)],
        B * T * 4 + 2 * params.n_fft * k * 2 + k * params.n_mels * 4 + rows * params.n_mels * 4,
    )
    return res


def log_mel_splits(inputs: list, out: torch.Tensor) -> dict:
    """K1 at the split its wrapper picks (one wave of the SMs) and forced to
    each other split up to the frequency tiles: the time at each, and the
    output, which must be `out`'s bits at every split (the band sums run in
    tile order, so the split moves no bit). Split 4 is what a budget of 8
    blocks a 2.56 s chunk gives at every batch, split 8 a budget of 16."""
    wave, params, _ = inputs[0]
    n_tiles = cuda_mel.mel_table(params).shape[0] // cuda_mel.FREQ_TILE
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    res = {"split": cuda_mel.freq_split(wave.shape[0] * -(-out.shape[1] // cuda_mel.TILE_FRAMES), n_tiles, sms),
           "ms_at_split": {}, "bits_equal_at_split": {}}
    for split in (1, 2, 4, 8):
        if split <= n_tiles:
            with swapped([(cuda_mel, "freq_split", lambda *_: split)]):
                res["bits_equal_at_split"][split] = bool(torch.equal(cuda_mel.log_mel(*inputs[0]), out))
                res["ms_at_split"][split] = median_ms(cuda_mel.log_mel, inputs)
    if not all(res["bits_equal_at_split"].values()):
        raise RuntimeError(f"log_mel's bits follow its split: {res}")
    return res


def phase_mel(params, batch: int, gen) -> dict:
    T = int(2.56 * params.sample_rate)  # a chunk: 61,440 samples at the model's 24 kHz
    inputs = [(torch.randn(batch, T, generator=gen, device="cuda") * 0.3, params, True) for _ in range(REPS)]
    res = time_log_mel(inputs, 1e-4)  # same bf16 operands, fp32 accumulation in another order
    emit({"phase": "kernel", "name": cuda_mel.ROUTE_WRAPPERS[res["route"]].__name__, "batch": batch,
          "sample_rate": params.sample_rate, "hop": params.hop_length, "n_fft": params.n_fft, **res})
    return res


# ------------------------------------------------- the batch-invariance kernels


def bf16_ulp(t: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """The spacing of bf16 (8 significant bits; `dtype` fp16: 11) at |t|, floored at 2^-20."""
    bits = 10 if dtype == torch.float16 else 7
    return torch.exp2(torch.floor(torch.log2(t.float().abs().clamp(min=2.0**-20))) - bits)


def rows_invariant(fn, inputs: tuple, counts, row_dims: tuple) -> dict:
    """`fn` on the first r rows of `inputs` (sliced along each input's row
    dim, None: shared) for each r of `counts`, each against the first r
    rows of `fn` on all of them: -> {r: bit-equal}."""
    full = fn(*inputs)
    out = {}
    for r in counts:
        part = fn(*(x if d is None else x.narrow(d, 0, r).contiguous() for x, d in zip(inputs, row_dims)))
        out[r] = bool(torch.equal(part, full.narrow(0, 0, r)))
    return out


def time_repair(fn, plain, library, inputs: list, flops: list, n_bytes: float) -> dict:
    """A batch-invariance kernel's times over the staged inputs: kernel,
    device, plain version, library call (host-timed, and its own device
    kernels by name: `library_device_ms`), and the least time the card could
    take."""
    res = {"ms": median_ms(fn, inputs), "device_ms": device_ms(fn, inputs), "plain_ms": median_ms(plain, inputs),
           "library_ms": median_ms(library, inputs), "library_device_ms": device_ms(library, inputs)}
    res["bound_ms"], res["bound_by"] = bound(flops, n_bytes)
    return res


def launched_once(fn, *args):
    """`fn(*args)`, which must launch its kernel once."""
    before = fn.launches
    out = fn(*args)
    torch.cuda.synchronize()
    if fn.launches != before + 1:
        raise RuntimeError(f"{fn.__name__} did not launch its kernel")
    return out


def phase_layer_norm(gen, rows: int, shape: str, counts=(1, 2, 4, 8, 16, 32, 64), rows_per: int = 1,
                     d: int = 768, dtype=torch.bfloat16) -> dict:
    """The LayerNorm kernel at (rows, d) bf16 against its plain version
    within 1 bf16 ulp of the plain output, an output below 2^-6 counting as
    2^-6 (there y = p + b cancels, p ~ -b, and the two versions' fp32
    statistics, summed in other orders, leave p's last fp32 bits apart; fp32
    rows: within 1e-5), its rows
    bit-equal at each of `counts` leading blocks of `rows_per` rows (chunks
    of the encoder, one a decode row) against all 64, and timed against
    `F.layer_norm` on fp32. `dtype` fp16: within 1 fp16 ulp likewise."""
    def make(n, dt=dtype):
        x = (torch.randn(n, d, generator=gen, device="cuda") * 2.0 + 0.5).to(dt)
        w = 1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")
        b = 0.1 * torch.randn(d, generator=gen, device="cuda")
        return x, w, b, 1e-5

    inputs = [make(rows) for _ in range(REPS)]
    out = launched_once(ln_ops.layer_norm, *inputs[0])
    ref = ln_ops.layer_norm_plain(*inputs[0])
    err = (out.float() - ref.float()).abs()
    ulp = bf16_ulp(ref.float().abs().clamp(min=2.0**-6), dtype)
    x32 = make(rows, torch.float32)
    err32 = (launched_once(ln_ops.layer_norm, *x32) - ln_ops.layer_norm_plain(*x32)).abs().max()
    inv = rows_invariant(lambda x, w, b: ln_ops.layer_norm(x, w, b, 1e-5), make(64 * rows_per)[:3],
                         [r * rows_per for r in counts], (0, None, None))
    res = {"max_abs_err": err.max().item(), "ulps": (err / ulp).max().item(), "dtype": str(dtype),
           "tol": f"1 {str(dtype)[6:]} ulp of max(|plain output|, 2^-6); fp32: 1e-5", "fp32_max_abs_err": err32.item(),
           "rows_bit_equal": {r // rows_per: v for r, v in inv.items()}, "rows_per_count": rows_per}
    if not (bool((err <= ulp).all()) and res["fp32_max_abs_err"] <= 1e-5 and all(inv.values())):
        raise RuntimeError(f"layer_norm kernel at {shape}: {res}")
    res.update(time_repair(ln_ops.layer_norm, ln_ops.layer_norm_plain,
                           lambda x, w, b, eps: torch.nn.functional.layer_norm(x.float(), (d,), w, b, eps), inputs,
                           [(8.0 * rows * d, PEAK_FP32)], rows * d * out.element_size() * 2 + 2 * d * 4))
    emit({"phase": "kernel", "name": "layer_norm", "shape": shape, "rows": rows, "d": d, **res})
    return res


def _add_ln_library(x, r, w, b, eps):
    """`x + r` then `F.layer_norm` on fp32: the fused kernel's library yardstick."""
    return torch.nn.functional.layer_norm((x + r).float(), (x.shape[-1],), w, b, eps)


def _add_then_layer_norm(x, r, w, b, eps):
    """The unfused form: ATen's add, then the kernel's one-input entry."""
    return ln_ops.layer_norm(x + r, w, b, eps)


def phase_add_layer_norm(gen, rows: int, shape: str, counts=(1, 2, 4, 8, 16, 32, 64), rows_per: int = 1,
                         d: int = 768, dtype=torch.bfloat16) -> dict:
    """The fused `add_layer_norm` (LayerNorm(x + r), the residual add in the
    kernel) at (rows, d) bf16, held three ways: against its plain version
    within `phase_layer_norm`'s tolerance (fp32 rows within 1e-5);
    bit-equal (`torch.equal`) to the unfused form, ATen's `x + r` then the
    kernel's one-input entry; its rows bit-equal at each of `counts` leading
    blocks of `rows_per` rows against all 64. Timed against the unfused form
    and `x + r` then `F.layer_norm` on fp32; the bound counts x, r and y
    once each. `dtype` fp16: 1 fp16 ulp in place of the bf16 one."""
    def make(n, dt=dtype):
        x = (torch.randn(n, d, generator=gen, device="cuda") * 2.0 + 0.5).to(dt)
        r = (torch.randn(n, d, generator=gen, device="cuda") * 1.5 - 0.25).to(dt)
        w = 1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")
        b = 0.1 * torch.randn(d, generator=gen, device="cuda")
        return x, r, w, b, 1e-5

    inputs = [make(rows) for _ in range(REPS)]
    before = ln_ops.layer_norm.launches
    out = ln_ops.add_layer_norm(*inputs[0])
    torch.cuda.synchronize()
    if ln_ops.layer_norm.launches != before + 1:
        raise RuntimeError("add_layer_norm did not launch its kernel")
    unfused = _add_then_layer_norm(*inputs[0])
    ref = ln_ops.add_layer_norm_plain(*inputs[0])
    err = (out.float() - ref.float()).abs()
    ulp = bf16_ulp(ref.float().abs().clamp(min=2.0**-6), dtype)
    x32 = make(rows, torch.float32)
    err32 = (ln_ops.add_layer_norm(*x32) - ln_ops.add_layer_norm_plain(*x32)).abs().max()
    inv = rows_invariant(lambda x, r, w, b: ln_ops.add_layer_norm(x, r, w, b, 1e-5), make(64 * rows_per)[:4],
                         [n * rows_per for n in counts], (0, 0, None, None))
    res = {"max_abs_err": err.max().item(), "ulps": (err / ulp).max().item(), "dtype": str(dtype),
           "tol": f"1 {str(dtype)[6:]} ulp of max(|plain output|, 2^-6); fp32: 1e-5; bit-equal to x + r then the "
                  f"one-input kernel",
           "fp32_max_abs_err": err32.item(), "bit_equal_to_unfused": bool(torch.equal(out, unfused)),
           "fp32_bit_equal_to_unfused": bool(torch.equal(ln_ops.add_layer_norm(*x32), _add_then_layer_norm(*x32))),
           "rows_bit_equal": {n // rows_per: v for n, v in inv.items()}, "rows_per_count": rows_per}
    if not (bool((err <= ulp).all()) and res["fp32_max_abs_err"] <= 1e-5 and res["bit_equal_to_unfused"]
            and res["fp32_bit_equal_to_unfused"] and all(inv.values())):
        raise RuntimeError(f"add_layer_norm kernel at {shape}: {res}")
    res.update(time_repair(ln_ops.add_layer_norm, ln_ops.add_layer_norm_plain, _add_ln_library, inputs,
                           [(9.0 * rows * d, PEAK_FP32)], rows * d * out.element_size() * 3 + 2 * d * 4))
    res["unfused_ms"] = median_ms(_add_then_layer_norm, inputs)
    res["unfused_device_ms"] = device_ms(_add_then_layer_norm, inputs)
    emit({"phase": "kernel", "name": "add_layer_norm", "shape": shape, "rows": rows, "d": d, **res})
    return res


def phase_linear(gen, m: int, n: int, k: int, shape: str, counts=(1, 2, 4, 8, 16, 32, 64), rows_per=1,
                 dtype=torch.bfloat16) -> dict:
    """The product kernel at (m, k) x (n, k)^T + b, bf16, against the fp32
    product rounded as the plain version rounds it (the product to bf16,
    then the bias): within 1 bf16 ulp of the product plus 1 of the sum (the
    two sum in other orders; a rounding may flip); its rows bit-equal at
    each of `counts` leading row blocks of `rows_per` rows; fp32 within
    1e-5 relative; timed against cuBLAS. `dtype` fp16: fp16 ulps."""
    def make(rows, dt=dtype):
        x = torch.randn(rows, k, generator=gen, device="cuda").to(dt)
        w = (torch.randn(n, k, generator=gen, device="cuda") / math.sqrt(k)).to(dt)
        b = (0.1 * torch.randn(n, generator=gen, device="cuda")).to(dt)
        return x, w, b

    inputs = [make(m) for _ in range(REPS)]
    x, w, b = inputs[0]
    out = launched_once(linear_ops.linear, x, w, b)
    prod = (x.float() @ w.float().T).to(dtype)
    ref = (prod + b).float()
    err = (out.float() - ref).abs()
    ok = err <= bf16_ulp(prod, dtype) + bf16_ulp(ref, dtype)
    x32, w32, b32 = make(min(m, 512), torch.float32)
    ref32 = torch.addmm(b32.double(), x32.double(), w32.double().T)
    err32 = ((launched_once(linear_ops.linear, x32, w32, b32) - ref32).abs()
             / ref32.abs().clamp(min=1.0)).max().item()
    big = make(64 * rows_per)
    inv = rows_invariant(lambda x, w, b: linear_ops.linear(x, w, b), big, [r * rows_per for r in counts],
                         (0, None, None))
    res = {"max_abs_err": err.max().item(), "dtype": str(dtype),
           "tol": f"1 {str(dtype)[6:]} ulp of the product + 1 of the output; fp32 1e-5 rel",
           "fp32_max_rel_err": err32, "rows_bit_equal": {r // rows_per: v for r, v in inv.items()},
           "rows_per_count": rows_per}
    if not (bool(ok.all()) and err32 <= 1e-5 and all(inv.values())):
        raise RuntimeError(f"linear kernel at {shape}: {res}")
    res.update(time_repair(linear_ops.linear, linear_ops.linear_plain, torch.nn.functional.linear, inputs,
                           [product_cost(2.0 * m * n * k, dtype)], (m * k + n * k + n + m * n) * out.element_size()))
    emit({"phase": "kernel", "name": "linear", "shape": shape, "m": m, "n": n, "k": k, **res})
    return res


# The attention-rows kernel against its plain version (bf16): both round the
# probabilities to bf16, and their fp32 sums in other orders can flip one such
# rounding, which moves an output by a bf16 ulp of that probability times v;
# the output's own rounding may then flip. So each output lies within
# ATTENTION_ROWS_FLIPS ulps of its row's largest probability times its
# column's largest |v|, plus 1 bf16 ulp of the output. A flip is rare and moves
# an output by about 2^-8 / keys of its size, so few outputs differ at all
# (0.23% in a float32 replay of the kernel's order at the decode step's 512
# keys); a kernel that skips the probabilities' rounding moves about 40%, one
# that rounds its scores to bf16 about 60%.
ATTENTION_ROWS_FLIPS = 2
ATTENTION_ROWS_MAX_SHARE = 0.02


def attention_rows_error(out, q, k, v, mask) -> dict:
    """The attention-rows kernel's output `out` against its plain version:
    the largest error over its bound, the share of outputs that differ, and
    whether both hold (see ATTENTION_ROWS_FLIPS; fp32: within 1e-5)."""
    ref = attention_rows.attention_plain(q, k, v, mask).float()
    err = (out.float() - ref).abs()
    if q.dtype == torch.float32:
        return {"max_abs_err": err.max().item(), "tol": 1e-5, "ok": err.max().item() <= 1e-5}
    p_max = attention_rows.attention_probs(q, k, mask).float().amax(-1, keepdim=True)
    v_max = v.float().abs().amax(2, keepdim=True)
    bound = bf16_ulp(ref, q.dtype) + ATTENTION_ROWS_FLIPS * bf16_ulp(p_max, q.dtype) * v_max
    res = {"max_abs_err": err.max().item(), "max_err_over_bound": (err / bound).max().item(),
           "share_differing": (err > 0).double().mean().item(),
           "tol": f"per output: 1 {str(q.dtype)[6:]} ulp of it + {ATTENTION_ROWS_FLIPS} of its row's largest "
                  f"probability x its "
                  f"column's largest |v|; at most {ATTENTION_ROWS_MAX_SHARE:.0%} of outputs differ"}
    res["ok"] = res["max_err_over_bound"] <= 1.0 and res["share_differing"] <= ATTENTION_ROWS_MAX_SHARE
    return res


def step_mask(tk: int, step: int) -> torch.Tensor:
    """The decode step's self-attention mask at `step`: -1e4 past it."""
    return torch.where(torch.arange(tk, device="cuda") > step, -1e4, 0.0)[None, None, None]


VALID_KEYS_STEPS = (0, 1, 62, 63, 64, 127, 128, 245, 256, 447, 510, 511)  # decode steps of the bit-equality check


def phase_attention_rows(gen, batch: int, tq: int, tk: int, step: int | None, shape: str,
                         counts=(1, 2, 4, 8, 16, 32, 64), dtype=torch.bfloat16, heads: int = 6,
                         hd: int = 128) -> dict:
    """The attention-rows kernel (its mma or split-key design, by
    `attention_rows.kernel_for`) at (batch, 6, tq, 128) queries over tk keys
    (`step`: the decode step's mask, -1e4 past it; None: no mask), bf16,
    against its plain version (`attention_rows_error`), its rows bit-equal
    at each of `counts` leading rows of the largest, and timed against SDPA.
    With a step, also the read the decode step makes (`valid_keys` = step +
    1, no mask): bit-equal to the masked read of all keys at each of
    VALID_KEYS_STEPS below tk, its rows bit-equal as above, and timed
    against SDPA over the valid keys (`valid_keys` in the result). `dtype`,
    `heads` and `hd`: fp16, and the 2 heads of 384 at d 768 (the split-key
    design past head dim 256, as fp32 at every head dim)."""
    def make(b):
        q = torch.randn(b, heads, tq, hd, generator=gen, device="cuda").to(dtype)
        kk = torch.randn(b, heads, tk, hd, generator=gen, device="cuda").to(dtype)
        v = torch.randn(b, heads, tk, hd, generator=gen, device="cuda").to(dtype)
        return q, kk, v, None if step is None else step_mask(tk, step)

    inputs = [make(batch) for _ in range(REPS)]
    route = attention_rows.kernel_for(dtype, hd, tk)
    out = launched_once(attention_rows.attention if route == "mma" else attention_rows.attention_split, *inputs[0])
    check = attention_rows_error(out, *inputs[0])
    big = make(max(counts))
    inv = rows_invariant(attention_rows.attention, big, counts, (0, 0, 0, None))
    res = {**{k: v for k, v in check.items() if k != "ok"}, "rows_bit_equal": inv}
    if not (torch.isfinite(out.float()).all() and check["ok"] and all(inv.values())):
        raise RuntimeError(f"attention_rows kernel at {shape}: {res}")

    def sdpa(q, kk, v, mask):
        return torch.nn.functional.scaled_dot_product_attention(q, kk, v, attn_mask=None if mask is None
                                                                else mask.to(q.dtype))

    bh, es = batch * heads, out.element_size()
    res.update(time_repair(attention_rows.attention, attention_rows.attention_plain, sdpa, inputs,
                           [(4.0 * bh * tq * tk * hd, PEAK_FP32)], es * bh * (2 * tq + 2 * tk) * hd + tk * 4))
    res["route"] = route
    if step is not None:
        res["valid_keys"] = attention_rows_valid_keys(inputs, big, counts, step, shape)
    emit({"phase": "kernel", "name": "attention_rows" if route == "mma" else "attention_rows_split", "shape": shape,
          "batch": batch, "tq": tq, "tk": tk, "heads": heads, "head_dim": hd, "dtype": str(dtype), **res})
    return res


def attention_rows_valid_keys(inputs: list, big: tuple, counts, step: int, shape: str) -> dict:
    """The decode step's read (`valid_keys`, no mask) on the staged masked
    inputs: bit-equal to the masked read of all keys at each step of
    VALID_KEYS_STEPS, rows bit-equal at `counts`, and its times (the bound
    counts the valid keys' bytes; the library call is SDPA over them)."""
    q, kk, v, _ = inputs[0]
    tk, n = kk.shape[2], step + 1
    equal = {s: bool(torch.equal(attention_rows.attention(q, kk, v, valid_keys=s + 1),
                                 attention_rows.attention(q, kk, v, step_mask(tk, s))))
             for s in VALID_KEYS_STEPS if s < tk}

    def valid(q, kk, v, _mask):
        return attention_rows.attention(q, kk, v, valid_keys=n)

    def plain(q, kk, v, _mask):
        return attention_rows.attention_plain(q, kk, v, None, n)

    def sdpa(q, kk, v, _mask):
        return torch.nn.functional.scaled_dot_product_attention(q, kk[:, :, :n], v[:, :, :n])

    inv = rows_invariant(valid, big, counts, (0, 0, 0, None))
    res = {"keys": n, "equal_to_the_masked_read_at_step": equal, "rows_bit_equal": inv}
    if not (all(equal.values()) and all(inv.values())):
        raise RuntimeError(f"attention_rows kernel with valid_keys at {shape}: {res}")
    bh, tq, hd = q.shape[0] * q.shape[1], q.shape[2], q.shape[3]
    res.update(time_repair(valid, plain, sdpa, inputs, [(4.0 * bh * tq * n * hd, PEAK_FP32)],
                           q.element_size() * bh * (2 * tq + 2 * n) * hd))
    res["route"] = attention_rows.kernel_for(q.dtype, hd, n)
    return res


def phase_repairs(gen, cfg: FrameworkConfig) -> dict:
    """The batch-invariance kernels at the serving bucket's decode step and
    encoder, and at the beam's rows."""
    bucket, L, S = main_path_bucket(cfg), cfg.inference.max_length, 246
    K = BEAM_SIZE
    return {
        "layer_norm": {"decode": phase_layer_norm(gen, bucket, f"decode step, bucket {bucket}"),
                       "encoder": phase_layer_norm(gen, bucket * S, f"encoder, bucket {bucket} x {S} frames",
                                                   counts=(1, 2, 16), rows_per=S)},
        # the residual LayerNorms of the decode step and the layers: the add fused in
        "add_layer_norm": {"decode": phase_add_layer_norm(gen, bucket, f"decode step, bucket {bucket}"),
                           "encoder": phase_add_layer_norm(gen, bucket * S, f"encoder, bucket {bucket} x {S} frames",
                                                           counts=(1, 2, 16), rows_per=S)},
        "linear": {"decode": phase_linear(gen, bucket, 3072, 768, f"decode FFN linear1, bucket {bucket}"),
                   "decode_generator": phase_linear(gen, bucket, cfg.model.tgt_vocab_size, 768,
                                                    f"decode generator, bucket {bucket}"),
                   "decode_in_projection": phase_linear(gen, bucket, 2304, 768,
                                                        f"decode self in-projection, bucket {bucket}"),
                   # the self out-, cross q- and cross out-projections
                   "decode_projection": phase_linear(gen, bucket, 768, 768, f"decode 768 -> 768 projection, "
                                                     f"bucket {bucket}"),
                   "decode_ffn2": phase_linear(gen, bucket, 768, 3072, f"decode FFN linear2, bucket {bucket}"),
                   "beam": phase_linear(gen, bucket * K, 2304, 768, f"beam in-projection, {bucket} items x {K}",
                                        counts=(1, 2, 8, 16), rows_per=K),
                   # not on the path: the encoder keeps cuBLAS, which the probe finds row-independent there
                   "encoder": phase_linear(gen, bucket * S, 3072, 768,
                                           f"encoder FFN linear1 shape, bucket {bucket} (the encoder runs cuBLAS)",
                                           counts=(1, 2, 16), rows_per=S)},
        "attention_rows": {
            "decode_self": phase_attention_rows(gen, bucket, 1, L, L // 2, f"decode self, bucket {bucket}"),
            "decode_cross": phase_attention_rows(gen, bucket, 1, S, None, f"decode cross, bucket {bucket}"),
            "beam_cross": phase_attention_rows(gen, bucket, K, S, None, f"beam cross, {bucket} items x {K}",
                                               counts=(1, 2, 8, 16)),
            "beam_self": phase_attention_rows(gen, bucket * K, 1, L, L // 2,
                                              f"beam self (gathered rows), {bucket} items x {K}",
                                              counts=(1, 2, 8, 16, 32, 64))},
    }


def _attention_mask(batch: int, tq: int, tk: int, causal: bool, gen):
    """None, or the decoder's causal + key-padding mask as (B, Tq, Tk) at
    random token lengths (Tq == Tk)."""
    if not causal:
        return None
    lengths = torch.randint(tk // 4, tk + 1, (batch,), generator=gen, device="cuda")
    return (T.causal_mask_additive(tq, device="cuda") + T.padding_mask_additive(lengths, tk))[:, 0].contiguous()


def _qkv(batch: int, tq: int, tk: int, gen, heads: int = 6, head_dim: int = 128, dtype=torch.bfloat16):
    return tuple(torch.randn(batch, heads, t, head_dim, generator=gen, device="cuda").to(dtype)
                 for t in (tq, tk, tk))


def attention_wrappers(dtype, head_dim: int) -> tuple:
    """The forward and backward wrappers whose kernels take (dtype, head dim)."""
    route = cuda_attention.kernel_for(dtype, head_dim)
    if route == "tf32x3":
        return cuda_attention.fused_attention_tf32, cuda_attention.fused_attention_bwd_tf32
    if route == "wide":
        return cuda_attention.fused_attention_wide, cuda_attention.fused_attention_bwd_wide
    if route == "hopper256":
        return cuda_attention.fused_attention_d256, cuda_attention.fused_attention_bwd_d256
    return cuda_attention.fused_attention, cuda_attention.fused_attention_bwd


def attention_tols(dtype, head_dim: int) -> tuple[float, float]:
    """(out's abs tolerance, the gradients' tolerance relative to each one's
    largest element). bf16 on the tensor cores: p rounds to bf16 on both
    sides and a rare ulp flip moves out by ~1 bf16 ulp (1.6e-2); the
    backward's bf16 p and ds (2^-9) and bf16 outputs (2^-8): 2^-6. The
    3xTF32 kernels (fp32 only): products to about 2^-21 and other summation
    orders, 1e-5 and 1e-5.
    fp16 is held to bf16's tolerances (no looser); the head-dim-256 and
    wide tensor-core kernels, which keep the same rounding points, to the
    head-dim-128 ones'."""
    if cuda_attention.kernel_for(dtype, head_dim) != "tf32x3":
        return 1.6e-2, 2.0**-6
    return 1e-5, 1e-5


def _sdpa(q, k, v, mask, n_virtual):
    """One library call for the same function (the virtual keys add 0 here)."""
    am = None if mask is None else mask[:, None].to(q.dtype)
    return torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=am)


def phase_attention(batch: int, tq: int, tk: int, causal: bool, gen, shape: str, heads: int = 6,
                    head_dim: int = 128, dtype=torch.bfloat16) -> dict:
    """K5f at one shape (6 heads; a tensor-parallel rank's 3; 3 of 256) and
    dtype, through the kernel that takes it; the keys the JAX caller pads on
    are counted as the model counts them."""
    n_virtual = cuda_attention.virtual_keys(tq, tk)
    inputs = [(*_qkv(batch, tq, tk, gen, heads, head_dim, dtype), _attention_mask(batch, tq, tk, causal, gen),
               n_virtual) for _ in range(REPS)]
    wrapper = attention_wrappers(dtype, head_dim)[0]
    before = wrapper.launches
    out, lse = cuda_attention.fused_attention(*inputs[0])
    ref, ref_lse = cuda_attention.attention_plain(*inputs[0])
    torch.cuda.synchronize()
    if wrapper.launches != before + 1:
        raise RuntimeError(f"{wrapper.__name__} did not launch its kernel")
    err = (out.float() - ref.float()).abs()
    tol = attention_tols(dtype, head_dim)[0]
    res = {"max_abs_err": err.max().item(), "mean_abs_err": err.mean().item(), "tol": tol,
           "lse_max_abs_err": (lse - ref_lse).abs().max().item()}
    if not (torch.isfinite(out.float()).all() and res["max_abs_err"] <= tol and res["lse_max_abs_err"] <= 1e-4):
        raise RuntimeError(f"attention kernel disagrees with its plain version at {shape}: {res}")
    res["ms"] = median_ms(cuda_attention.fused_attention, inputs)
    res["device_ms"] = device_ms(cuda_attention.fused_attention, inputs)
    res["plain_ms"] = median_ms(cuda_attention.attention_plain, inputs)
    res["library_ms"] = median_ms(_sdpa, inputs)
    if dtype == torch.float32:  # which kernel SDPA takes for fp32, by name
        res["library_device_ms"] = device_ms(_sdpa, inputs)
    bh, esize = batch * heads, out.element_size()
    products = product_cost(4.0 * bh * tq * tk * head_dim, dtype)
    res["bound_ms"], res["bound_by"] = bound(
        # products; scale, mask, max, exp, sum
        [products, (5.0 * bh * tq * tk, PEAK_FP32)],
        2 * bh * (tq + tk) * head_dim * esize + (0 if not causal else batch * tq * tk * 4) + bh * tq * 4,
    )
    res.update(kernel=wrapper.__name__, shape=shape, batch=batch, heads=heads, head_dim=head_dim, dtype=str(dtype),
               tq=tq, tk=tk)
    emit({"phase": "kernel", "name": wrapper.__name__, "mask": causal, "n_virtual": n_virtual, **res})
    return res


def _sdpa_grads(out, q, k, v, do):
    return torch.autograd.grad(out, (q, k, v), do, retain_graph=True)


def phase_attention_bwd(batch: int, tq: int, tk: int, causal: bool, gen, shape: str, heads: int = 6,
                        head_dim: int = 128, dtype=torch.bfloat16) -> dict:
    """K5b at one shape and dtype, on the forward kernel's out and lse: held
    to its plain version, and bit-equal across two calls (every backward
    kernel is deterministic)."""
    n_virtual = cuda_attention.virtual_keys(tq, tk)
    inputs = []
    for _ in range(REPS):
        q, k, v = _qkv(batch, tq, tk, gen, heads, head_dim, dtype)
        mask = _attention_mask(batch, tq, tk, causal, gen)
        out, lse = cuda_attention.fused_attention(q, k, v, mask, n_virtual)
        do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
        inputs.append((q, k, v, mask, out, lse, do))
    wrapper = attention_wrappers(dtype, head_dim)[1]
    before = wrapper.launches
    got = cuda_attention.fused_attention_bwd(*inputs[0])
    again = cuda_attention.fused_attention_bwd(*inputs[0])
    refs = cuda_attention.attention_bwd_plain(*inputs[0])
    torch.cuda.synchronize()
    if wrapper.launches != before + 2:
        raise RuntimeError(f"{wrapper.__name__} did not launch its kernels")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise RuntimeError(f"{wrapper.__name__} gave other bits on a second call at {shape}")
    del again
    tol_rel = attention_tols(dtype, head_dim)[1]
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
    if dtype == torch.float32:
        res["library_device_ms"] = device_ms(_sdpa_grads, lib_inputs)
    del lib_inputs
    bh, esize = batch * heads, got[0].element_size()
    res["bound_ms"], res["bound_by"] = bound(
        [product_cost(10.0 * bh * tq * tk * head_dim, dtype), (8.0 * bh * tq * tk, PEAK_FP32)],  # 5 products; p and ds
        4 * bh * (tq + tk) * head_dim * esize + (0 if not causal else batch * tq * tk * 4) + bh * tq * 4,
    )
    res.update(kernel=wrapper.__name__, shape=shape, batch=batch, heads=heads, head_dim=head_dim, dtype=str(dtype),
               tq=tq, tk=tk)
    emit({"phase": "kernel", "name": wrapper.__name__, "mask": causal, "n_virtual": n_virtual, **res})
    return res


def _ffn_library(x, w1, b1, w2, b2, *_):
    """Two cuBLAS GEMMs with F.gelu between, masks excluded: K4's library
    yardstick (b2 None: the partial mode's, without the bias)."""
    return torch.nn.functional.linear(torch.nn.functional.gelu(torch.nn.functional.linear(x, w1, b1)), w2, b2)


def phase_ffn(rows: int, gen, shape: str, d: int = 768, d_ff: int = 3072, keep: float = 0.9,
              col0: int | None = None, d_ff_total: int | None = None, dtype=torch.bfloat16) -> dict:
    """K4 at one shape (the training config's dropout 0.1) and dtype,
    through the kernel that takes it. With `col0`: a tensor-parallel rank's
    d_ff columns from col0 of `d_ff_total`, in the partial mode (fp32 out
    without b2 and the output dropout)."""
    partial = col0 is not None
    cpu = torch.Generator().manual_seed(SEED + rows + (0 if col0 is None else col0 + 1))
    fp32 = cuda_ffn.kernel_for(dtype, d, d_ff) == "tf32x3"
    wrapper = cuda_ffn.ffn_dropout_tf32 if fp32 else cuda_ffn.ffn_dropout

    def args():
        x = torch.randn(rows, d, generator=gen, device="cuda").to(dtype)
        w1 = (torch.randn(d_ff, d, generator=gen, device="cuda") / math.sqrt(d)).to(dtype)
        w2 = (torch.randn(d, d_ff, generator=gen, device="cuda") / math.sqrt(d_ff)).to(dtype)
        b1 = (torch.randn(d_ff, generator=gen, device="cuda") * 0.1).to(dtype)
        b2 = (torch.randn(d, generator=gen, device="cuda") * 0.1).to(dtype)
        words = torch.randint(0, 2**32, (2, 2), generator=cpu).tolist()
        seeds = seed_from_key(words[0]) + seed_from_key(words[1])
        if partial:
            return x, w1, b1, w2, None, seeds, keep, keep, col0, d_ff_total
        return x, w1, b1, w2, b2, seeds, keep, keep

    inputs = [args() for _ in range(REPS)]
    before = wrapper.launches
    out, pre = cuda_ffn.ffn_dropout(*inputs[0])
    ref, ref_pre = ffn.ffn_dropout_plain(*inputs[0])
    torch.cuda.synchronize()
    if wrapper.launches != before + 1:
        raise RuntimeError(f"{wrapper.__name__} did not launch its kernel")
    # the same bf16 operands with fp32 accumulation in another order: pre and
    # out may each flip one bf16 rounding (<= 2^-7 of the value); pre also
    # carries the fp32 cancellation error near 0; the masks are the same hash.
    # fp32: FMA products against cuBLAS's fp32 products (TF32 off) in another
    # order, 1e-5 of the largest element
    err, pre_err = (out.float() - ref.float()).abs(), (pre.float() - ref_pre.float()).abs()
    tol = (1e-5 if fp32 else 2.0**-7) * ref.float().abs().max().item()
    # a kept output can cancel to exactly 0 in one summation order and not in the other (once in the 12.6 M
    # fp32 outputs at 64 x 246 rows), and fp16 flushes one below 2^-25 to 0: the zero patterns (the output
    # mask) are compared away from outputs within `tol` of 0 on both sides; the values are held everywhere
    near0 = (out.float().abs() <= tol) & (ref.float().abs() <= tol)
    if fp32:
        pre_ok = bool(pre_err.max() <= 1e-5 * ref_pre.abs().max())
    else:
        pre_ok = bool((pre_err <= 2.0**-7 * ref_pre.float().abs() + 1e-4 * ref_pre.float().abs().max()).all())
    res = {"max_abs_err": err.max().item(), "mean_abs_err": err.mean().item(), "tol": tol,
           "pre_max_abs_err": pre_err.max().item(), "pre_within_1ulp": pre_ok,
           "zero_pattern_equal": bool(torch.equal((out == 0) & ~near0, (ref == 0) & ~near0)),
           "dropped_share": (out == 0).float().mean().item()}
    if partial:  # fp32 out, no output mask: the hidden mask shows in out's agreement (another col0 moves it)
        res.update(zero_pattern_equal=None, dropped_share=None, col0=col0, d_ff_total=d_ff_total,
                   out_dtype=str(out.dtype))
    if not (torch.isfinite(out.float()).all() and res["max_abs_err"] <= tol and pre_ok
            and (partial or res["zero_pattern_equal"]) and (not partial or out.dtype == torch.float32)):
        raise RuntimeError(f"FFN kernel disagrees with its plain version at {shape}: {res}")
    res["ms"] = median_ms(cuda_ffn.ffn_dropout, inputs)
    res["device_ms"] = device_ms(cuda_ffn.ffn_dropout, inputs)  # GEMM 1 and GEMM 2
    res["plain_ms"] = median_ms(ffn.ffn_dropout_plain, inputs)
    res["library_ms"] = median_ms(_ffn_library, inputs)
    res["library"] = f"two cuBLAS GEMMs + F.gelu, masks excluded{', TF32 off' if fp32 else ''}"
    es = 4 if fp32 else 2
    res["bound_ms"], res["bound_by"] = bound(
        # the two products; ~30 fp32-rate operations per hidden element (A-S
        # gelu, the hash, scaling) and ~12 per output element
        [product_cost(4.0 * rows * d * d_ff, torch.float32 if fp32 else torch.bfloat16),
         (30.0 * rows * d_ff + 12.0 * rows * d, PEAK_FP32)],
        # x in, out (fp32 in the partial mode), both weights, the biases, pre out
        rows * d * es + rows * d * (4 if partial else es) + 2 * d * d_ff * es + es * (d_ff + (0 if partial else d))
        + rows * d_ff * es,
    )
    res.update(kernel=wrapper.__name__, shape=shape, rows=rows, d=d, d_ff=d_ff, dtype=str(dtype))
    emit({"phase": "kernel", "name": wrapper.__name__, **res})
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


def phase_place_notes(statics: render.SynthStatics, cfg, gen, ptxas: list) -> dict:
    """K3 at the training shape: B = 64 segments of up to 128 notes over
    27 blend rows of 30720 bf16, chunk 61440; the inputs are those the
    render gives it (`blend_notes` on random note lists and draws). Besides
    the byte bound, the L2-read floor: every sounding note's window of its
    row read once from L2 (`mean_multiply_adds` x 2 B) at the L2 rate of a
    `copy_` measured here."""
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
    res["device_ms"] = device_ms(cuda_place.place_notes, inputs)
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
    layout = cuda_place.place_notes_layout()
    res["l2_rate_bytes_per_s"] = copy_rate(8 << 20)  # 2 x 8 MiB: both sides stay in L2
    res["hbm_rate_bytes_per_s"] = copy_rate(1 << 30)  # 2 x 1 GiB: device memory
    res["l2_floor_ms"] = macs * blend.element_size() / res["l2_rate_bytes_per_s"] * 1e3
    res["grid"] = [math.ceil(chunk / layout["tile"]), B]
    emit({"phase": "kernel", "name": "place_notes", "batch": B, "notes": slot.shape[1], "L": L, "chunk": chunk,
          "stream": str(blend.dtype), "mean_multiply_adds": macs, "mean_row_samples_read": row_samples,
          "layout": layout, "ptxas": ptxas, **res})
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


def decode_breakdown(model: ADTModel, cfg: FrameworkConfig, batch: int, decode=greedy_decode_from_memory) -> dict:
    """Where one served batch's time goes: encode against the decode loop
    (`decode(model, memory, max_len, bos, eos)`, greedy unless given; CUDA
    events), then the device's busy share of a 64-step decode under
    torch.profiler (kernel time over host wall time; the profiler's own host
    cost makes the idle share an upper bound)."""
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
        tokens = decode(model, memory, max_len, cfg.tokenizer.BOS_token, eos)
        ev[2].record()
        torch.cuda.synchronize()
        steps = decode_steps(tokens, eos)
        out = {"bucket": bucket, "encode_ms": ev[0].elapsed_time(ev[1]), "decode_ms": ev[1].elapsed_time(ev[2]),
               "decode_steps": steps}
        out["ms_per_step"] = out["decode_ms"] / max(steps, 1)
        trace = _build.BUILD_DIR.parent / "decode_trace.json"
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.monotonic()
            decode(model, memory, 65, cfg.tokenizer.BOS_token, eos)
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
def swapped(swaps: list):
    """Set each (module, attribute, value) of `swaps` while the context is open."""
    saved = [getattr(mod, name) for mod, name, _ in swaps]
    try:
        for mod, name, value in swaps:
            setattr(mod, name, value)
        yield
    finally:
        for (mod, name, _), fn in zip(swaps, saved):
            setattr(mod, name, fn)


# the batch-invariance kernels' wrappers and their plain versions: the inference path's LayerNorm,
# products and attention (no TPU kernel is behind them)
REPAIRS = [(ln_ops, "layer_norm", ln_ops.layer_norm_plain), (linear_ops, "linear", linear_ops.linear_plain),
           (attention_rows, "attention", attention_rows.attention_plain),
           (ln_ops, "add_layer_norm", ln_ops.add_layer_norm_plain)]


def plain_kernels():
    """Route every kernel wrapper to its plain version, for the reference
    step: the model code calls the wrappers through their modules."""
    return swapped([(cuda_mel, "log_mel", cuda_mel.log_mel_plain),
                    (cuda_attention, "fused_attention", cuda_attention.attention_plain),
                    (cuda_attention, "fused_attention_bwd", cuda_attention.attention_bwd_plain),
                    (cuda_ffn, "ffn_dropout", ffn.ffn_dropout_plain),
                    (cuda_place, "gather_blend", gather_blend_plain), (cuda_place, "place_notes", place_notes_plain),
                    *REPAIRS])


def before_repair():
    """The inference path as it was before the batch-invariance repair, as
    far as this tree holds it: the plain LayerNorm, products and attention
    on the card. K1's band sums now run in tile order at every split, so
    its old dependence on the batch cannot be replayed (`log_mel_splits`
    times its splits instead)."""
    return swapped(REPAIRS)


def kernel_counters() -> dict:
    """The TPU kernels' wrappers, one a kernel variant: K1 by its route, K5 on
    the tensor cores at head dim 128, 256 or past 256 (wide) or on the CUDA
    cores in 3xTF32 (fp32), K4 in 16-bit (bf16, fp16) or fp32."""
    return {"log_mel": cuda_mel.log_mel, "log_mel_any_hop": cuda_mel.log_mel_any_hop,
            "log_mel_long_hop": cuda_mel.log_mel_long_hop, "fused_attention": cuda_attention.fused_attention,
            "fused_attention_bwd": cuda_attention.fused_attention_bwd,
            "fused_attention_d256": cuda_attention.fused_attention_d256,
            "fused_attention_bwd_d256": cuda_attention.fused_attention_bwd_d256,
            "fused_attention_tf32": cuda_attention.fused_attention_tf32,
            "fused_attention_bwd_tf32": cuda_attention.fused_attention_bwd_tf32,
            "fused_attention_wide": cuda_attention.fused_attention_wide,
            "fused_attention_bwd_wide": cuda_attention.fused_attention_bwd_wide, "ffn_dropout": cuda_ffn.ffn_dropout,
            "ffn_dropout_tf32": cuda_ffn.ffn_dropout_tf32,
            "gather_blend": cuda_place.gather_blend, "place_notes": cuda_place.place_notes}


# The device kernels of retired designs: the CUDA-core fp32 K5 (csrc/attention_simt.cu, replaced by
# csrc/attention_tf32.cu), the fp32 FMA K4 (csrc/ffn_dropout_fp32.cu, replaced by csrc/ffn_dropout_tf32.cu) and
# attention_rows' CUDA-core kernels (a block a query row, replaced by its split-key design)
RETIRED = ("attention_fwd_simt", "attention_delta_simt", "attention_dkdv_simt", "attention_dq_simt",
           "attention_fwd_chunked", "attention_delta_chunked", "attention_dkdv_chunked", "attention_dq_chunked",
           "ffn_gemm_fp32", "attention_rows_f32")


# The batch-invariance kernels' wrappers (`REPAIRS`, as imported), counted apart from the TPU kernels:
# they launch on every inference path, a number of times that follows the decode's length.
REPAIR_WRAPPERS = {"layer_norm": ln_ops.layer_norm, "linear": linear_ops.linear,
                   "attention_rows": attention_rows.attention}


def all_counters() -> dict:
    """Every kernel wrapper, by kernel: the TPU kernels' and the
    batch-invariance kernels' (attention_rows by its design: the mma ring,
    `attention_rows`, or the split-key kernels, `attention_rows_split`)."""
    return {**kernel_counters(), **REPAIR_WRAPPERS, "attention_rows_split": attention_rows.attention_split}


def repair_kernels(cfg: FrameworkConfig | None = None) -> tuple:
    """The batch-invariance kernels a decode path at `cfg` (None: the
    shipped bf16 widths) launches: LayerNorm, the product, and attention_rows
    by the design its dtype and head dim take."""
    rows = "attention_rows"
    if cfg is not None and attention_rows.kernel_for(torch_dtype(cfg.model.compute_dtype),
                                                     cfg.model.d_model // cfg.model.nhead,
                                                     cfg.inference.max_length) == "split":
        rows = "attention_rows_split"
    return ("layer_norm", "linear", rows)


def tpu_launches(launches: dict) -> dict:
    """The TPU kernels' part of a run's launches (the batch-invariance kernels' follow the decode's length)."""
    return {k: launches[k] for k in kernel_counters()}


def train_batch(cfg: FrameworkConfig, seed: int, tokens: int = TRAIN_TOKENS, batch: int = TRAIN_BATCH) -> dict:
    """`batch` random waves of the config's chunk (2.56 s as shipped) and
    `token_batch`'s tokens."""
    g = torch.Generator().manual_seed(seed)
    wave = torch.randn(batch, cfg.shared.chunk_samples, generator=g) * 0.3
    return {"wavs": wave.cuda(), **token_batch(cfg, g, tokens, batch)}


def token_batch(cfg: FrameworkConfig, g: torch.Generator, tokens: int = TRAIN_TOKENS, batch: int = TRAIN_BATCH) -> dict:
    """`batch` random rows of `tokens`: BOS, random tokens, EOS at a random
    length (one row full), PAD; collated lengths."""
    tok = cfg.tokenizer
    eos_at = torch.randint(tokens // 4, tokens, (batch,), generator=g)
    eos_at[0] = tokens - 1
    pos = torch.arange(tokens)[None]
    body = torch.randint(4, cfg.model.tgt_vocab_size, (batch, tokens), generator=g)
    rows = torch.where(pos < eos_at[:, None], body, tok.pad_token)
    rows = torch.where(pos == eos_at[:, None], tok.EOS_token, rows)
    rows[:, 0] = tok.BOS_token
    return {"tokens": rows.cuda(), "token_lengths": collate_token_lengths(eos_at + 1).cuda()}


def _group(name: str) -> str:
    """The part of a training step a device kernel belongs to. The port's
    own kernels come first: K4's `ffn_dropout_kernel_gemm1/2` are GEMMs
    that the library rule below would file under cuBLAS."""
    for key, group in (("attention_fwd_kernel", "K5f attention fwd"), ("attention_bwd", "K5b attention bwd"),
                       ("attention_delta", "K5b attention bwd"), ("ffn_dropout_kernel", "K4 fused FFN"),
                       ("attention_tf32_fwd", "K5f attention fwd"), ("attention_tf32_delta", "K5b attention bwd"),
                       ("attention_tf32_dkdv", "K5b attention bwd"), ("attention_tf32_dq", "K5b attention bwd"),
                       ("wide_fwd_kernel", "K5f attention fwd"), ("wide_bwd_kernel", "K5b attention bwd"),
                       ("wide_delta_kernel", "K5b attention bwd"), ("ffn_tf32_gemm", "K4 fused FFN"),
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


# the device-time group (`_group`) of each kernel wrapper's kernels
KERNEL_GROUPS = {"log_mel": "K1 log-mel", "log_mel_any_hop": "K1 log-mel", "log_mel_long_hop": "K1 log-mel",
                 "gather_blend": "K2 gather + blend", "place_notes": "K3 note placement",
                 "ffn_dropout": "K4 fused FFN", "ffn_dropout_tf32": "K4 fused FFN",
                 "fused_attention": "K5f attention fwd", "fused_attention_tf32": "K5f attention fwd",
                 "fused_attention_bwd": "K5b attention bwd", "fused_attention_bwd_tf32": "K5b attention bwd",
                 "fused_attention_d256": "K5f attention fwd", "fused_attention_bwd_d256": "K5b attention bwd",
                 "fused_attention_wide": "K5f attention fwd", "fused_attention_bwd_wide": "K5b attention bwd"}


def device_time_by_group(events: list, launched: dict) -> dict:
    """A chrome trace's events -> its device events' count, busy ms, ms by
    kernel group and ms by kernel name. Raises if a kernel wrapper that
    launched (`launched[name] > 0`, from its counter) has no device time in
    its group: the trace then misses part of the call it reports."""
    kernels = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    groups: dict = {}
    by_name: dict = {}
    for e in kernels:
        dur, name = float(e.get("dur", 0)) / 1e3, e.get("name", "")
        groups[_group(name)] = groups.get(_group(name), 0.0) + dur
        by_name[name[:90]] = by_name.get(name[:90], 0.0) + dur
    missing = sorted(k for k, n in launched.items() if n and not groups.get(KERNEL_GROUPS[k]))
    if missing:
        raise RuntimeError(f"the profile has no device time for {missing}, which the call launched: {launched}")
    return {"device_kernels": len(kernels), "device_busy_ms": sum(groups.values()),
            "by_group_ms": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
            "top_kernels_ms": sorted(by_name.items(), key=lambda kv: -kv[1])[:8]}


def _constant_lr(cfg: FrameworkConfig) -> TrainingConfig:
    """A constant lr with no warmup: every one of the few updates applies."""
    return TrainingConfig(learning_rate=TRAIN_LR, warmup_ratio=0.0, lr_scheduler_type="constant",
                          weight_decay=cfg.training.weight_decay, max_grad_norm=cfg.training.max_grad_norm)


def run_training(name: str, mc, per_step: dict, fresh, call, extra: dict, steps: int = TRAIN_STEPS,
                 tol: dict = PARITY_TOL, plain_steps: int = 1, lockstep: bool = False, ref32=None,
                 trajectory: bool = False) -> dict:
    """`steps` steps of `call(step, state, i) -> (state, metrics)` from
    `fresh() -> (step, state)`, each of the first `plain_steps` checked
    against the same step through the plain versions (from the same weights
    and randomness) within `tol`, and the kernels' expected launches. The plain steps run
    their own trajectory from the same initial weights, or with `lockstep`
    each from a copy of the kernel path's state before its step: in bf16
    or fp16 the two trajectories part after the first update (Adam's
    normalised step moves the weights of near-zero gradients by ±lr on
    rounding differences), so only lockstep compares each step itself.
    With `trajectory` (and lockstep), the plain path also runs its own
    trajectory from the same initial weights, and each step's distance
    from it is reported, not held: at fp32 the plain path with its
    products summed in another fp32 order, and fp32 SDPA, part from that
    trajectory past FP32_TOL by step 2-3 as well (`python3 chip_smoke.py
    --fp32-drift`).
    `ref32(state, i) -> metrics` (fp16, with lockstep): the same step in
    fp32 through the plain versions from a copy of the state. fp16 without
    loss scaling flushes most of a step's gradient elements (the loss's mean
    over 32k tokens puts the logits' gradient near 2^-24), so the plain fp16
    step's own grad norm is off the fp32 one's by 0.5-41% (H100 80GB HBM3,
    700 W), and two fp16 computations of it that differ only in rounding
    part by ~1%: the kernel path's fp16 grad norm is then held to the plain
    fp16 step's within the bf16 rule plus a tenth of the plain fp16 step's
    own distance from the fp32 step's (its loss to the bf16 rule)."""
    own = []
    if not lockstep or trajectory:
        step, state = fresh()
        with plain_kernels():
            for i in range(plain_steps):
                state, m = call(step, state, i)
                own.append({k: float(v) for k, v in m.items()})
        del step, state, m
        torch.cuda.empty_cache()
    plain = [] if lockstep else own

    step, state = fresh()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = reset_counters()  # a training step launches no batch-invariance kernel: expected 0
    losses, norms, step_ms = [], [], []
    for i in range(steps):
        if lockstep and i < plain_steps:
            with plain_kernels():
                _, ref = call(step, copy.deepcopy(state), i)
                plain.append({k: float(v) for k, v in ref.items()})
                if ref32 is not None:
                    plain[-1]["fp32"] = {k: float(v) for k, v in ref32(copy.deepcopy(state), i).items()}
            del ref
        t0 = time.monotonic()
        state, m = call(step, state, i)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        torch.cuda.synchronize()
        step_ms.append((time.monotonic() - t0) * 1e3)
    launches = {k: c.launches for k, c in counters.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    expected = {k: per_step.get(k, 0) * steps for k in counters}
    plain0 = plain[0]
    vs_plain = {"loss": losses[0], "plain_loss": plain0["loss"], "grad_norm": norms[0],
                "plain_grad_norm": plain0["grad_norm"], **tol, "lockstep": lockstep}

    def gaps(refs: list) -> list:
        return [{"loss_rel": abs(losses[i] - r["loss"]) / abs(r["loss"]),
                 "grad_norm_rel": abs(norms[i] - r["grad_norm"]) / r["grad_norm"]} for i, r in enumerate(refs)]

    each = gaps(plain)
    if ref32 is not None:
        for i, (e, r) in enumerate(zip(each, plain)):
            g32 = r["fp32"]["grad_norm"]
            e.update(fp32_loss=r["fp32"]["loss"], fp32_grad_norm=g32, grad_norm=norms[i],
                     plain_grad_norm=r["grad_norm"], kernel_vs_fp32_rel=abs(norms[i] - g32) / g32,
                     plain_vs_fp32_rel=abs(r["grad_norm"] - g32) / g32)
            # the hold: the bf16 rule plus a tenth of the plain fp16 step's own error against the fp32 step
            e["grad_norm_tol"] = tol["grad_norm_rtol"] + 0.1 * abs(r["grad_norm"] - g32) / r["grad_norm"]
            e["grad_norm_ok"] = e["grad_norm_rel"] <= e["grad_norm_tol"]
    res = {"phase": "training", "config": name, "batch": TRAIN_BATCH, "steps": steps,
           "lr": f"constant {TRAIN_LR}, no warmup (every update applies)", "compute_dtype": mc.compute_dtype,
           "dropout": mc.dropout, **extra, "losses": losses, "grad_norms": norms, "step_ms": step_ms,
           "median_step_ms": statistics.median(step_ms), "launches": launches, "expected_launches": expected,
           "vs_plain_first_step": vs_plain, "peak_mem_gib": peak_gib,
           "model_params": sum(p.numel() for p in state.model.parameters())}
    if plain_steps > 1:
        res["vs_plain_each_step"] = each
    if trajectory:
        res["vs_plain_own_trajectory"] = gaps(own)
    emit(res)
    if not all(math.isfinite(x) for x in losses + norms):
        raise RuntimeError(f"{name}: a loss or gradient norm is not finite")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"{name}: the loss did not fall over {steps} steps: {losses}")
    if launches != expected:
        raise RuntimeError(f"{name}: kernel launches {launches}, expected {expected}")
    if not all(e["loss_rel"] <= tol["loss_rtol"] and e.get("grad_norm_ok", e["grad_norm_rel"] <= tol["grad_norm_rtol"])
               for e in each):
        raise RuntimeError(f"{name}: the kernel path disagrees with the plain path: {vs_plain}, {each}")
    del step, state
    torch.cuda.empty_cache()
    return res


def training_inputs(name: str, steps: int, tokens: int = TRAIN_TOKENS, **sections) -> tuple:
    """One real-audio training configuration (`sections`: the config's
    overrides, as `load_config` takes them) -> (its config, a constant-lr
    TrainingConfig, a seeded batch of `tokens` tokens, seeded site keys for
    `steps` + 1 steps)."""
    cfg = load_config(TRAIN_YAMLS[name], train=True, **sections)
    gen = torch.Generator().manual_seed(SEED + 11)
    return (cfg, _constant_lr(cfg), train_batch(cfg, SEED + 10, tokens),
            [draw_site_keys(cfg.model, gen) for _ in range(steps + 1)])


def phase_training(name: str, label: str | None = None, steps: int = TRAIN_STEPS, tokens: int = TRAIN_TOKENS,
                   tol: dict = PARITY_TOL, plain_steps: int = 1, lockstep: bool = False, trajectory: bool = False,
                   **sections) -> dict:
    """`steps` steps of one real-audio training configuration through its
    kernels (`training_inputs`; `label` names the run), held as
    `run_training` holds them; at fp16 with `lockstep`, beside the same
    step in fp32 (`ref32`)."""
    cfg, tcfg, batch, keys = training_inputs(name, steps, tokens, **sections)
    mc = cfg.model

    def fresh():
        model = ADTModel(mc, seed=SEED, device="cuda")
        opt, _ = make_optimizer(tcfg, steps, model)
        return make_train_step(mc, opt, device="cuda"), init_train_state(model, opt)

    def ref32(state, i):  # the step in fp32 on a copy of the state: its model's config computes in fp32
        mc32 = dataclasses.replace(mc, compute_dtype="float32")
        opt, _ = make_optimizer(tcfg, steps, state.model)
        state.model.config = mc32
        return make_train_step(mc32, opt, device="cuda")(state, batch, keys[i])[1]

    return run_training(label or name, mc, per_step(mc, synth=False), fresh,
                        lambda step, state, i: step(state, batch, keys[i]),
                        {"tokens": tokens, "chunk_samples": cfg.shared.chunk_samples}, steps, tol, plain_steps,
                        lockstep, ref32 if lockstep and mc.compute_dtype == "float16" else None, trajectory)


def phase_synth_training(cfg: FrameworkConfig, statics: render.SynthStatics) -> dict:
    """TRAIN_STEPS synthesis-fused steps of setting-1: render (K2, K3, FX) ->
    K1 -> the 4+4-layer model with dropout 0.1 -> AdamW."""
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
                        lambda step, state, i: step(state, batch, draws[i], keys[i]), {"tokens": TRAIN_TOKENS, **extra})


def memory_error(mem: torch.Tensor, ref: torch.Tensor) -> dict:
    """Encoder memory against a reference memory of the same chunks: bf16
    activations round at other points in the kernels and the plain versions,
    and on the two devices, through 4 layers."""
    err = (mem.float() - ref.float()).abs()
    out = {"max_abs_err": err.max().item(), "mean_abs_err": err.mean().item(), "tol_max": 0.5, "tol_mean": 2e-2,
           "shape": list(mem.shape)}
    out["ok"] = bool(torch.isfinite(mem).all()) and out["max_abs_err"] <= 0.5 and out["mean_abs_err"] <= 2e-2
    return out


def encoder_vs_plain(model: ADTModel, chunks: torch.Tensor) -> dict:
    """K1 on the card's `chunks` against its plain version (phase_mel's
    tolerance), and the encoder memory through K1 and K5f against the same
    encoder through the plain versions, on the card."""
    params = mel_params(model.config)
    mel_err = (cuda_mel.log_mel(chunks, params) - cuda_mel.log_mel_plain(chunks, params)).abs().max().item()
    with torch.inference_mode():
        mem = model.encode(chunks)
        with plain_kernels():
            ref = model.encode(chunks)
    # the K1 route these chunks take (as `cuda_mel.log_mel` picks it)
    n_tiles = cuda_mel.mel_table(params).shape[0] // cuda_mel.FREQ_TILE
    split = cuda_mel.freq_split(chunks.shape[0] * -(-params.out_frames(chunks.shape[1]) // cuda_mel.TILE_FRAMES),
                                n_tiles, torch.cuda.get_device_properties(0).multi_processor_count)
    out = {"batch": chunks.shape[0], "log_mel_freq_split": split, "log_mel_max_abs_err": mel_err,
           "log_mel_tol": 1e-4, "memory": memory_error(mem, ref)}
    out["ok"] = mel_err <= 1e-4 and out["memory"]["ok"]
    return out


def request_waves(cfg: FrameworkConfig, seconds: float = REQUEST_SEC) -> list[np.ndarray]:
    """The N_REQUESTS seeded raw f32 PCM waves of `seconds` that the serving
    phases POST, at the config's sample rate."""
    rng = np.random.default_rng(SEED + 1)
    n = int(seconds * cfg.shared.sample_rate)
    return [(rng.normal(size=n) * 0.3).astype("<f4") for _ in range(N_REQUESTS)]


def serve_requests(engine, cfg: FrameworkConfig, sequential: bool = False, seconds: float = REQUEST_SEC,
                   required=("log_mel", "fused_attention")) -> tuple[list, float, dict, dict]:
    """N_REQUESTS concurrent POSTs (`sequential`: one after the other) of
    `request_waves` to the port's HTTP server around `engine` (closed
    afterwards); each must answer 200 with well-formed notes, and the
    `required` TPU kernels (K1 and K5f as shipped) and the batch-invariance
    kernels must launch. -> (results, wall s, launches, engine stats)."""
    server = make_server(engine, "127.0.0.1", 0)
    start_in_thread(server)
    host, port = server.server_address[:2]
    url = f"http://{host}:{port}/v1/transcribe"
    bodies = [w.tobytes() for w in request_waves(cfg, seconds)]
    results: list = [None] * N_REQUESTS
    counters = reset_counters()
    try:
        t0 = time.monotonic()
        threads = [threading.Thread(target=_post, args=(url, b, results, i)) for i, b in enumerate(bodies)]
        for t in threads:
            t.start()
            if sequential:
                t.join(timeout=900)
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
        check_notes(json.loads(r[1]), seconds, cfg.model.tgt_vocab_size)
    if not all(launches[k] for k in (*required, *repair_kernels(cfg))):
        raise RuntimeError(f"a kernel of the path was not launched while serving: {launches}")
    return results, wall, launches, stats


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
    mem = memory_error(mem_gpu, mem_cpu)
    if not mem["ok"]:
        raise RuntimeError(f"kernel-path encoder memory disagrees with the CPU path: {mem}")

    engine = build_engine(cfg, model)
    results, wall, launches, stats = serve_requests(engine, cfg)
    breakdown = decode_breakdown(model, cfg, batch=stats["n_requests"])
    res = {
        "phase": "serving", "requests": N_REQUESTS, "request_sec": REQUEST_SEC,
        "model_params": sum(p.numel() for p in model.parameters()), "model_build_s": round(build_s, 3),
        "wall_s": round(wall, 3), "request_s": [round(r[2], 3) for r in results],
        "n_notes": [json.loads(r[1])["n_notes"] for r in results],
        "launches": launches, "engine_stats": stats, "memory_vs_cpu": mem, "breakdown": breakdown,
    }
    emit(res)
    res["bodies"] = [json.loads(r[1]) for r in results]  # for decode_dp
    return res


class InMemoryEvalDataset:
    """Items of (1-D wave, reference notes) with `EvalDataset.batches`' interface."""

    def __init__(self, wavs: list, notes: list):
        self.wavs, self.notes = wavs, notes

    def __len__(self) -> int:
        return len(self.wavs)

    def batches(self, batch_size: int):
        for b in range(0, len(self), batch_size):
            yield {"wavs": self.wavs[b : b + batch_size], "notes": self.notes[b : b + batch_size]}


class RecordingTokenizer(MidiTokenizer):
    """The port's tokenizer, keeping each token row the harness decodes."""

    def __init__(self, config):
        super().__init__(config)
        self.rows: list = []

    def truncate_at_eos(self, tokens):
        self.rows.append(np.asarray(tokens).copy())
        return super().truncate_at_eos(tokens)


def render_segments(statics: render.SynthStatics, sc, notes_list: list, seed: int) -> np.ndarray:
    """(len(notes_list), chunk_samples) audio of note lists rendered on the
    card with the bank (draws from a generator seeded `seed`)."""
    padded, masks = zip(*(render.pad_notes(n, sc.max_notes) for n in notes_list))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    draws = render.draw_render(statics, len(notes_list), sc, gen)
    wavs = render.render_batch(statics, torch.from_numpy(np.stack(padded)), torch.from_numpy(np.stack(masks)),
                               draws, sc)
    return wavs.cpu().numpy()


def eval_items(statics: render.SynthStatics, sc, tokenizer: MidiTokenizer, seed: int) -> InMemoryEvalDataset:
    """EVAL_CHUNKS items of 2.56 s, one short tail item of EVAL_TAIL_SEC and
    one item with an empty reference (silence), their audio rendered on the
    card from random GM drum notes (8-40 an item) and peak-normalised as
    `EvalDataset` does; the references are the notes as the tokenizer maps
    them (`map_notes_to_Gm_custom`)."""
    rng = np.random.default_rng(seed)
    n = EVAL_CHUNKS + 2
    refs = []
    for i in range(n):
        span = EVAL_TAIL_SEC if i == n - 2 else sc.input_sec
        k = 0 if i == n - 1 else int(rng.integers(8, 41))
        on = np.sort(rng.uniform(0, span - 0.1, k))
        raw = np.stack([on, on + 0.1, rng.choice(EVAL_GM_PITCHES, k), rng.integers(30, 128, k)], 1)
        refs.append(tokenizer.map_notes_to_Gm_custom(raw.astype(np.float32)))
    audio = render_segments(statics, sc, refs, seed)
    tail = int(EVAL_TAIL_SEC * sc.sample_rate)
    wavs = [normalize(a[:tail] if i == n - 2 else a).astype(np.float32) for i, a in enumerate(audio)]
    return InMemoryEvalDataset(wavs, refs)


def read_confusion(path: Path) -> tuple[list, list]:
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


def phase_eval(statics: render.SynthStatics, sc) -> dict:
    """The port's evaluation harness (`run_inference`) on the card: the
    ENST eval config with K1 and K5 on and seeded random weights, over
    EVAL_CHUNKS + 2 drum-like items held in memory (the card's machine has
    no pyarrow for the shards). Random weights make the F-measure
    meaningless: it is printed, not held to anything. TP, FN and FP are
    counted again here from the token rows the harness decoded: their
    aggregate must be the harness's, TP + FN the reference's notes, TP + FP
    the decoded notes after dedup, and the confusion CSV, read back, must
    hold each of both once."""
    with tempfile.TemporaryDirectory() as out_dir:
        cfg = load_config(EVAL_YAML, model=KERNELS_ON, inference={"output_path": out_dir})
        tokenizer = RecordingTokenizer(cfg.tokenizer)
        ds = eval_items(statics, sc, MidiTokenizer(cfg.tokenizer), SEED + 70)
        model = ADTModel(cfg.model, seed=SEED, device="cuda")
        counters = reset_counters()
        t0 = time.monotonic()
        metrics = run_inference(model, cfg.model, ds, tokenizer, cfg.inference, device="cuda")
        wall = time.monotonic() - t0
        launches = {k: c.launches for k, c in counters.items()}
        saved = json.loads((Path(out_dir) / "metrics.json").read_text())
        header, rows = read_confusion(Path(out_dir) / "confusion_matrix.csv")
        files = {f: (Path(out_dir) / f).read_bytes() for f in ("metrics.json", "confusion_matrix.csv")}
    bs = cfg.inference.batch_size
    n_batches = -(-len(ds) // bs)
    preds = [decode_tokens_to_notes(MidiTokenizer(cfg.tokenizer), r) for r in tokenizer.rows]
    n_ref, n_pred = sum(len(r) for r in ds.notes), sum(len(p) for p in preds)
    counts = dict(zip(("tp", "fn", "fp"), np.sum(
        [compute_metrics(np.asarray(r).reshape(-1, 4) if len(r) else [], p) for r, p in zip(ds.notes, preds)],
        axis=0, dtype=int).tolist()))
    onsets = np.concatenate([p[:, 0] for p in preds]) if n_pred else np.zeros(0)
    labels = [*ADTOF_LABEL_MAPPING.values()]
    grid = {r[0]: [int(x) for x in r[1 : len(labels) + 2]] for r in rows}
    csv_ref = sum(sum(grid[lbl]) for lbl in labels)
    csv_pred = sum(grid[lbl][j] for lbl in labels for j in range(len(labels))) + sum(grid["False Positive"])
    res = {"phase": "eval", "config": EVAL_YAML, "items": len(ds), "batch_size": bs, "batches": n_batches,
           "max_length": cfg.inference.max_length, "wall_s": wall, "items_per_s": len(ds) / wall,
           "reference_notes": n_ref, "predicted_notes": n_pred, "counts": counts,
           "f_measure": metrics["all"]["f_measure"], "metrics": metrics, "launches": launches,
           "onsets_past_input_sec": int((onsets >= cfg.shared.input_sec).sum()),
           "csv_reference_notes": csv_ref, "csv_predicted_notes": csv_pred,
           "breakdown": decode_breakdown(model, cfg, batch=bs)}
    emit(res)
    expected = {**dict.fromkeys(kernel_counters(), 0), "log_mel": n_batches,
                "fused_attention": n_batches * cfg.model.enc_layers}
    checks = {
        "every item decoded once": len(tokenizer.rows) == len(ds),
        "the harness's aggregate = the recount's": metrics["all"] == aggregate_metrics(*counts.values()),
        "TP + FN = reference notes": counts["tp"] + counts["fn"] == n_ref,
        "TP + FP = predicted notes": counts["tp"] + counts["fp"] == n_pred,
        "metrics.json = the returned metrics": saved == metrics and all(
            math.isfinite(v) for m in metrics.values() for v in m.values()),
        "onsets on the time-token grid": bool(((onsets >= 0) & (onsets < 2.96)).all()),
        "confusion CSV rows and columns": header == ["", *labels, "False Negative", "precision", "recall", "f1",
                                                      "support"] and [r[0] for r in rows] == [*labels, "False Positive"]
                                           and all(len(r) == len(header) for r in rows),
        "confusion CSV counts each note once": (csv_ref, csv_pred) == (n_ref, n_pred),
        "K1 and K5f launched as the batches need": tpu_launches(launches) == expected,
        "the batch-invariance kernels launched": all(launches[k] for k in repair_kernels()),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"eval phase failed {failed}: launches {launches}, expected {expected}, counts {counts}")
    del model
    torch.cuda.empty_cache()
    # the single-device run that decode_dp and eval_ddp must reproduce
    res["reference"] = {"rows": tokenizer.rows, "metrics": metrics, "files": files, "launches": launches,
                        "wall_s": wall, "wavs": ds.wavs, "notes": ds.notes}
    return res


def yaml_text(sections: dict) -> str:
    """Sections of scalars and lists of scalars as YAML the port's reader takes."""
    lines = []
    for name, fields in sections.items():
        lines.append(f"{name}:")
        lines.extend(f"  {k}: {json.dumps(v, ensure_ascii=False)}" for k, v in fields.items())
    return "\n".join(lines) + "\n"


def run_cli(args: list, timeout: int = 600, env: dict | None = None) -> tuple[subprocess.CompletedProcess, float]:
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, *args], cwd=REPO, capture_output=True, text=True, timeout=timeout,
                          env=None if env is None else {**os.environ, **env})
    if proc.returncode != 0:
        raise RuntimeError(f"{args[:2]} exited {proc.returncode}: {proc.stderr[-3000:]}")
    return proc, time.monotonic() - t0


def phase_inference(statics: render.SynthStatics, sc) -> dict:
    """The offline transcription CLI on the card: a seeded model's state dict
    as a reference checkpoint and INFERENCE_SEC of drum audio rendered with
    the bank, through `python -m adt_str_tpu_torch.inference` (plain and
    with a 1.28 s hop) with the ENST eval config and K1 and K5 on; then,
    in this process, the same `transcribe` calls and the resynthesis
    (K2, K3) of the transcribed notes that the synthesiser can play (the
    rendered notes when there are none)."""
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "ckpt").mkdir()
        cfg = load_config(EVAL_YAML, model=KERNELS_ON, inference={"checkpoint_path": str(tmp / "ckpt")})
        model = ADTModel(cfg.model, seed=SEED, device="cuda")
        torch.save(model.state_dict(), tmp / "ckpt" / "pytorch_model.bin")
        rng = np.random.default_rng(SEED + 80)
        n_seg = math.ceil(INFERENCE_SEC / sc.input_sec)
        seg_notes = []
        for _ in range(n_seg):
            on = np.sort(rng.uniform(0, sc.input_sec - 0.1, 24))
            seg_notes.append(np.stack([on, on + 0.1, rng.choice([35, 38, 42, 48], 24), rng.integers(30, 128, 24)], 1))
        wave = render_segments(statics, sc, seg_notes, SEED + 81).reshape(-1)[: int(INFERENCE_SEC * sc.sample_rate)]
        write_wav(tmp / "song.wav", wave, sc.sample_rate)
        raw = cfg.raw
        (tmp / "cfg.yaml").write_text(yaml_text({
            "shared": raw["shared"], "tokenizer": raw["tokenizer"], "model": {**raw["model"], **KERNELS_ON},
            "inference": {**raw["inference"], "checkpoint_path": str(tmp / "ckpt")}}))
        cli = {}
        for name, hop in (("plain", []), ("hop", ["--hop_sec", str(INFERENCE_HOP_SEC)])):
            proc, secs = run_cli(["-m", "adt_str_tpu_torch.inference", str(tmp / "song.wav"), str(tmp / "cfg.yaml"),
                                  "-o", str(tmp / name), *hop])
            midi = (tmp / name / "song.mid").read_bytes()
            cli[name] = {"wall_s": secs, "midi_bytes": len(midi), "stdout": proc.stdout.strip().splitlines()[-1],
                         "midi": midi}

        tokenizer = MidiTokenizer(cfg.tokenizer)
        counters = reset_counters()
        t0 = time.monotonic()
        notes = port_inference.transcribe(model, cfg, wave, tokenizer, device="cuda")
        torch.cuda.synchronize()
        transcribe_s = time.monotonic() - t0
        notes_hop = port_inference.transcribe(model, cfg, wave, tokenizer, device="cuda", hop_sec=INFERENCE_HOP_SEC)
        playable = notes[(notes[:, 2] >= render.PITCH_LO) & (notes[:, 2] <= render.PITCH_HI)]
        source = "transcribed"
        if not len(playable):
            playable = np.concatenate([n + [i * sc.input_sec, i * sc.input_sec, 0, 0] for i, n in enumerate(seg_notes)])
            source = "rendered"
        t0 = time.monotonic()
        resynth = port_inference.resynthesize(playable, sc, statics)
        resynth_s = time.monotonic() - t0
        launches = {k: c.launches for k, c in counters.items()}
        same_midi = {}
        for name, n in (("plain", notes), ("hop", notes_hop)):
            write_midi(tmp / f"{name}.mid", n)
            same_midi[name] = (tmp / f"{name}.mid").read_bytes() == cli[name].pop("midi")
    # the kernels at the shapes this path gave them, against their plain versions
    vs_plain = {}
    for name, hop in (("plain", None), ("hop", int(INFERENCE_HOP_SEC * cfg.shared.sample_rate))):
        chunks, _ = port_inference.chunk_audio(wave, cfg.shared.chunk_samples, hop)
        vs_plain[f"encoder_{name}"] = encoder_vs_plain(model, torch.from_numpy(chunks).cuda())
    with plain_kernels():
        resynth_plain = port_inference.resynthesize(playable, sc, statics)
    vs_plain["resynthesis_equal_to_plain_path"] = bool(np.array_equal(resynth, resynth_plain))
    n_chunks = int(np.asarray(playable, np.float32)[:, 1].max() // sc.input_sec) + 1
    res = {"phase": "inference", "config": EVAL_YAML, "audio_s": INFERENCE_SEC, "hop_sec": INFERENCE_HOP_SEC,
           "cli": cli, "notes": len(notes), "notes_hop": len(notes_hop), "transcribe_s": transcribe_s,
           "cli_midi_equals_in_process": same_midi, "kernel_path_vs_plain_path": vs_plain, "resynthesis": {
               "source": source, "notes": len(playable), "samples": resynth.shape[0], "chunks": n_chunks,
               "seconds": resynth_s, "peak": float(np.abs(resynth).max())}, "launches": launches}
    emit(res)
    expected = {**dict.fromkeys(kernel_counters(), 0), "log_mel": 2, "fused_attention": 2 * cfg.model.enc_layers,
                "gather_blend": 1, "place_notes": 1}
    checks = {
        "resynthesis shape and values": resynth.shape == (n_chunks * sc.chunk_samples,) and np.isfinite(resynth).all(),
        "K1, K5f, K2 and K3 launched as the path needs": tpu_launches(launches) == expected,
        "the batch-invariance kernels launched": all(launches[k] for k in repair_kernels()),
        "the CLI wrote MIDI notes": all(c["midi_bytes"] > 22 for c in cli.values()),
        "the CLI's MIDI = the in-process kernel path's": all(same_midi.values()),
        "the encoder's kernels agree with their plain versions": vs_plain["encoder_plain"]["ok"]
                                                                and vs_plain["encoder_hop"]["ok"],
        "the resynthesis = the plain-path resynthesis": vs_plain["resynthesis_equal_to_plain_path"],
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"inference phase failed {failed}: launches {launches}, expected {expected}, "
                           f"{res['resynthesis']}, {vs_plain}")
    del model
    torch.cuda.empty_cache()
    return res


def phase_bench() -> dict:
    """The port's bench (`adt_str_tpu_torch/bench.py`'s `main`) with its
    whole workload: its JSON line on a line of its own, every window's time,
    the kernels' launches during the timed windows (K1, K2 and K3 once a
    step); then one bench batch (48 note slots, the 192-row bank) rendered through K2 and K3 must
    equal its render through the plain versions on the same draws."""
    counters = all_counters()  # a training step launches no batch-invariance kernel: expected 0
    t0 = time.monotonic()
    warm: dict = {}

    def before_windows():
        torch.cuda.synchronize()
        warm["setup_and_warm_up_s"] = time.monotonic() - t0
        for c in counters.values():
            c.launches = 0
        torch.cuda.reset_peak_memory_stats()

    line, b, windows = port_bench.main(device="cuda", before_windows=before_windows)
    launches = {k: c.launches for k, c in counters.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    notes, mask = b.batch["notes"], b.batch["note_mask"]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 90)
    draws = render.draw_render(b.statics, notes.shape[0], b.synth, gen)
    out = render.render_batch(b.statics, notes, mask, draws, b.synth)
    with plain_kernels():
        ref = render.render_batch(b.statics, notes, mask, draws, b.synth)
    steps = port_bench.MEASURE_STEPS * port_bench.MEASURE_WINDOWS
    res = {"phase": "bench", "line": line, "window_s": windows,
           "step_ms_by_window": [w / port_bench.MEASURE_STEPS * 1e3 for w in windows], **warm,
           "note_slots": notes.shape[1], "bank_rows": b.statics.waveforms.shape[0],
           "tokens": b.batch["tokens"].shape[1], "launches": launches, "peak_mem_gib": peak_gib,
           "render_equal_to_plain_path": bool(torch.equal(out, ref)),
           "render_max_abs_err_vs_plain": (out - ref).abs().max().item()}
    emit(res)
    expected = {**dict.fromkeys(counters, 0), "log_mel": steps, "gather_blend": steps, "place_notes": steps}
    if launches != expected or not res["render_equal_to_plain_path"]:
        raise RuntimeError(f"bench: kernel launches {launches}, expected {expected}; "
                           f"render equal to the plain path: {res['render_equal_to_plain_path']}")
    del b
    torch.cuda.empty_cache()
    return res


class StepLog(logging.Handler):
    """The numbers (`record.step_metrics`) of the trainer's log lines."""

    def __init__(self):
        super().__init__()
        self.records: list = []

    def emit(self, record):
        if hasattr(record, "step_metrics"):
            self.records.append(record.step_metrics)


def run_trainer(cfg: FrameworkConfig, device="cuda", **kw) -> dict:
    """`trainer.train(cfg, device=device, **kw)` with every kernel counter
    set to 0 just before and read just after -> the final state, the logged
    steps, the eval lines, the launches and the wall seconds."""
    log = StepLog()
    logging.getLogger(trainer.__name__).addHandler(log)
    try:
        torch.cuda.synchronize()
        counters = reset_counters()
        t0 = time.monotonic()
        state = trainer.train(cfg, device=device, **kw)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = {k: c.launches for k, c in counters.items()}
    finally:
        logging.getLogger(trainer.__name__).removeHandler(log)
    steps = [r for r in log.records if "loss" in r]
    return {"state": state, "steps": steps, "evals": [r for r in log.records if "eval_loss" in r],
            "launches": launches, "wall_s": wall}


def gm_note_rows(n: int, seed: int, most: int) -> list:
    """`n` rows of GM-standard drum notes (as a Lakh or TMIDT shard holds
    them): 4 to `most` notes a row, log-uniformly (so batches fill note and
    token buckets of many sizes), onsets in [0, 2.4) s, velocities 30..127."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        k = int(np.exp(rng.uniform(np.log(4), np.log(most + 1))))
        on = np.sort(rng.uniform(0, 2.4, k))
        rows.append(np.stack([on, on + 0.1, rng.choice(EVAL_GM_PITCHES, k), rng.integers(30, 128, k)], 1)
                    .astype(np.float32))
    return rows


def step_rate(run: dict, every: int = 0, exclude=()) -> dict:
    """The logged steps/s. Step k's is read when the host fetches its loss,
    just after it has queued step k + 1, over the time since the last fetch:
    the first holds the start-up; a step that evaluates or saves (every
    `every` steps) and the last one are fetched at once after the step
    before them (their rate is the device's remaining work only), and the
    step after an eval or save holds that work; the two steps before a
    profiled one (`exclude`) hold the profiler's start and stop. The steady
    rate is the median over the other steps."""
    rates = {r["step"]: r["steps_per_sec"] for r in run["steps"]}
    first, last = min(rates), max(rates)
    steady = [v for k, v in rates.items() if k not in (first, last, *exclude)
              and not (every and (k % every == 0 or (k - 1) % every == 0))]
    return {"logged_steps_per_sec": list(rates.values()), "steady_steps": len(steady),
            "steady_steps_per_sec": statistics.median(steady) if steady else None}


def phase_trainer(bank: OneShotBank, statics: render.SynthStatics) -> dict:
    """The port's training job (`trainer.train`) on setting-1 at full width,
    batch 64: an in-memory LakhDataset of TRAINER_ROWS seeded GM note rows
    (the card's machine has no pyarrow) with a one-batch holdout, the card
    bank; TRAINER_STEPS steps saving and evaluating every
    TRAINER_STEPS // 2 (the second half crosses into epoch 1); then a second
    run resumes from the middle checkpoint and runs to the end; a save and a
    restore are timed on their own. Its steps and final weights must equal the straight
    run's; the final `model.safetensors` must read back as the model; the
    eval history must hold two finite lines; K1, K2 and K3 must launch once
    a step and once an eval batch; one trainer batch (its trimmed note
    bucket) must render bit-equal through K2/K3 and through the plain
    versions, and one trainer step's loss agree with a plain-path step."""
    half = TRAINER_STEPS // 2
    with tempfile.TemporaryDirectory() as tmp:
        common = dict(training={"max_steps": TRAINER_STEPS, "num_epochs": 2},  # 7 steps an epoch
                      train_data={"holdout_fraction": TRAINER_HOLDOUT},
                      logging={"output_dir": tmp, "logging_steps": 1, "save_every_n_steps": half,
                               "eval_every_n_steps": half})
        cfg = load_config(SYNTH_YAML, experiment={"run_name": "straight"}, **common)
        sc, mc = cfg.synthetiser, cfg.model
        rows = {"notes": [r.tobytes() for r in gm_note_rows(TRAINER_ROWS, SEED + 100, sc.max_notes)]}
        ds = LakhDataset(cfg.train_data, MidiTokenizer(cfg.tokenizer), max_notes=sc.max_notes, rows=rows)
        straight = run_trainer(cfg, dataset=ds, bank=bank)
        out = Path(tmp) / "straight"
        middle = out / trainer_ckpt.checkpoint_name(0, half)
        cfg2 = load_config(SYNTH_YAML, experiment={"run_name": "resumed"},
                           checkpoint={"resume_from_checkpoint": str(middle)}, **common)
        resumed = run_trainer(cfg2, dataset=ds, bank=bank)
        history = [json.loads(x) for x in (out / "eval_history.jsonl").read_text().splitlines()]
        final = Path(trainer_ckpt.latest_checkpoint(out))
        saved = read_safetensors(final / "model.safetensors")
        model_sd = {k: v.cpu() for k, v in straight["state"].model.state_dict().items()}
        safetensors_equal = sorted(saved) == sorted(model_sd) and all(torch.equal(saved[k], model_sd[k])
                                                                      for k in model_sd)
        checkpoint_gib = sum(f.stat().st_size for f in final.iterdir()) / 2**30
        # a save and a restore of the final state on their own (the work a resume adds)
        t0 = time.monotonic()
        trainer_ckpt.save_checkpoint(Path(tmp) / "timed", straight["state"].model, straight["state"].opt_state,
                                     TRAINER_STEPS)
        torch.cuda.synchronize()
        save_s = time.monotonic() - t0
        t0 = time.monotonic()
        probe = trainer.init_model(cfg, "cuda")
        torch.cuda.synchronize()
        init_s = time.monotonic() - t0
        t0 = time.monotonic()
        trainer_ckpt.restore_checkpoint(Path(tmp) / "timed" / trainer_ckpt.checkpoint_name(0, TRAINER_STEPS), probe)
        torch.cuda.synchronize()
        restore_s = time.monotonic() - t0
        del probe
    a = {r["step"]: r for r in straight["steps"]}
    b = {r["step"]: r for r in resumed["steps"]}
    resumed_steps = sorted(b)
    loss_rel = max(abs(a[i]["loss"] - b[i]["loss"]) / abs(a[i]["loss"]) for i in resumed_steps)
    params = dict(straight["state"].model.named_parameters())
    param_diff = max((p - params[n]).abs().max().item() for n, p in resumed["state"].model.named_parameters())
    param_scale = max(p.abs().max().item() for p in params.values())

    # one trainer batch (the first of epoch 0) through the kernels and through the plain versions
    batch = next(iter(ds.batches(cfg.training.batch_size, np.random.default_rng([cfg.experiment.seed, 0]))))
    b0 = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    key_gen, draw_gen = trainer.seeded_generators(cfg.experiment.seed + 1, 0, torch.device("cuda"))
    draws = render.draw_render(statics, b0["tokens"].shape[0], sc, draw_gen)
    keys = draw_site_keys(mc, key_gen)
    wav = render.render_batch(statics, b0["notes"], b0["note_mask"], draws, sc)
    with plain_kernels():
        wav_plain = render.render_batch(statics, b0["notes"], b0["note_mask"], draws, sc)

    def fresh():
        model = trainer.init_model(cfg, "cuda")
        opt, _ = make_optimizer(cfg.training, TRAINER_STEPS, model)
        return make_synth_train_step(mc, sc, statics, opt, device="cuda"), init_train_state(model, opt)

    step, state = fresh()
    with plain_kernels():
        _, m_plain = step(state, b0, draws, keys)
        plain = {k: float(m_plain[k]) for k in ("loss", "grad_norm")}
    del step, state, m_plain
    step, state = fresh()
    _, m = step(state, b0, draws, keys)
    kernel = {k: float(m[k]) for k in ("loss", "grad_norm")}
    del step, state, m
    per_step = {**dict.fromkeys(kernel_counters(), 0), "log_mel": 1, "gather_blend": 1, "place_notes": 1}
    n_evals = {"straight": 2, "resumed": 1}  # one holdout batch each
    expected = {run: {k: n * (len(r["steps"]) + n_evals[run]) for k, n in per_step.items()}
                for run, r in (("straight", straight), ("resumed", resumed))}
    res = {"phase": "trainer", "config": SYNTH_YAML, "batch": cfg.training.batch_size, "rows": TRAINER_ROWS,
           "holdout_rows": int(TRAINER_ROWS * TRAINER_HOLDOUT), "steps": TRAINER_STEPS,
           "losses": [a[i]["loss"] for i in sorted(a)], "grad_norms": [a[i]["grad_norm"] for i in sorted(a)],
           **step_rate(straight, half), "straight_wall_s": straight["wall_s"], "resumed_wall_s": resumed["wall_s"],
           "resumed_steps_rate": step_rate(resumed, half)["logged_steps_per_sec"], "save_s": save_s,
           "model_init_s": init_s, "restore_s": restore_s,
           "eval_history": history, "resumed_steps": resumed_steps,
           "resumed_losses": [b[i]["loss"] for i in resumed_steps], "resume_loss_max_rel_diff": loss_rel,
           "resume_loss_rtol": 1e-4, "resume_param_max_abs_diff": param_diff, "param_scale": param_scale,
           "resume_bit_equal": loss_rel == 0.0 and param_diff == 0.0, "safetensors_equal_to_model": safetensors_equal,
           "checkpoint_gib": checkpoint_gib, "first_batch": {"note_slots": batch["notes"].shape[1],
                                                            "tokens": batch["tokens"].shape[1]},
           "render_equal_to_plain_path": bool(torch.equal(wav, wav_plain)),
           "vs_plain_step": {"kernel": kernel, "plain": plain, "loss_rtol": 1e-4, "grad_norm_rtol": 2e-3},
           "launches": {"straight": straight["launches"], "resumed": resumed["launches"]},
           "expected_launches": expected}
    emit(res)
    checks = {
        "every loss finite": all(math.isfinite(x) for x in res["losses"] + res["grad_norms"]),
        "straight run took every step": sorted(a) == list(range(1, TRAINER_STEPS + 1)),
        "resumed run took the second half": resumed_steps == list(range(half + 1, TRAINER_STEPS + 1)),
        "resumed losses = straight losses": loss_rel <= 1e-4,
        "resumed weights = straight weights": param_diff <= 1e-4 * param_scale,
        "model.safetensors = the model": safetensors_equal,
        "two finite eval lines": [h["step"] for h in history] == [half, TRAINER_STEPS]
                                 and all(math.isfinite(h["eval_loss"]) for h in history),
        "K1, K2, K3 once a step and an eval batch":
            {r: tpu_launches(n) for r, n in res["launches"].items()} == expected,
        "trainer batch render = plain path": res["render_equal_to_plain_path"],
        "trainer step = plain-path step": abs(kernel["loss"] - plain["loss"]) <= 1e-4 * abs(plain["loss"])
                                          and abs(kernel["grad_norm"] - plain["grad_norm"]) <= 2e-3 * plain["grad_norm"],
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"trainer phase failed {failed}")
    del straight, resumed
    torch.cuda.empty_cache()
    return res


def phase_trainer_tmidt(statics: render.SynthStatics, sc) -> dict:
    """The training job on TMIDT-flash at full width, batch 64, TMIDT_STEPS
    steps: an in-memory TMIDTDataset of audio rendered on the card with the
    bank from seeded GM notes (as the eval phase renders its items). K1
    launches once a step, K5f and K5b once an attention a step, at the
    trimmed token buckets; the trainer traces one step
    (`logging.profile_steps`), and that trace must hold device time for
    every kernel the step launches; then K5f and K5b are held against their
    plain versions at the first batch's bucket (decoder self and cross)."""
    n = TMIDT_STEPS * TRAIN_BATCH
    with tempfile.TemporaryDirectory() as tmp:
        cfg = load_config(TRAIN_YAMLS["flash"], training={"batch_size": TRAIN_BATCH, "max_steps": TMIDT_STEPS},
                          logging={"output_dir": tmp, "logging_steps": 1, "save_every_n_steps": None,
                                   "profile_steps": [TMIDT_PROFILED, TMIDT_PROFILED]})
        tok = MidiTokenizer(cfg.tokenizer)
        raw = gm_note_rows(n, SEED + 110, 100)
        audio = render_segments(statics, sc, [tok.map_notes_to_Gm_custom(r) for r in raw], SEED + 111)
        rows = {"audio": [a.astype(np.float32).tobytes() for a in audio], "sample_rate": [sc.sample_rate] * n,
                "notes": [r.tobytes() for r in raw]}
        ds = TMIDTDataset(cfg.train_data, tok, rows=rows)
        run = run_trainer(cfg, dataset=ds)
        traces = list((Path(tmp) / cfg.experiment.run_name / "profile").glob("*.json"))
        events = json.loads(traces[0].read_text()).get("traceEvents", []) if len(traces) == 1 else []
    mc = cfg.model
    buckets = [b["tokens"].shape[1] for b in ds.batches(TRAIN_BATCH, np.random.default_rng([cfg.experiment.seed, 0]))]
    per_step = mc.enc_layers + 2 * mc.dec_layers
    one_step = {**dict.fromkeys(kernel_counters(), 0), "log_mel": 1, "fused_attention": per_step,
                "fused_attention_bwd": per_step}
    expected = {k: n * TMIDT_STEPS for k, n in one_step.items()}
    # the trainer's own trace of one step (`logging.profile_steps`): every kernel the step launches must
    # have device time in it (a session now and then records no device event at all: then it is only
    # reported); busy share = device time over the trace's span
    device_events = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    profile = None
    if events:
        profile = device_time_by_group(events, one_step) if device_events else {"device_kernels": 0}
    if device_events:
        ts = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))) for e in events if "ts" in e and e.get("ph") == "X"]
        profile["span_ms"] = (max(b for _, b in ts) - min(a for a, _ in ts)) / 1e3
        profile["device_busy_share_of_span"] = profile["device_busy_ms"] / profile["span_ms"]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 112)
    tq = buckets[0] - 1  # the decoder's inputs: the bucket less the last label
    at_bucket = {f"decoder-self {tq}": (tq, tq, True), f"cross {tq} x 246": (tq, 246, False)}
    vs_plain = {s: {"fwd": phase_attention(TRAIN_BATCH, *shape, gen, s),
                    "bwd": phase_attention_bwd(TRAIN_BATCH, *shape, gen, s)} for s, shape in at_bucket.items()}
    losses = [r["loss"] for r in run["steps"]]
    res = {"phase": "trainer_tmidt", "config": TRAIN_YAMLS["flash"], "batch": TRAIN_BATCH, "items": n,
           "steps": TMIDT_STEPS, "token_buckets": buckets, "losses": losses,
           **step_rate(run, exclude=(TMIDT_PROFILED - 1, TMIDT_PROFILED)),
           "wall_s": run["wall_s"], "launches": run["launches"], "expected_launches": expected,
           "profiled_step": TMIDT_PROFILED + 1, "trainer_profile": profile,
           "kernels_at_bucket": {s: {d: {k: r[k] for k in ("max_abs_err", "tol", "ms", "plain_ms")}
                                     for d, r in v.items()} for s, v in vs_plain.items()}}
    emit(res)
    if not (len(losses) == TMIDT_STEPS and all(math.isfinite(x) for x in losses)):
        raise RuntimeError(f"trainer_tmidt: losses {losses}")
    if tpu_launches(run["launches"]) != expected:
        raise RuntimeError(f"trainer_tmidt: launches {run['launches']}, expected {expected}")
    if all(b == cfg.train_data.max_tokens for b in buckets):
        raise RuntimeError(f"trainer_tmidt: no batch was trimmed to a token bucket: {buckets}")
    if profile is None:
        raise RuntimeError(f"trainer_tmidt: the trainer wrote no profile of step {TMIDT_PROFILED + 1}: {traces}")
    del run
    torch.cuda.empty_cache()
    return res


def beam_decode(length_penalty: float, beam_size: int):
    def decode(model, memory, max_len, bos, eos):
        return beam_search_decode_from_memory(model, memory, max_len, beam_size, bos, eos, length_penalty)

    return decode


def phase_beam(statics: render.SynthStatics, sc) -> dict:
    """Beam search on the card: `run_inference` with `use_beam_search`
    (beam BEAM_SIZE, length penalty 1.0) over the eval phase's items with
    the ENST eval config and K1 and K5 on; every decoded row well formed
    (BOS, then only EOS after the first EOS); K1 once a batch and K5f once
    an encoder layer a batch; a beam-1 decode of one batch equal to the
    greedy decode's tokens; the HTTP server around
    `ServingEngine(use_beam=True)` (the serving config with
    `serving.use_beam_search` on) answering N_REQUESTS concurrent requests;
    decode ms a step and the device's busy share of a beam decode."""
    with tempfile.TemporaryDirectory() as out_dir:
        cfg = load_config(EVAL_YAML, model=KERNELS_ON, inference={"output_path": out_dir, "use_beam_search": True,
                                                                   "beam_size": BEAM_SIZE})
        tokenizer = RecordingTokenizer(cfg.tokenizer)
        ds = eval_items(statics, sc, MidiTokenizer(cfg.tokenizer), SEED + 70)
        model = ADTModel(cfg.model, seed=SEED, device="cuda")
        counters = reset_counters()
        t0 = time.monotonic()
        metrics = run_inference(model, cfg.model, ds, tokenizer, cfg.inference, device="cuda")
        wall = time.monotonic() - t0
        launches = {k: c.launches for k, c in counters.items()}
        files = {f: (Path(out_dir) / f).read_bytes() for f in ("metrics.json", "confusion_matrix.csv")}
    bs, max_len = cfg.inference.batch_size, cfg.inference.max_length
    bos, eos = cfg.tokenizer.BOS_token, cfg.tokenizer.EOS_token
    n_batches = -(-len(ds) // bs)

    def well_formed(row) -> bool:
        ends = np.nonzero(row == eos)[0]
        return row[0] == bos and (not len(ends) or (row[ends[0]:] == eos).all())

    wavs = torch.from_numpy(np.stack(ds.wavs[:bs])).cuda()
    greedy = greedy_decode(model, wavs, max_length=max_len, start_token=bos, end_token=eos)
    beam1 = beam_search_decode(model, wavs, max_length=max_len, beam_size=1, start_token=bos, end_token=eos)
    breakdown = decode_breakdown(model, cfg, batch=bs, decode=beam_decode(1.0, BEAM_SIZE))
    del model
    serve_cfg = load_config(SERVING_YAML, serving={"use_beam_search": True, "beam_size": BEAM_SIZE,
                                                   "length_penalty": 1.0})
    engine = build_engine(serve_cfg, ADTModel(serve_cfg.model, seed=SEED, device="cuda"))
    engine_beam = (engine.use_beam, engine.beam_size, engine.length_penalty)
    results, serve_wall, serve_launches, stats = serve_requests(engine, serve_cfg)
    res = {"phase": "beam", "config": EVAL_YAML, "beam_size": BEAM_SIZE, "length_penalty": 1.0, "batch_size": bs,
           "max_length": max_len, "items": len(ds), "batches": n_batches, "wall_s": wall,
           "items_per_s": len(ds) / wall, "f_measure": metrics["all"]["f_measure"], "launches": launches,
           "rows_decoded": len(tokenizer.rows), "rows_with_eos": int(sum((r == eos).any() for r in tokenizer.rows)),
           "beam1_equals_greedy": bool(torch.equal(beam1, greedy)), "breakdown": breakdown,
           "serving": {"engine_beam": engine_beam, "wall_s": serve_wall, "request_s": [r[2] for r in results],
                       "n_notes": [json.loads(r[1])["n_notes"] for r in results], "launches": serve_launches,
                       "engine_stats": stats}}
    emit(res)
    expected = {**dict.fromkeys(kernel_counters(), 0), "log_mel": n_batches,
                "fused_attention": n_batches * cfg.model.enc_layers}
    checks = {
        "every item decoded once": len(tokenizer.rows) == len(ds),
        "every row well formed": all(well_formed(np.asarray(r)) for r in tokenizer.rows),
        "K1 and K5f launched as the batches need": tpu_launches(launches) == expected,
        "the batch-invariance kernels launched": all(launches[k] for k in repair_kernels()),
        "metrics finite": all(math.isfinite(v) for m in metrics.values() for v in m.values()),
        "beam 1 = greedy": res["beam1_equals_greedy"],
        "the served engine decodes with beam search": engine_beam == (True, BEAM_SIZE, 1.0),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"beam phase failed {failed}: launches {launches}, expected {expected}")
    torch.cuda.empty_cache()
    res["reference"] = {"rows": tokenizer.rows, "metrics": metrics, "files": files, "launches": launches,
                        "wall_s": wall}  # for decode_dp
    return res


# ------------------------------------------------------------------ data parallelism

DDP_WORLD = 2  # rank processes, both on cuda:0 over gloo (NCCL cannot hold two ranks on one card)
DDP_ROWS = TRAIN_BATCH // DDP_WORLD  # 32 rows a rank: the global batch is TRAIN_BATCH
DDP_SHIPPED_STEPS = 3
DDP_TRAINER_STEPS = 4  # saved and evaluated after 2 and 4; the resumed run takes 3-4
DDP_TIMEOUT = 360  # seconds the rank processes may take, all their phases together
ALLREDUCE_REPS = 5


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def weights_digest(model: torch.nn.Module) -> str:
    """sha256 of every weight's bytes in name order: equal digests, bit-equal weights."""
    h = hashlib.sha256()
    for name, p in model.named_parameters():
        h.update(name.encode())
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def draws_rows(draws: render.RenderDraws, rows: slice, device) -> render.RenderDraws:
    """The draws of `rows` of a batch, on `device`."""
    idx = torch.arange(rows.start, rows.stop)
    fx = draws.fx.take(idx.to(draws.lam.device))
    return render.RenderDraws(*(t[rows].to(device) for t in draws[:5]), type(fx)(*(t.to(device) for t in fx)))


def close_to(got: dict, ref: dict) -> bool:
    return (abs(got["loss"] - ref["loss"]) <= PARITY_TOL["loss_rtol"] * abs(ref["loss"])
            and abs(got["grad_norm"] - ref["grad_norm"]) <= PARITY_TOL["grad_norm_rtol"] * ref["grad_norm"])


def per_step(mc, synth: bool) -> dict:
    """The kernel launches of one training step of `mc`, by the variant its
    frontend and compute dtype take (K1's route; K4 in 16-bit or 3xTF32; K5
    by its route)."""
    n = {cuda_mel.ROUTE_WRAPPERS[cuda_mel.frames_route(mel_params(mc))].__name__: 1}
    if synth:
        n.update(gather_blend=1, place_notes=1)
    dtype = torch_dtype(mc.compute_dtype)
    if mc.use_pallas_ffn and mc.dropout > 0:
        n["ffn_dropout_tf32" if dtype == torch.float32 else "ffn_dropout"] = mc.enc_layers + mc.dec_layers
    if mc.use_flash_attention and mc.dropout == 0:
        fwd, bwd = attention_wrappers(dtype, mc.d_model // mc.nhead)
        n[fwd.__name__] = n[bwd.__name__] = mc.enc_layers + 2 * mc.dec_layers
    return n


def add_launches(total: dict, n: dict, times: int = 1) -> dict:
    for k, v in n.items():
        total[k] = total.get(k, 0) + v * times
    return total


def reset_counters() -> dict:
    """Every kernel wrapper's count to 0; -> every wrapper (`all_counters`)."""
    counters = all_counters()
    for c in counters.values():
        c.launches = 0
    return counters


def allreduce_ms(mesh, n_params: int) -> dict:
    """Median wall ms of `allreduce_grads` on a flat buffer of `n_params`
    on the card, in fp32 and through bf16 transport (with gloo: the copy to
    the host, the reduction there and the copy back)."""
    flat = torch.randn(n_params, device=mesh.device)
    out = {}
    for name, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        port_step.allreduce_grads(mesh, [flat], dtype)  # warm-up
        times = []
        for _ in range(ALLREDUCE_REPS):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            port_step.allreduce_grads(mesh, [flat], dtype)
            torch.cuda.synchronize()
            times.append((time.monotonic() - t0) * 1e3)
        out[name] = {"ms": statistics.median(times), "all_ms": times,
                     "mb": n_params * (4 if dtype is None else 2) / 1e6}
    return out


def rank_busy(fn, label: str) -> dict:
    """Device time of one call of `fn` under torch.profiler, traced after
    an untraced call in the same session, with no retry: a retry on one
    rank alone would put the ranks' collectives out of step. The busy share
    is None when the session saw no device."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    trace = _build.BUILD_DIR.parent / f"train_trace_{label}.json"
    trace.parent.mkdir(parents=True, exist_ok=True)
    schedule = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with torch.profiler.profile(activities=acts, schedule=schedule,
                                on_trace_ready=lambda p: p.export_chrome_trace(str(trace))) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
        prof.step()
    res = device_time_by_group(json.loads(trace.read_text()).get("traceEvents", []), {})
    return {"wall_ms": wall_us / 1e3, **res,
            "device_busy_share": res["device_busy_ms"] * 1e3 / wall_us if res["device_kernels"] else None}


def timed_steps(model, make, call, n: int) -> tuple[dict, tuple]:
    """`n` steps of `call(step, state, i)` from `model` with a fresh
    optimizer (constant lr) -> (losses, grad norms, step ms, the weights'
    digest; (step, state))."""
    opt, _ = make_optimizer(TrainingConfig(learning_rate=TRAIN_LR, warmup_ratio=0.0, lr_scheduler_type="constant"),
                            TRAIN_STEPS, model)
    step, state = make(opt), init_train_state(model, opt)
    out = {"losses": [], "grad_norms": [], "step_ms": []}
    for i in range(n):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        state, m = call(step, state, i)
        out["losses"].append(float(m["loss"]))
        out["grad_norms"].append(float(m["grad_norm"]))
        torch.cuda.synchronize()
        out["step_ms"].append((time.monotonic() - t0) * 1e3)
    out["digest"] = weights_digest(model)
    return out, (step, state)


def ddp_inputs(statics: render.SynthStatics, sc) -> tuple[dict, dict]:
    """The parity batches at the global batch (setting-1 note lists with
    its draws, TMIDT waves; random 512-token rows) on the host for the
    ranks, and the single-process references on all TRAIN_BATCH rows: one
    step of each, the per-rank means of the ddp weighting's formula, and
    the NCCL one-rank step against the no-mesh step in this process."""
    synth_cfg = load_config(SYNTH_YAML, train=True, model={"dropout": 0.0})
    flash_cfg = load_config(TRAIN_YAMLS["flash"], train=True)
    notes, mask = random_notes(sc, TRAIN_BATCH, SEED + 200)
    synth_batch = {"notes": notes, "note_mask": mask,
                   **token_batch(synth_cfg, torch.Generator().manual_seed(SEED + 201))}
    draws = render.draw_render(statics, TRAIN_BATCH, sc, torch.Generator(device="cuda").manual_seed(SEED + 202))
    flash_batch = train_batch(flash_cfg, SEED + 203)
    keys = draw_site_keys(flash_cfg.model, torch.Generator().manual_seed(SEED + 204))  # dropout 0: unused
    refs = {}
    model = ADTModel(synth_cfg.model, seed=SEED, device="cuda")
    r, _ = timed_steps(model, lambda opt: make_synth_train_step(synth_cfg.model, sc, statics, opt, device="cuda"),
                       lambda step, state, i: step(state, synth_batch, draws, keys), 1)
    refs["synth"] = {"loss": r["losses"][0], "grad_norm": r["grad_norms"][0]}
    model = ADTModel(flash_cfg.model, seed=SEED, device="cuda")
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():  # ddp_loss_weighting: the mean of the ranks' token-masked means
        halves = [float(model.forward_loss(flash_batch["wavs"][s], flash_batch["tokens"][s],
                                           flash_batch["token_lengths"][s], keys=keys, train=True))
                  for s in (slice(0, DDP_ROWS), slice(DDP_ROWS, TRAIN_BATCH))]
    refs["ddp_weighting"] = {"rank_means": halves, "loss": sum(halves) / DDP_WORLD}
    r, _ = timed_steps(model, lambda opt: make_train_step(flash_cfg.model, opt, device="cuda"),
                       lambda step, state, i: step(state, flash_batch, keys), 2)
    refs["flash"] = {"loss": r["losses"][0], "grad_norm": r["grad_norms"][0], "step_ms": r["step_ms"]}
    refs["nccl"] = nccl_one_rank(model, initial, flash_cfg, flash_batch, keys)
    del model, initial
    torch.cuda.empty_cache()
    host = {"synth_batch": {k: v.cpu() for k, v in synth_batch.items()},
            "draws": draws_rows(draws, slice(0, TRAIN_BATCH), "cpu"),
            "flash_batch": {k: v.cpu() for k, v in flash_batch.items()}, "keys": keys}
    return host, refs


def nccl_one_rank(model, initial: dict, cfg, batch: dict, keys) -> dict:
    """One rank of NCCL in this process (torchrun's environment for a world
    of 1, `maybe_initialize_distributed` picks NCCL on cuda:0): the flash
    parity step through the mesh (and a second step: the first collective
    also sets up NCCL's communicator), the gradient all-reduce's time."""
    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port()), "RANK": "0", "WORLD_SIZE": "1",
           "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    counters = reset_counters()
    try:
        device = mesh_lib.maybe_initialize_distributed()
        try:
            mesh = mesh_lib.make_mesh(devices=[device])
            model.load_state_dict(initial)
            r, _ = timed_steps(model, lambda opt: make_train_step(cfg.model, opt, mesh=mesh),
                               lambda step, state, i: step(state, batch, keys), 2)
            launches = {k: c.launches for k, c in counters.items()}
            n_params = sum(p.numel() for p in model.parameters())
            res = {"backend": mesh.backend, "device": str(device), "world": mesh.world, "loss": r["losses"][0],
                   "grad_norm": r["grad_norms"][0], "step_ms": r["step_ms"], "launches": launches,
                   "allreduce": allreduce_ms(mesh, n_params), "n_params": n_params}
        finally:
            mesh_lib.destroy()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return res


def rank_main(rank: int, job_path: str) -> None:
    """A rank process of the data-parallel phases: torchrun's environment
    (each phase's own port), then `rank_job`; its results go to the job's
    directory as `rank{rank}.pt`."""
    job = torch.load(job_path, weights_only=False)
    os.environ.update(MASTER_ADDR="127.0.0.1", RANK=str(rank), WORLD_SIZE=str(DDP_WORLD), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(DDP_WORLD))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sc = load_config(SYNTH_YAML, show=False).synthetiser
    bank = build_card_bank(sc, SEED + 50)  # the parent's bank, built again from the same seed
    statics = render.SynthStatics.from_bank(bank, device="cuda")
    res = {"ddp_step": rank_ddp_step(rank, job, statics, sc)}
    torch.cuda.empty_cache()
    res["trainer_ddp"] = rank_trainer(rank, job, bank)
    torch.cuda.empty_cache()
    res["eval_ddp"] = rank_eval(rank, job)
    torch.save(res, Path(job["dir"]) / f"rank{rank}.pt")


def rank_ddp_step(rank: int, job: dict, statics: render.SynthStatics, sc) -> dict:
    """This rank's part of the ddp_step phase (see `phase_ddp`)."""
    os.environ["MASTER_PORT"] = str(job["ports"]["ddp_step"])
    device = mesh_lib.maybe_initialize_distributed("cuda:0")
    try:
        mesh = mesh_lib.make_mesh(devices=[device])
        rows = mesh.local_rows(TRAIN_BATCH)
        synth_cfg = load_config(SYNTH_YAML, train=True, show=False, model={"dropout": 0.0})
        shipped_cfg = load_config(SYNTH_YAML, train=True, show=False)
        flash_cfg = load_config(TRAIN_YAMLS["flash"], train=True, show=False)
        ffn_cfg = load_config(TRAIN_YAMLS["fused-ffn"], train=True, show=False)
        sb = {k: v[rows].to(device) for k, v in job["synth_batch"].items()}
        fb = {k: v[rows].to(device) for k, v in job["flash_batch"].items()}
        draws = draws_rows(job["draws"], rows, device)
        keys = job["keys"]
        res = {"backend": mesh.backend, "device": str(device), "rank": mesh.rank, "world": mesh.world,
               "rows": [rows.start, rows.stop]}
        counters = reset_counters()
        expected: dict = {}

        def model_of(cfg):
            model = ADTModel(cfg.model, seed=SEED, device=device)
            mesh_lib.broadcast_model(mesh, model)  # rank 0's weights; raises unless the ranks' were equal
            return model

        # parity: setting-1 with dropout 0 and the fixed draws, TMIDT-flash (K5f, K5b)
        res["synth"], _ = timed_steps(
            model_of(synth_cfg), lambda opt: make_synth_train_step(synth_cfg.model, sc, statics, opt, mesh=mesh),
            lambda step, state, i: step(state, sb, draws, keys), 1)
        add_launches(expected, per_step(synth_cfg.model, True))
        torch.cuda.empty_cache()
        model = model_of(flash_cfg)
        initial = {k: v.clone() for k, v in model.state_dict().items()}
        res["flash"], (step, state) = timed_steps(
            model, lambda opt: make_train_step(flash_cfg.model, opt, mesh=mesh),
            lambda step, state, i: step(state, fb, keys), 1)
        res["flash_profile"] = rank_busy(lambda: step(state, fb, keys), f"ddp_flash_rank{rank}")
        add_launches(expected, per_step(flash_cfg.model, False), 3)
        del step, state
        # options: bf16 transport, ddp weighting, each one step from the same weights
        for name, kw in (("bf16", {"comm_dtype": "bf16"}), ("ddp_weighting", {"ddp_loss_weighting": True})):
            model.load_state_dict(initial)
            res[name], _ = timed_steps(model, lambda opt, kw=kw: make_train_step(flash_cfg.model, opt, mesh=mesh, **kw),
                                       lambda step, state, i: step(state, fb, keys), 1)
            add_launches(expected, per_step(flash_cfg.model, False))
        del model, initial
        torch.cuda.empty_cache()
        # the shipped dropout configs: per-rank keys (and draws) from (seed, step, rank)
        res["ffn"], _ = timed_steps(
            model_of(ffn_cfg), lambda opt: make_train_step(ffn_cfg.model, opt, mesh=mesh),
            lambda step, state, i: step(state, fb, draw_site_keys(ffn_cfg.model, trainer.seeded_generators(
                SEED + 1, i, device, mesh.rank)[0])), 1)
        add_launches(expected, per_step(ffn_cfg.model, False))
        torch.cuda.empty_cache()

        def shipped(step, state, i):
            key_gen, draw_gen = trainer.seeded_generators(SEED + 1, i, device, mesh.rank)
            return step(state, sb, render.draw_render(statics, DDP_ROWS, sc, draw_gen),
                        draw_site_keys(shipped_cfg.model, key_gen))

        model = model_of(shipped_cfg)
        res["shipped"], _ = timed_steps(
            model, lambda opt: make_synth_train_step(shipped_cfg.model, sc, statics, opt, mesh=mesh), shipped,
            DDP_SHIPPED_STEPS)
        add_launches(expected, per_step(shipped_cfg.model, True), DDP_SHIPPED_STEPS)
        res["launches"] = {k: c.launches for k, c in counters.items()}
        res["expected_launches"] = {**dict.fromkeys(counters, 0), **expected}
        n_params = sum(p.numel() for p in model.parameters())
        del model
        torch.cuda.empty_cache()
        res["allreduce"] = allreduce_ms(mesh, n_params)
        res["n_params"] = n_params
        return res
    finally:
        mesh_lib.destroy()


def rank_trainer(rank: int, job: dict, bank: OneShotBank) -> dict:
    """This rank's part of the trainer_ddp phase: `trainer.train` joins the
    group from torchrun's environment itself, straight and then resumed
    from the middle checkpoint, each run its own launch (port)."""
    out = Path(job["dir"]) / "trainer"
    common = dict(training={"max_steps": DDP_TRAINER_STEPS, "num_epochs": 2, "batch_size": DDP_ROWS},
                  train_data={"holdout_fraction": TRAINER_HOLDOUT},
                  logging={"output_dir": str(out), "logging_steps": 1, "save_every_n_steps": DDP_TRAINER_STEPS // 2,
                           "eval_every_n_steps": DDP_TRAINER_STEPS // 2})
    middle = out / "straight" / trainer_ckpt.checkpoint_name(0, DDP_TRAINER_STEPS // 2)
    cfgs = {"straight": load_config(SYNTH_YAML, show=False, experiment={"run_name": "straight"}, **common),
            "resumed": load_config(SYNTH_YAML, show=False, experiment={"run_name": "resumed"},
                                   checkpoint={"resume_from_checkpoint": str(middle)}, **common)}
    sc = cfgs["straight"].synthetiser
    rows = {"notes": [r.tobytes() for r in gm_note_rows(TRAINER_ROWS, SEED + 100, sc.max_notes)]}
    ds = LakhDataset(cfgs["straight"].train_data, MidiTokenizer(cfgs["straight"].tokenizer), max_notes=sc.max_notes,
                     rows=rows)
    writes: list = []
    write = trainer_ckpt._replace_into

    def counted(path, fn):
        writes.append(Path(path).name)
        return write(path, fn)

    trainer_ckpt._replace_into = counted
    res = {}
    try:
        for name, cfg in cfgs.items():
            os.environ["MASTER_PORT"] = str(job["ports"][f"trainer_{name}"])
            run = run_trainer(cfg, device="cuda:0", dataset=ds, bank=bank)  # every rank on the one card, gloo
            res[name] = {"steps": run["steps"], "evals": run["evals"], "launches": run["launches"],
                         "wall_s": run["wall_s"], "step": run["state"].step,
                         "digest": weights_digest(run["state"].model),
                         "group_destroyed": not torch.distributed.is_initialized()}
            del run
            torch.cuda.empty_cache()
    finally:
        trainer_ckpt._replace_into = write
    res["writes"] = writes
    if rank == 0:
        history = (out / "straight" / "eval_history.jsonl").read_text()
        res["eval_history"] = [json.loads(x) for x in history.splitlines()]
        res["checkpoints"] = sorted(p.name for p in (out / "straight").glob("checkpoint-*"))
    return res


def rank_eval(rank: int, job: dict) -> dict:
    """This rank's part of the eval_ddp phase: `run_inference` over a
    process-group mesh, each rank decoding its stripe of every batch."""
    os.environ["MASTER_PORT"] = str(job["ports"]["eval_ddp"])
    device = mesh_lib.maybe_initialize_distributed("cuda:0")
    try:
        mesh = mesh_lib.make_mesh(devices=[device])
        out = Path(job["dir"]) / "eval" / f"rank{rank}"
        cfg = load_config(EVAL_YAML, show=False, model=KERNELS_ON, inference={"output_path": str(out)})
        tokenizer = RecordingTokenizer(cfg.tokenizer)
        model = ADTModel(cfg.model, seed=SEED, device=device)
        counters = reset_counters()
        t0 = time.monotonic()
        metrics = run_inference(model, cfg.model, InMemoryEvalDataset(job["eval_wavs"], job["eval_notes"]), tokenizer,
                                cfg.inference, mesh=mesh)
        wall = time.monotonic() - t0
        res = {"metrics": metrics, "rows": tokenizer.rows, "wall_s": wall,
               "launches": {k: c.launches for k, c in counters.items()}, "wrote": out.exists(),
               "files": {f: (out / f).read_bytes() for f in ("metrics.json", "confusion_matrix.csv")}
               if out.exists() else {}}
        return res
    finally:
        mesh_lib.destroy()


def run_ranks(job: dict, target=rank_main, world: int = DDP_WORLD, timeout: float = DDP_TIMEOUT) -> list:
    """`target` (`rank_main`) in `world` spawned processes; each must exit 0
    within `timeout`. A rank that fails, or a hung collective, ends the
    phase: the other ranks are killed at once, or at the deadline."""
    job_path = Path(job["dir"]) / "job.pt"
    torch.save(job, job_path)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, str(job_path)), daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        while time.monotonic() < deadline and any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break  # a rank failed: the others would wait in a collective
            time.sleep(0.2)
    finally:
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(30)
    codes = [p.exitcode for p in procs]
    if hung or codes != [0] * world:
        raise RuntimeError(f"rank processes failed: exit codes {codes}, still running after {timeout} s: {hung}")
    return [torch.load(Path(job["dir"]) / f"rank{r}.pt", weights_only=False) for r in range(world)]


def phase_ddp(statics: render.SynthStatics, sc, eval_ref: dict, entry_ref: dict) -> dict:
    """The data-parallel phases of DDP_WORLD rank processes on the one card
    (gloo; torchrun's environment), after this process's references.

    - ddp_step: at full width, the global batch of TRAIN_BATCH rows split
      DDP_ROWS a rank; setting-1's synthesis-fused step (dropout 0 for the
      check, fixed draws) and TMIDT-flash (K5f, K5b) must equal the
      single-process step on the same rows and draws (loss 1e-4, grad norm
      2e-3 relative) with the ranks' weights bit-equal; setting-1 as
      shipped (dropout 0.1, per-rank keys and draws) for 3 steps, the loss
      falling, bit-equal; TMIDT-fused-ffn (K4) one step, bit-equal; one step
      with `ddp_loss_weighting` on ragged lengths equal to the mean of the
      two ranks' means computed here; one with bf16 transport whose grad
      norm lies within 1% of the fp32 step's; and one rank of NCCL in this
      process, equal to the no-mesh step (loss 1e-6 relative). Each rank's
      step ms, device busy share and the all-reduce ms of the 69,000,824
      gradients by backend and dtype are printed.
    - trainer_ddp: `trainer.train` on setting-1 at DDP_ROWS a rank (the
      trainer phase's in-memory Lakh rows and the card bank, each rank its
      own), DDP_TRAINER_STEPS steps saving and evaluating at the half, then
      a run resumed from the half: bit-equal to the straight run (losses
      and every weight), the ranks bit-equal, rank 0 alone writing the
      checkpoint files and `eval_history.jsonl`; the steady steps/s.
    - eval_ddp: `run_inference` over the eval phase's items in the two
      ranks, each decoding its 8 rows of every batch of 16: both hold the
      metrics, tokens and files of the one-process run at the ranks' batch
      of 8 (`entry_ref`, decode_dp's), which decodes the same blocks."""
    host, refs = ddp_inputs(statics, sc)
    with tempfile.TemporaryDirectory() as tmp:
        ports = {k: free_port() for k in ("ddp_step", "trainer_straight", "trainer_resumed", "eval_ddp")}
        job = {"dir": tmp, "ports": ports, **host, "eval_wavs": eval_ref["wavs"], "eval_notes": eval_ref["notes"]}
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        t0 = time.monotonic()
        ranks = run_ranks(job)
        wall = time.monotonic() - t0
    return {"ddp_step": check_ddp_step(ranks, refs, wall), "trainer_ddp": check_trainer_ddp(ranks),
            "eval_ddp": check_eval_ddp(ranks, eval_ref, entry_ref)}


# ------------------------------------------------- tensor parallelism (the mesh's model axis)

TP_WORLD = 2  # one model group of 2 ranks (a 1 x 2 mesh)
TP_BATCH = 8  # rows a step: gloo stages every activation all-reduce through host memory
TP_STEPS = 2
TP_TRAINER_STEPS = 2  # saved after 1 and 2; the resumed run takes step 2
TP_TIMEOUT = 420
TP_CONFIGS = ("flash", "fused-ffn")
TP_TOL = {"loss_rtol": 1e-3, "grad_norm_rtol": 1e-2}  # the TP step against the one-process step


def state_digest(sd: dict) -> str:
    """sha256 of a state dict's tensors in name order."""
    h = hashlib.sha256()
    for name in sorted(sd):
        h.update(name.encode())
        h.update(sd[name].detach().cpu().contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def replicated_digest(model: torch.nn.Module) -> str:
    """The digest of the parameters a model axis replicates: equal on every rank of a model group."""
    return state_digest({n: p for n, p in model.named_parameters() if tp_lib.split_of(n) is None})


def tp_allreduce_ms(axis, n: int, device) -> dict:
    """Median wall ms of the model group's all-reduce of `n` fp32 values (one
    residual branch's activations) from `device`."""
    t = torch.randn(n, device=device)
    axis.all_reduce(t)
    times = []
    for _ in range(ALLREDUCE_REPS):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        axis.all_reduce(t)
        torch.cuda.synchronize()
        times.append((time.monotonic() - t0) * 1e3)
    return {"ms": statistics.median(times), "all_ms": times, "mb": n * 4 / 1e6}


def tp_rank_main(rank: int, job_path: str) -> None:
    """A rank process of the tp phase: torchrun's environment, the TP steps
    (`tp_rank_step`) and, over gloo, the trainer (`tp_rank_trainer`); its
    results go to the job's directory as `rank{rank}.pt`."""
    job = torch.load(job_path, weights_only=False)
    os.environ.update(MASTER_ADDR="127.0.0.1", RANK=str(rank), WORLD_SIZE=str(TP_WORLD), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(TP_WORLD))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = {"step": tp_rank_step(job)}
    torch.cuda.empty_cache()
    if job["trainer"]:
        res["trainer"] = tp_rank_trainer(rank, job)
    torch.save(res, Path(job["dir"]) / f"rank{rank}.pt")


def tp_rank_step(job: dict) -> dict:
    """TP_STEPS steps of each TP_CONFIGS config at full width on this rank's
    shard (`make_train_step` over a 1 x TP_WORLD mesh) on the job's batch
    and keys, the launches counted; the model group's all-reduce timed."""
    os.environ["MASTER_PORT"] = str(job["ports"]["step"])
    device = mesh_lib.maybe_initialize_distributed(job["device"])
    try:
        mesh = mesh_lib.make_mesh(n_data=1, n_model=TP_WORLD, devices=[device])
        res = {"backend": mesh.backend, "device": str(device), "model_rank": mesh.model.rank,
               "n_model": mesh.n_model, "n_data": mesh.n_data}
        batch = {k: v.to(device) for k, v in job["batch"].items()}
        for name in TP_CONFIGS:
            cfg = load_config(TRAIN_YAMLS[name], train=True, show=False)
            model = ADTModel(cfg.model, seed=SEED, device=device, tp=mesh.model)
            counters = reset_counters()
            r, _ = timed_steps(model, lambda opt, mc=cfg.model: make_train_step(mc, opt, mesh=mesh),
                               lambda step, state, i, name=name: step(state, batch, job["keys"][name][i]), TP_STEPS)
            r["launches"] = {k: c.launches for k, c in counters.items()}
            r["expected_launches"] = add_launches(dict.fromkeys(counters, 0), per_step(cfg.model, False), TP_STEPS)
            r["replicated_digest"] = replicated_digest(model)
            r["shard_params"] = sum(p.numel() for p in model.parameters())
            res[name] = r
            del model
            torch.cuda.empty_cache()
        res["allreduce"] = tp_allreduce_ms(mesh.model, TP_BATCH * (TRAIN_TOKENS - 1) * 768, device)
        return res
    finally:
        mesh_lib.destroy()


def tp_rank_trainer(rank: int, job: dict) -> dict:
    """This rank's part of the tp phase's trainer: `trainer.train` on
    TMIDT-flash with `mesh.model_axis: 2` (it joins the group from torchrun's
    environment), straight for TP_TRAINER_STEPS steps saving every step, then
    resumed from the first save; the gathered weights' digest."""
    out = Path(job["dir"]) / "trainer"
    common = dict(training={"max_steps": TP_TRAINER_STEPS, "num_epochs": 1, "batch_size": TP_BATCH},
                  mesh={"model_axis": TP_WORLD}, train_data={"holdout_fraction": 0.0},
                  logging={"output_dir": str(out), "logging_steps": 1, "save_every_n_steps": 1})
    first = out / "straight" / trainer_ckpt.checkpoint_name(0, 1)
    cfgs = {"straight": load_config(TRAIN_YAMLS["flash"], show=False, experiment={"run_name": "straight"}, **common),
            "resumed": load_config(TRAIN_YAMLS["flash"], show=False, experiment={"run_name": "resumed"},
                                   checkpoint={"resume_from_checkpoint": str(first)}, **common)}
    cfg = cfgs["straight"]
    ds = TMIDTDataset(cfg.train_data, MidiTokenizer(cfg.tokenizer), rows=job["tmidt_rows"])
    res = {}
    for name, c in cfgs.items():
        os.environ["MASTER_PORT"] = str(job["ports"][f"trainer_{name}"])
        run = run_trainer(c, device="cuda:0", dataset=ds)
        model = run["state"].model
        res[name] = {"losses": [r["loss"] for r in run["steps"]], "launches": run["launches"],
                     "wall_s": run["wall_s"], "step": run["state"].step, "digest": weights_digest(model),
                     "shard_digest": state_digest(dict(model.named_parameters())),
                     "axis": None if model.tp is None else [model.tp.rank, model.tp.size]}
        del run, model
        torch.cuda.empty_cache()
    res["checkpoints"] = sorted(p.name for p in (out / "straight").glob("checkpoint-*"))
    return res


def tp_inputs() -> tuple[dict, dict]:
    """The TP steps' batch (TP_BATCH random 2.56 s waves and 512-token rows)
    and each step's site keys, on the host; the one-process step of each
    config on them in this process (the same seeded weights, whole)."""
    cfgs = {name: load_config(TRAIN_YAMLS[name], train=True, show=False) for name in TP_CONFIGS}
    g = torch.Generator().manual_seed(SEED + 400)
    wave = torch.randn(TP_BATCH, cfgs["flash"].shared.chunk_samples, generator=g) * 0.3
    toks = token_batch(cfgs["flash"], g)
    batch = {"wavs": wave, **{k: v[:TP_BATCH] for k, v in toks.items()}}
    keys = {name: [draw_site_keys(cfg.model, torch.Generator().manual_seed(SEED + 401 + i)) for i in range(TP_STEPS)]
            for name, cfg in cfgs.items()}
    refs = {}
    for name, cfg in cfgs.items():
        model = ADTModel(cfg.model, seed=SEED, device="cuda")
        on_card = {k: v.cuda() for k, v in batch.items()}
        r, _ = timed_steps(model, lambda opt, mc=cfg.model: make_train_step(mc, opt, device="cuda"),
                           lambda step, state, i, name=name: step(state, on_card, keys[name][i]), 2)
        refs[name] = {"loss": r["losses"][0], "grad_norm": r["grad_norms"][0], "step_ms": r["step_ms"]}
        del model
        torch.cuda.empty_cache()
    return {"batch": batch, "keys": keys}, refs


def tmidt_rows(n: int, cfg, seed: int) -> dict:
    """`n` in-memory TMIDT items: seeded noise at the config's rate and GM note rows."""
    rng = np.random.default_rng(seed)
    audio = (rng.standard_normal((n, cfg.shared.chunk_samples)) * 0.3).astype(np.float32)
    return {"audio": [a.tobytes() for a in audio], "sample_rate": [cfg.shared.sample_rate] * n,
            "notes": [r.tobytes() for r in gm_note_rows(n, seed + 1, 100)]}


def phase_tp(params, gen) -> dict:
    """Tensor parallelism at full width (`mesh.model_axis: 2`, Megatron
    layout, `parallel/tensor_parallel.py`).

    - The kernels at a rank's shapes, each held to its plain version: K1 at
      the TP batch (replicated on each rank); K5f and K5b at 3 heads of 128
      (the decoder's self-attention, 511 x 511, causal + padding); K4 at
      d_ff 1536 a rank, col0 0 and 1536 of 3072, in the partial mode.
    - Two rank processes on cuda:0 over gloo (one model group, a 1 x 2 mesh)
      run TMIDT-flash (K1, K5f, K5b) and TMIDT-fused-ffn (K1, K4 partial)
      for TP_STEPS steps at TP_BATCH rows from the same seeded weights: the
      first step's loss and grad norm against the one-process step on the
      same weights, batch and keys (loss 1e-3, grad norm 1e-2 relative), the
      ranks' numbers and replicated weights bit-equal, the kernels launched
      as the steps need; step ms and the group's all-reduce ms.
    - `trainer.train` on TMIDT-flash in both ranks at `mesh.model_axis: 2`:
      TP_TRAINER_STEPS steps saving every step, then a run resumed from the
      first save: bit-equal to the straight run; the final checkpoint,
      written whole, loads into a one-process model.
    - NCCL, one card a rank, where the machine has two cards or more (the
      steps alone); else it reports that it was not run.
    Gloo stages every collective through host memory: these are parity
    checks, not speed figures."""
    heads = 3
    tq = TRAIN_TOKENS - 1
    kernels = {
        "log_mel": phase_mel(params, TP_BATCH, gen),
        "fused_attention": phase_attention(TP_BATCH, tq, tq, True, gen, f"TP rank: B={TP_BATCH}, 3 heads, decoder self "
                                           f"{tq} x {tq}", heads=heads),
        "fused_attention_bwd": phase_attention_bwd(TP_BATCH, tq, tq, True, gen, f"TP rank: B={TP_BATCH}, 3 heads, "
                                                   f"decoder self {tq} x {tq}", heads=heads),
        "ffn_dropout": {c: phase_ffn(TP_BATCH * tq, gen, f"TP rank: N={TP_BATCH * tq}, d_ff 1536 from col0 {c} of 3072, "
                                     "partial", d_ff=1536, col0=c, d_ff_total=3072) for c in (0, 1536)},
    }
    host, refs = tp_inputs()
    flash = load_config(TRAIN_YAMLS["flash"], show=False)
    with tempfile.TemporaryDirectory() as tmp:
        ports = {k: free_port() for k in ("step", "trainer_straight", "trainer_resumed")}
        job = {"dir": tmp, "device": "cuda:0", "ports": ports, "trainer": True, **host,
               "tmidt_rows": tmidt_rows(3 * TP_BATCH, flash, SEED + 410)}
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        t0 = time.monotonic()
        ranks = run_ranks(job, tp_rank_main, TP_WORLD, TP_TIMEOUT)
        wall = time.monotonic() - t0
        last = Path(tmp) / "trainer" / "straight" / trainer_ckpt.checkpoint_name(0, TP_TRAINER_STEPS)
        whole = ADTModel(flash.model, seed=SEED + 1, device="cuda")
        trainer_ckpt.restore_checkpoint(last, whole)
        from_safetensors = read_safetensors(last / "model.safetensors")
        whole_params = dict(whole.named_parameters())
        one_process = {"safetensors_equal": all(torch.equal(from_safetensors[n].cuda(), p)
                                                for n, p in whole.state_dict().items()),
                       "generator_rows": int(from_safetensors["decoder.generator.weight"].shape[0]),
                       "shards_equal_the_ranks": [state_digest(tp_lib.shard_state_dict(whole_params, r, TP_WORLD))
                                                  == ranks[r]["trainer"]["straight"]["shard_digest"]
                                                  for r in range(TP_WORLD)]}
        del whole, whole_params
    nccl = None
    if torch.cuda.device_count() >= TP_WORLD:
        with tempfile.TemporaryDirectory() as tmp:
            nccl_job = {**job, "dir": tmp, "device": None, "trainer": False, "ports": {"step": free_port()}}
            nccl = [r["step"] for r in run_ranks(nccl_job, tp_rank_main, TP_WORLD, TP_TIMEOUT)]
    steps = [r["step"] for r in ranks]
    tr = [r["trainer"] for r in ranks]
    first = {name: {"loss": steps[0][name]["losses"][0], "grad_norm": steps[0][name]["grad_norms"][0]}
             for name in TP_CONFIGS}
    diff = {name: {"loss_rel": abs(first[name]["loss"] - refs[name]["loss"]) / abs(refs[name]["loss"]),
                   "grad_norm_rel": abs(first[name]["grad_norm"] - refs[name]["grad_norm"]) / refs[name]["grad_norm"]}
            for name in TP_CONFIGS}
    res = {"phase": "tp", "mesh": "1 x 2", "ranks": TP_WORLD, "backend": steps[0]["backend"],
           "device": steps[0]["device"], "batch": TP_BATCH, "tokens": TRAIN_TOKENS, "ranks_wall_s": wall,
           "kernels": {k: ({c: {f: r[f] for f in ("max_abs_err", "tol", "ms", "plain_ms", "bound_ms", "library_ms")}
                                for c, r in v.items()} if k == "ffn_dropout" else
                               {f: v[f] for f in ("max_abs_err", "tol", "ms", "plain_ms", "bound_ms", "library_ms")})
                       for k, v in kernels.items()},
           "parity": {name: {"tp": first[name], "one_process": refs[name], **diff[name], **TP_TOL}
                      for name in TP_CONFIGS},
           "losses": {name: steps[0][name]["losses"] for name in TP_CONFIGS},
           "step_ms": {f"rank{i}": {name: s[name]["step_ms"] for name in TP_CONFIGS} for i, s in enumerate(steps)},
           "one_process_step_ms": {name: refs[name]["step_ms"] for name in TP_CONFIGS},
           "allreduce_ms": {f"rank{i}": s["allreduce"] for i, s in enumerate(steps)},
           "shard_params": {name: steps[0][name]["shard_params"] for name in TP_CONFIGS},
           "launches": {f"rank{i}": {name: s[name]["launches"] for name in TP_CONFIGS} for i, s in enumerate(steps)},
           "trainer": {"losses": tr[0]["straight"]["losses"], "resumed_losses": tr[0]["resumed"]["losses"],
                       "checkpoints": tr[0]["checkpoints"], "wall_s": [t["straight"]["wall_s"] for t in tr],
                       "launches": {f"rank{i}": {k: t[k]["launches"] for k in ("straight", "resumed")}
                                    for i, t in enumerate(tr)},
                       "one_process_restore": one_process},
           "nccl": ("not run: one card on this machine (NCCL holds one rank a card)" if nccl is None else
                    {"backend": nccl[0]["backend"], "devices": [r["device"] for r in nccl],
                     "losses": {name: nccl[0][name]["losses"] for name in TP_CONFIGS},
                     "step_ms": {name: nccl[0][name]["step_ms"] for name in TP_CONFIGS},
                     "allreduce_ms": nccl[0]["allreduce"]})}
    emit(res)
    checks = {
        "gloo on cuda:0": all(s["backend"] == "gloo" and s["device"] == "cuda:0" for s in steps),
        "the ranks hold model indices 0 and 1": [s["model_rank"] for s in steps] == [0, 1],
        "the ranks report the same numbers": all(s[n]["losses"] == steps[0][n]["losses"]
                                                 and s[n]["grad_norms"] == steps[0][n]["grad_norms"]
                                                 for s in steps for n in TP_CONFIGS),
        "the replicated weights bit-equal across the group": all(
            s[n]["replicated_digest"] == steps[0][n]["replicated_digest"] for s in steps for n in TP_CONFIGS),
        "finite losses": all(math.isfinite(x) for n in TP_CONFIGS for x in steps[0][n]["losses"]),
        "kernels launched as the steps need": all(s[n]["launches"] == s[n]["expected_launches"]
                                                  for s in steps for n in TP_CONFIGS),
        "trainer: straight and resumed end at the same step": all(
            t["straight"]["step"] == t["resumed"]["step"] == TP_TRAINER_STEPS for t in tr),
        "trainer: the resumed run bit-equal to the straight run": all(
            t["straight"]["digest"] == t["resumed"]["digest"] for t in tr),
        "trainer: each rank its shard": [t["straight"]["axis"] for t in tr] == [[0, 2], [1, 2]],
        "trainer: a checkpoint a step": tr[0]["checkpoints"] == [trainer_ckpt.checkpoint_name(0, i + 1)
                                                                for i in range(TP_TRAINER_STEPS)],
        "the checkpoint is whole and loads in one process": one_process["safetensors_equal"]
                                                            and one_process["generator_rows"]
                                                            == flash.model.tgt_vocab_size,
        "the one-process model's shards are the ranks' weights": all(one_process["shards_equal_the_ranks"]),
        **{f"{name}: TP step = the one-process step": diff[name]["loss_rel"] <= TP_TOL["loss_rtol"]
           and diff[name]["grad_norm_rel"] <= TP_TOL["grad_norm_rtol"] for name in TP_CONFIGS},
    }
    if nccl is not None:
        checks["NCCL: the gloo run's first losses"] = all(
            abs(nccl[0][n]["losses"][0] - first[n]["loss"]) <= TP_TOL["loss_rtol"] * abs(first[n]["loss"])
            for n in TP_CONFIGS)
    fail_unless("tp", checks)
    res["kernel_results"] = kernels
    return res


FSDP_WORLD = 2  # a 2 x 1 mesh: two data ranks, both on cuda:0 over gloo
FSDP_BATCH = TP_BATCH  # global rows a step (4 a data rank): gloo stages every collective through host memory
FSDP_STEPS = 2
FSDP_GRID = (2, 2)  # four ranks: 2 data x 2 model
FSDP_GRID_STEPS = 1
FSDP_TRAINER_STEPS = 2  # saved after 1 and 2; the resumed run takes step 2
FSDP_TIMEOUT = 480
FSDP_CONFIGS = TP_CONFIGS
FSDP_DDP_NORM_RTOL = 1e-5  # the FSDP step's grad norm against DDP's on the same ranks (another summation order)


def resting_bytes(model: torch.nn.Module, opt_state) -> dict:
    """Bytes this rank holds at rest: its parameters, Adam's mu and nu."""
    size = lambda ts: sum(t.numel() * t.element_size() for t in ts)  # noqa: E731
    return {"params": size(model.parameters()), "mu": size(opt_state.mu.values()),
            "nu": size(opt_state.nu.values())}


def fsdp_collective_ms(layout, model: torch.nn.Module) -> dict:
    """Median wall ms of a step's two FSDP collectives on this rank: the
    gather of the whole weights (`layout.gather`: pack, one all-gather,
    unpack) and the gradient reduction (`layout.reduce_grads`: one
    reduce-scatter of the data-sharded leaves, one all-reduce of the
    replicated ones), on whole-size gradients."""
    params = dict(model.named_parameters())
    shards = {k: params[k].detach() for k in layout.sharded}
    grads = {k: torch.randn(layout.whole[k], device=params[k].device) * 1e-3 for k in params}
    out = {}
    for name, fn in (("all_gather", lambda: layout.gather(shards)),
                     ("reduce_scatter", lambda: layout.reduce_grads(grads, None, None, port_step.allreduce_grads))):
        fn()
        times = []
        for _ in range(ALLREDUCE_REPS):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            fn()
            torch.cuda.synchronize()
            times.append((time.monotonic() - t0) * 1e3)
        out[name] = {"ms": statistics.median(times), "all_ms": times}
    out["mb_a_rank"] = sum(math.prod(s) for s in layout.shard_shapes.values()) * 4 / 1e6
    return out


def fsdp_rank_main(rank: int, job_path: str) -> None:
    """A rank process of the fsdp phase: torchrun's environment, the FSDP
    steps (`fsdp_rank_step`) and, when the job asks, the trainer
    (`fsdp_rank_trainer`); its results go to the job's directory as
    `rank{rank}.pt`."""
    job = torch.load(job_path, weights_only=False)
    world = job["shape"][0] * job["shape"][1]
    os.environ.update(MASTER_ADDR="127.0.0.1", RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = {"step": fsdp_rank_step(job)}
    torch.cuda.empty_cache()
    if job["trainer"]:
        res["trainer"] = fsdp_rank_trainer(job)
    torch.save(res, Path(job["dir"]) / f"rank{rank}.pt")


def fsdp_rank_step(job: dict) -> dict:
    """The job's configs on this rank: with `ddp`, one step of the DDP (or
    TP) layout on the same ranks, then `steps` FSDP steps from the same
    seeded weights on this data index's rows and keys, the launches
    counted, the peak memory, the resting bytes and the collectives timed."""
    os.environ["MASTER_PORT"] = str(job["ports"]["step"])
    device = mesh_lib.maybe_initialize_distributed(job["device"])
    try:
        n_data, n_model = job["shape"]
        fmesh = mesh_lib.make_mesh(n_data=n_data, n_model=n_model, devices=[device], fsdp=True)
        dmesh = mesh_lib.make_mesh(n_data=n_data, n_model=n_model, devices=[device]) if job["ddp"] else None
        rows = fmesh.local_rows(FSDP_BATCH)
        batch = {k: v[rows].to(device) for k, v in job["batch"].items()}
        res = {"backend": fmesh.backend, "device": str(device), "data_rank": fmesh.rank,
               "model_rank": 0 if fmesh.model is None else fmesh.model.rank, "rows": [rows.start, rows.stop]}
        for name in job["configs"]:
            cfg = load_config(TRAIN_YAMLS[name], train=True, show=False)
            keys = [k[fmesh.rank] for k in job["keys"][name]]

            def call(step, state, i, keys=keys):
                return step(state, batch, keys[i])

            r = {}
            if dmesh is not None:
                model = ADTModel(cfg.model, seed=SEED, device=device, tp=dmesh.model)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(device)
                d, (_, state) = timed_steps(model, lambda opt, mc=cfg.model: make_train_step(mc, opt, mesh=dmesh),
                                            call, 1)
                r["ddp"] = {"loss": d["losses"][0], "grad_norm": d["grad_norms"][0], "step_ms": d["step_ms"],
                            "resting_bytes": resting_bytes(model, state.opt_state),
                            "max_memory_allocated": torch.cuda.max_memory_allocated(device)}
                del model, state
                torch.cuda.empty_cache()
            model = ADTModel(cfg.model, seed=SEED, device=device, tp=fmesh.model)
            layout = fsdp_lib.shard_model_(model, fmesh)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            counters = reset_counters()
            f, (_, state) = timed_steps(model, lambda opt, mc=cfg.model: make_train_step(mc, opt, mesh=fmesh), call,
                                        job["steps"])
            f["launches"] = {k: c.launches for k, c in counters.items()}
            f["expected_launches"] = add_launches(dict.fromkeys(counters, 0), per_step(cfg.model, False), job["steps"])
            f["max_memory_allocated"] = torch.cuda.max_memory_allocated(device)
            f["resting_bytes"] = resting_bytes(model, state.opt_state)
            f["sharded_leaves"], f["leaves"] = len(layout.sharded), len(layout.whole)
            f["whole_bytes"] = 3 * sum(math.prod(s) * 4 for s in layout.whole.values())
            f["replicated_bytes"] = 3 * sum(math.prod(layout.whole[k]) * 4 for k in layout.replicated)
            del state
            f["collectives"] = fsdp_collective_ms(layout, model)
            r["fsdp"] = f
            res[name] = r
            del model
            torch.cuda.empty_cache()
        return res
    finally:
        mesh_lib.destroy()


def fsdp_rank_trainer(job: dict) -> dict:
    """This rank's part of the fsdp phase's trainer: `trainer.train` on
    TMIDT-flash with `mesh.fsdp: true` (it joins the group from torchrun's
    environment), straight for FSDP_TRAINER_STEPS steps saving every step,
    then resumed from the first save; the digests of its shards."""
    out = Path(job["dir"]) / "trainer"
    common = dict(training={"max_steps": FSDP_TRAINER_STEPS, "num_epochs": 1, "batch_size": FSDP_BATCH // FSDP_WORLD},
                  mesh={"fsdp": True}, train_data={"holdout_fraction": 0.0},
                  logging={"output_dir": str(out), "logging_steps": 1, "save_every_n_steps": 1})
    first = out / "straight" / trainer_ckpt.checkpoint_name(0, 1)
    cfgs = {"straight": load_config(TRAIN_YAMLS["flash"], show=False, experiment={"run_name": "straight"}, **common),
            "resumed": load_config(TRAIN_YAMLS["flash"], show=False, experiment={"run_name": "resumed"},
                                   checkpoint={"resume_from_checkpoint": str(first)}, **common)}
    ds = TMIDTDataset(cfgs["straight"].train_data, MidiTokenizer(cfgs["straight"].tokenizer), rows=job["tmidt_rows"])
    res = {}
    for name, c in cfgs.items():
        os.environ["MASTER_PORT"] = str(job["ports"][f"trainer_{name}"])
        run = run_trainer(c, device="cuda:0", dataset=ds)
        model = run["state"].model
        res[name] = {"losses": [r["loss"] for r in run["steps"]], "launches": run["launches"],
                     "wall_s": run["wall_s"], "step": run["state"].step, "digest": weights_digest(model),
                     "sharded_leaves": len(model.fsdp.sharded)}
        del run, model
        torch.cuda.empty_cache()
    res["checkpoints"] = sorted(p.name for p in (out / "straight").glob("checkpoint-*"))
    return res


def fsdp_inputs() -> tuple[dict, dict]:
    """The FSDP steps' batch (FSDP_BATCH random 2.56 s waves and 512-token
    rows) and each step's site keys for each data index, on the host; the
    one-process reference of each config's first step in this process: the
    same seeded weights, the global token-weighted mean over the data
    indices' rows, each half's dropout under its own keys."""
    cfgs = {name: load_config(TRAIN_YAMLS[name], train=True, show=False) for name in FSDP_CONFIGS}
    g = torch.Generator().manual_seed(SEED + 500)
    wave = torch.randn(FSDP_BATCH, cfgs["flash"].shared.chunk_samples, generator=g) * 0.3
    toks = token_batch(cfgs["flash"], g)
    batch = {"wavs": wave, **{k: v[:FSDP_BATCH] for k, v in toks.items()}}
    keys = {name: [[draw_site_keys(cfg.model, torch.Generator().manual_seed(SEED + 501 + 10 * i + d))
                    for d in range(FSDP_WORLD)] for i in range(FSDP_STEPS)] for name, cfg in cfgs.items()}
    half = FSDP_BATCH // FSDP_WORLD
    refs = {}
    for name, cfg in cfgs.items():
        model = ADTModel(cfg.model, seed=SEED, device="cuda")
        on_card = {k: v.cuda() for k, v in batch.items()}
        torch.cuda.synchronize()
        t0 = time.monotonic()
        rows = [slice(d * half, (d + 1) * half) for d in range(FSDP_WORLD)]
        parts = [model.forward_loss(on_card["wavs"][r], on_card["tokens"][r], on_card["token_lengths"][r],
                                    keys=keys[name][0][d], train=True, reduction="sum") for d, r in enumerate(rows)]
        loss = sum(s for s, _ in parts) / torch.clamp(sum(n for _, n in parts), min=1.0)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        norm = torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in grads))
        torch.cuda.synchronize()
        refs[name] = {"loss": loss.item(), "grad_norm": norm.item(), "fwd_bwd_ms": (time.monotonic() - t0) * 1e3}
        del model, grads, parts, loss
        torch.cuda.empty_cache()
    return {"batch": batch, "keys": keys}, refs


def phase_fsdp() -> dict:
    """FSDP at full width (`mesh.fsdp: true`, `parallel/fsdp.py`): the
    parameters and Adam's moments sharded over the data axis as JAX's
    `fsdp_partition_specs` shards them.

    - Two rank processes on cuda:0 over gloo (a 2 x 1 mesh) train
      TMIDT-flash (K1, K5f, K5b) and TMIDT-fused-ffn (K1, K4) for
      FSDP_STEPS steps at FSDP_BATCH global rows: the first step's loss and
      grad norm against the one-process step on the same weights, rows and
      keys (1e-3, 1e-2 relative, the tp phase's bounds), and against the
      DDP step on the same ranks (the loss bit-equal, the grad norm within
      1e-5); the ranks' numbers bit-equal; the kernels launched as the
      steps need. Per rank: resting bytes of parameters, mu and nu under
      FSDP and DDP, the peak memory, step ms, the gather's and the
      gradient reduction's ms.
    - Four rank processes (a 2 x 2 mesh, TP inside FSDP) run TMIDT-flash for
      FSDP_GRID_STEPS steps against the same one-process step.
    - `trainer.train` at `mesh.fsdp: true` in the two ranks for
      FSDP_TRAINER_STEPS steps and a run resumed from the first save,
      bit-equal; the checkpoint, written whole, loads into one process
      whose FSDP shards are the ranks' weights.
    - NCCL, one card a rank, where the machine has two cards or more (the
      steps alone); else it reports that it was not run.
    Gloo stages every collective through host memory: these are parity
    checks and resting-memory counts, not speed figures."""
    host, refs = fsdp_inputs()
    flash = load_config(TRAIN_YAMLS["flash"], show=False)
    with tempfile.TemporaryDirectory() as tmp:
        ports = {k: free_port() for k in ("step", "trainer_straight", "trainer_resumed")}
        job = {"dir": tmp, "device": "cuda:0", "ports": ports, "shape": (FSDP_WORLD, 1), "configs": FSDP_CONFIGS,
               "steps": FSDP_STEPS, "ddp": True, "trainer": True, **host,
               "tmidt_rows": tmidt_rows(3 * FSDP_BATCH, flash, SEED + 510)}
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        t0 = time.monotonic()
        ranks = run_ranks(job, fsdp_rank_main, FSDP_WORLD, FSDP_TIMEOUT)
        wall = time.monotonic() - t0
        last = Path(tmp) / "trainer" / "straight" / trainer_ckpt.checkpoint_name(0, FSDP_TRAINER_STEPS)
        whole = ADTModel(flash.model, seed=SEED + 1, device="cuda")
        trainer_ckpt.restore_checkpoint(last, whole)
        from_safetensors = read_safetensors(last / "model.safetensors")
        sd = whole.state_dict()
        dims = fsdp_lib.data_dims({k: tuple(v.shape) for k, v in sd.items()}, FSDP_WORLD)
        shard_digests = []
        for r in range(FSDP_WORLD):
            part = fsdp_lib.shard_state_dict(sd, dims, r, FSDP_WORLD)
            h = hashlib.sha256()
            for n, t in part.items():  # weights_digest's order and bytes
                h.update(n.encode())
                h.update(t.detach().cpu().numpy().tobytes())
            shard_digests.append(h.hexdigest())
        one_process = {"safetensors_equal": all(torch.equal(from_safetensors[n].cuda(), p) for n, p in sd.items()),
                       "embedding_shape": list(from_safetensors["decoder.tgt_tok_emb.embedding.weight"].shape),
                       "shards_equal_the_ranks": [shard_digests[r] == ranks[r]["trainer"]["straight"]["digest"]
                                                  for r in range(FSDP_WORLD)]}
        del whole, sd
    with tempfile.TemporaryDirectory() as tmp:
        grid_job = {**job, "dir": tmp, "shape": FSDP_GRID, "configs": ("flash",), "steps": FSDP_GRID_STEPS,
                    "ddp": False, "trainer": False, "ports": {"step": free_port()}}
        t0 = time.monotonic()
        grid = [r["step"] for r in run_ranks(grid_job, fsdp_rank_main, FSDP_GRID[0] * FSDP_GRID[1], FSDP_TIMEOUT)]
        grid_wall = time.monotonic() - t0
    nccl = None
    if torch.cuda.device_count() >= FSDP_WORLD:
        with tempfile.TemporaryDirectory() as tmp:
            nccl_job = {**job, "dir": tmp, "device": None, "ddp": False, "trainer": False,
                        "ports": {"step": free_port()}}
            nccl = [r["step"] for r in run_ranks(nccl_job, fsdp_rank_main, FSDP_WORLD, FSDP_TIMEOUT)]
    steps = [r["step"] for r in ranks]
    tr = [r["trainer"] for r in ranks]

    def rel(a, b):
        return abs(a - b) / abs(b)

    first = {n: {"loss": steps[0][n]["fsdp"]["losses"][0], "grad_norm": steps[0][n]["fsdp"]["grad_norms"][0]}
             for n in FSDP_CONFIGS}
    vs_one = {n: {"loss_rel": rel(first[n]["loss"], refs[n]["loss"]),
                  "grad_norm_rel": rel(first[n]["grad_norm"], refs[n]["grad_norm"])} for n in FSDP_CONFIGS}
    vs_ddp = {n: {"loss_equal": all(s[n]["fsdp"]["losses"][0] == s[n]["ddp"]["loss"] for s in steps),
                  "grad_norm_rel": max(rel(s[n]["fsdp"]["grad_norms"][0], s[n]["ddp"]["grad_norm"]) for s in steps)}
              for n in FSDP_CONFIGS}
    grid_first = {"loss": grid[0]["flash"]["fsdp"]["losses"][0], "grad_norm": grid[0]["flash"]["fsdp"]["grad_norms"][0]}
    grid_vs_one = {"loss_rel": rel(grid_first["loss"], refs["flash"]["loss"]),
                   "grad_norm_rel": rel(grid_first["grad_norm"], refs["flash"]["grad_norm"])}
    per_rank = {f"rank{i}": {n: {"resting_bytes": {"fsdp": s[n]["fsdp"]["resting_bytes"],
                                                   "ddp": s[n]["ddp"]["resting_bytes"]},
                                 "whole_bytes": s[n]["fsdp"]["whole_bytes"],
                                 "replicated_bytes": s[n]["fsdp"]["replicated_bytes"],
                                 "max_memory_allocated": {"fsdp": s[n]["fsdp"]["max_memory_allocated"],
                                                          "ddp": s[n]["ddp"]["max_memory_allocated"]},
                                 "step_ms": s[n]["fsdp"]["step_ms"], "ddp_step_ms": s[n]["ddp"]["step_ms"],
                                 "collectives": s[n]["fsdp"]["collectives"]}
                             for n in FSDP_CONFIGS} for i, s in enumerate(steps)}
    res = {"phase": "fsdp", "mesh": f"{FSDP_WORLD} x 1", "ranks": FSDP_WORLD, "backend": steps[0]["backend"],
           "device": steps[0]["device"], "batch": FSDP_BATCH, "tokens": TRAIN_TOKENS, "ranks_wall_s": wall,
           "sharded_leaves": {n: [steps[0][n]["fsdp"]["sharded_leaves"], steps[0][n]["fsdp"]["leaves"]]
                              for n in FSDP_CONFIGS},
           "parity": {n: {"fsdp": first[n], "one_process": refs[n], **vs_one[n], **TP_TOL,
                          "vs_ddp": {**vs_ddp[n], "grad_norm_rtol": FSDP_DDP_NORM_RTOL}} for n in FSDP_CONFIGS},
           "losses": {n: steps[0][n]["fsdp"]["losses"] for n in FSDP_CONFIGS}, "per_rank": per_rank,
           "launches": {f"rank{i}": {n: s[n]["fsdp"]["launches"] for n in FSDP_CONFIGS} for i, s in enumerate(steps)},
           "grid_2x2": {"ranks_wall_s": grid_wall, "first": grid_first, **grid_vs_one,
                        "losses": grid[0]["flash"]["fsdp"]["losses"],
                        "step_ms": {f"rank{i}": g["flash"]["fsdp"]["step_ms"] for i, g in enumerate(grid)},
                        "resting_bytes": {f"rank{i}": g["flash"]["fsdp"]["resting_bytes"] for i, g in enumerate(grid)},
                        "launches": {f"rank{i}": g["flash"]["fsdp"]["launches"] for i, g in enumerate(grid)}},
           "trainer": {"losses": tr[0]["straight"]["losses"], "resumed_losses": tr[0]["resumed"]["losses"],
                       "checkpoints": tr[0]["checkpoints"], "wall_s": [t["straight"]["wall_s"] for t in tr],
                       "launches": {f"rank{i}": {k: t[k]["launches"] for k in ("straight", "resumed")}
                                    for i, t in enumerate(tr)},
                       "one_process_restore": one_process},
           "nccl": ("not run: one card on this machine (NCCL holds one rank a card)" if nccl is None else
                    {"backend": nccl[0]["backend"], "devices": [r["device"] for r in nccl],
                     "losses": {n: nccl[0][n]["fsdp"]["losses"] for n in FSDP_CONFIGS},
                     "step_ms": {n: nccl[0][n]["fsdp"]["step_ms"] for n in FSDP_CONFIGS},
                     "collectives": {n: nccl[0][n]["fsdp"]["collectives"] for n in FSDP_CONFIGS}})}
    emit(res)

    def within_resting(s, n):
        f = s[n]["fsdp"]
        held = sum(f["resting_bytes"].values())
        return held <= (f["whole_bytes"] - f["replicated_bytes"]) / FSDP_WORLD + f["replicated_bytes"] \
            and held < sum(s[n]["ddp"]["resting_bytes"].values())

    checks = {
        "gloo on cuda:0": all(s["backend"] == "gloo" and s["device"] == "cuda:0" for s in steps + grid),
        "the ranks hold data indices 0 and 1": [s["data_rank"] for s in steps] == [0, 1],
        "the 2 x 2 grid's places": [(g["data_rank"], g["model_rank"]) for g in grid] == [(0, 0), (0, 1), (1, 0),
                                                                                         (1, 1)],
        "the ranks report the same numbers": all(s[n]["fsdp"]["losses"] == steps[0][n]["fsdp"]["losses"]
                                                 and s[n]["fsdp"]["grad_norms"] == steps[0][n]["fsdp"]["grad_norms"]
                                                 for s in steps for n in FSDP_CONFIGS),
        "finite losses": all(math.isfinite(x) for n in FSDP_CONFIGS for x in steps[0][n]["fsdp"]["losses"]),
        "kernels launched as the steps need": all(s[n]["fsdp"]["launches"] == s[n]["fsdp"]["expected_launches"]
                                                  for s in steps for n in FSDP_CONFIGS)
                                              and all(g["flash"]["fsdp"]["launches"]
                                                      == g["flash"]["fsdp"]["expected_launches"] for g in grid),
        "resting bytes at most 1/n_data of the whole plus the replicated leaves, below DDP's": all(
            within_resting(s, n) for s in steps for n in FSDP_CONFIGS),
        **{f"{n}: FSDP step = the one-process step": vs_one[n]["loss_rel"] <= TP_TOL["loss_rtol"]
           and vs_one[n]["grad_norm_rel"] <= TP_TOL["grad_norm_rtol"] for n in FSDP_CONFIGS},
        **{f"{n}: FSDP's first loss bit-equal to DDP's, the grad norm within 1e-5": vs_ddp[n]["loss_equal"]
           and vs_ddp[n]["grad_norm_rel"] <= FSDP_DDP_NORM_RTOL for n in FSDP_CONFIGS},
        "2 x 2: the step = the one-process step": grid_vs_one["loss_rel"] <= TP_TOL["loss_rtol"]
                                                 and grid_vs_one["grad_norm_rel"] <= TP_TOL["grad_norm_rtol"],
        "2 x 2: the ranks report the same losses": all(g["flash"]["fsdp"]["losses"] == grid[0]["flash"]["fsdp"]["losses"]
                                                       for g in grid),
        "trainer: straight and resumed end at the same step": all(
            t["straight"]["step"] == t["resumed"]["step"] == FSDP_TRAINER_STEPS for t in tr),
        "trainer: the resumed run bit-equal to the straight run": all(
            t["straight"]["digest"] == t["resumed"]["digest"] for t in tr),
        "trainer: the parameters sharded": all(t["straight"]["sharded_leaves"] > 0 for t in tr),
        "trainer: a checkpoint a step": tr[0]["checkpoints"] == [trainer_ckpt.checkpoint_name(0, i + 1)
                                                                for i in range(FSDP_TRAINER_STEPS)],
        "the checkpoint is whole and loads in one process": one_process["safetensors_equal"]
                                                            and one_process["embedding_shape"]
                                                            == [flash.model.tgt_vocab_size, flash.model.d_model],
        "the one-process model's FSDP shards are the ranks' weights": all(one_process["shards_equal_the_ranks"]),
    }
    if nccl is not None:
        checks["NCCL: the gloo run's first losses"] = all(
            rel(nccl[0][n]["fsdp"]["losses"][0], first[n]["loss"]) <= TP_TOL["loss_rtol"] for n in FSDP_CONFIGS)
    fail_unless("fsdp", checks)
    return res


YOUTUBE_SEC = 30.0
YOUTUBE_HOP_SEC = 1.28
YOUTUBE_ALONE = 2  # chunks decoded alone against their batch rows (a depth cut for the smoke's time)
YOUTUBE_SR = 44_100  # the WAV's own rate: the demo resamples it to the config's


def drum_wave(seconds: float, sr: int, seed: int) -> np.ndarray:
    """Seeded drum-like audio: decaying noise bursts (kick-like low, snare-
    and hat-like bright) on a jittered 8th-note grid at 120 bpm."""
    rng = np.random.default_rng(seed)
    wave = np.zeros(int(seconds * sr), np.float32)
    t = np.arange(int(0.3 * sr)) / sr
    shapes = [np.sin(2 * np.pi * 60 * t) * np.exp(-t / 0.08), rng.normal(size=t.size) * np.exp(-t / 0.05),
              rng.normal(size=t.size) * np.exp(-t / 0.015)]
    grid = np.arange(0.0, seconds - 0.3, 0.25)
    for onset in grid + rng.uniform(0, 0.01, grid.size):
        k = int(rng.integers(0, 3))
        start = int(onset * sr)
        wave[start : start + t.size] += (shapes[k] * rng.uniform(0.3, 1.0)).astype(np.float32)
    return wave / np.abs(wave).max() * 0.8


def phase_youtube() -> dict:
    """The demo CLI (`python -m adt_str_tpu_torch.scripts.youtube_drum_pipeline`)
    on the card in a subprocess: 30 s of seeded drum-like audio at 44.1 kHz,
    `--skip-demucs`, the serving config (K1, K5f) and a seeded checkpoint
    written by the port's safetensors writer; once plain and once with a
    1.28 s hop: wall s, chunks, notes, files written. In this process the
    same chunks in one batch (K1, K5f launched once, at the encoder's
    layers) against its first YOUTUBE_ALONE chunks decoded alone by `greedy_decode`: equal
    tokens; the CLI's note count against this process's; `--url` without
    yt-dlp must fail naming it; a one-hot multi-hot `decode_logits` on the
    card against the id path (bf16: the one-hot product selects one
    embedding row exactly, so within 1e-2 of the logits' largest, reported
    with whether bit-equal)."""
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "ckpt").mkdir()
        cfg = load_config(SERVING_YAML, inference={"checkpoint_path": str(tmp / "ckpt")})
        model = ADTModel(cfg.model, seed=SEED + 90, device="cuda").eval()
        write_safetensors(model.state_dict(), tmp / "ckpt" / "model.safetensors")
        write_wav(tmp / "song.wav", drum_wave(YOUTUBE_SEC, YOUTUBE_SR, SEED + 91), YOUTUBE_SR)
        raw = cfg.raw
        (tmp / "cfg.yaml").write_text(yaml_text({
            "shared": raw["shared"], "tokenizer": raw["tokenizer"], "model": raw["model"],
            "inference": {**raw["inference"], "checkpoint_path": str(tmp / "ckpt")}}))
        cli = {}
        for name, hop in (("plain", []), ("hop", ["--hop-sec", str(YOUTUBE_HOP_SEC)])):
            out = tmp / name
            proc, secs = run_cli(["-m", "adt_str_tpu_torch.scripts.youtube_drum_pipeline", "--input-audio",
                                  str(tmp / "song.wav"), "--config", str(tmp / "cfg.yaml"), "--output-dir", str(out),
                                  "--skip-demucs", *hop])
            said = [ln for ln in proc.stdout.splitlines() if ln.startswith("Transcribed ")]
            cli[name] = {"wall_s": secs, "notes": int(said[0].split()[1]) if said else None,
                         "files": {p.name: p.stat().st_size for p in sorted(out.iterdir())}}
        empty_bin = tmp / "bin"
        empty_bin.mkdir()
        url = subprocess.run([sys.executable, "-m", "adt_str_tpu_torch.scripts.youtube_drum_pipeline", "--url",
                              "video-id-placeholder", "--config", str(tmp / "cfg.yaml"), "--output-dir",
                              str(tmp / "url")], cwd=REPO, capture_output=True, text=True, timeout=300,
                             env={**os.environ, "PATH": str(empty_bin)})
        wav = normalize(load_and_resample(tmp / "song.wav", cfg.shared.sample_rate))
    tokenizer = MidiTokenizer(cfg.tokenizer)
    in_process = {}
    for name, hop in (("plain", None), ("hop", YOUTUBE_HOP_SEC)):
        starts, chunks = youtube_demo.chunk_batch(cfg, wav, hop)
        torch.cuda.synchronize()
        counters = reset_counters()
        t0 = time.monotonic()
        tokens = youtube_demo.decode_chunks(model, cfg, tokenizer, chunks, "cuda")
        batch_s = time.monotonic() - t0
        launches = {k: c.launches for k, c in counters.items()}
        notes = youtube_demo.run_model_on_chunks(model, cfg, tokenizer, wav, hop_sec=hop, device="cuda")
        in_process[name] = {"chunks": len(starts), "batch_decode_s": batch_s, "launches": launches,
                            "notes": len(notes), "tokens": tokens}
    kw = dict(max_length=int(cfg.inference.max_length), start_token=tokenizer.BOS_token,
              end_token=tokenizer.EOS_token)
    _, chunks = youtube_demo.chunk_batch(cfg, wav, None)
    alone = np.stack([greedy_decode(model, torch.from_numpy(c[None]).cuda(), **kw).cpu().numpy()[0]
                      for c in chunks[:YOUTUBE_ALONE]])
    batch_tokens = in_process["plain"].pop("tokens")
    in_process["hop"].pop("tokens")
    differing = [i for i in range(len(alone)) if not np.array_equal(alone[i], batch_tokens[i])]
    # multi-hot rows on the card: one-hot rows of the id path's tokens
    ids = torch.from_numpy(batch_tokens[:4, :64].astype(np.int64)).cuda()
    with torch.no_grad():
        memory = model.encode(torch.from_numpy(chunks[:4]).cuda())
        by_ids = model.decode_logits(ids, memory).float()
        hot = torch.nn.functional.one_hot(ids, cfg.model.tgt_vocab_size).to(model.compute_dtype)
        by_rows = model.decode_logits(hot, memory).float()
    multi_err = float((by_rows - by_ids).abs().max())
    multi_tol = 1e-2 * float(by_ids.abs().max())
    res = {"phase": "youtube", "config": SERVING_YAML, "audio_s": YOUTUBE_SEC, "wav_sr": YOUTUBE_SR,
           "hop_sec": YOUTUBE_HOP_SEC, "cli": cli, "in_process": in_process,
           "chunks_alone_equal_the_batch": {"chunks": len(alone), "of": len(chunks), "differing_rows": differing},
           "url_without_yt_dlp": {"exit": url.returncode, "said": (url.stderr.strip().splitlines() or [""])[-1]},
           "multi_hot": {"rows": list(hot.shape), "dtype": str(model.compute_dtype), "max_abs_err": multi_err,
                         "tol": multi_tol, "bit_equal": bool(torch.equal(by_rows, by_ids))}}
    emit(res)
    n_layers = cfg.model.enc_layers
    checks = {
        "the CLI wrote the MIDI and the preview WAV": all(
            c["files"].get("predicted_drums.mid", 0) > 22 and c["files"].get("synthesized_drums.wav", 0) > 44
            for c in cli.values()),
        "the CLI's notes = this process's": all(cli[n]["notes"] == in_process[n]["notes"] for n in cli),
        f"the first {YOUTUBE_ALONE} chunks decoded alone = their rows of the batch": not differing,
        "K1 once and K5f once an encoder layer, per batch": all(
            p["launches"]["log_mel"] == 1 and p["launches"]["fused_attention"] == n_layers
            for p in in_process.values()),
        "--url without yt-dlp fails naming it": url.returncode != 0 and "yt-dlp not found" in url.stderr,
        "one-hot multi-hot logits = the id path's": multi_err <= multi_tol,
    }
    fail_unless("youtube", checks)
    del model
    torch.cuda.empty_cache()
    return res



# ------------------------------------------- the kernels' domain (fp32, long keys, any hop)

FP32 = {"compute_dtype": "float32"}
FP32_STEPS = 3
FP32_TOL = {"loss_rtol": 1e-5, "grad_norm_rtol": 1e-4}  # every fp32 step against the plain fp32 step
TIE_TOL = 1e-4  # fp32 logits whose top two lie closer may take either token in another summation order
# bf16 logits are rounded to 8 significant bits: a top two within 4 bf16 ulps of the top (2^-5 of it) is a
# tie at bf16 rounding, which the kernel and plain paths' other rounding points may break either way
BF16_TIE_REL = 2.0**-5
LONG_SEC = 10.24  # 1 + 245,760 // 240 - 11 = 1,014 encoder frames
LONG_TOKENS = 1024
LONG_STEPS = 3
LONG_REQUEST_SEC = 30.0
LONG = {"shared": {"input_sec": LONG_SEC}}
SR_44K1 = 44_100  # hop int(0.01 * 44100) = 441: K1's any_hop route
LONG_HOP = {"sample_rate": 48_000, "time_res": 0.02}  # hop 960: a window past shared memory, K1's long_hop route
PAST_OLD_LIMIT = (896, 1024, 2048)  # K5 head dims past the card's old limit of 768
# the tensor-core kernels past 512 keys (the fp32 rows take `TRAIN_ATTENTION`'s shapes)
LONG_ATTENTION = {"encoder-1014": (1014, 1014, False), "decoder-self-1023": (1023, 1023, True),
                  "cross-1023x1014": (1023, 1014, False)}


def phase_training_fp32(name: str) -> dict:
    """FP32_STEPS steps of a TMIDT config at `compute_dtype: float32` (64 x
    512 tokens): K5f and K5b in 3xTF32 (flash) or K4 in 3xTF32 (fused-ffn),
    every step against the plain fp32 path (TF32 off).

    The ruling on fp32 kernel paths: the held check is the lockstep step at
    FP32_TOL, each plain step from a copy of the kernel path's weights
    before its step. Step 1 of the kernel path's own trajectory is that
    lockstep step (the same weights), so it is held too; steps 2 and later
    of the own trajectory are printed beside them, not held: fp32 SDPA, the
    plain path with its products summed in two fp32 halves and the plain
    path with emulated 3xTF32 products all part from the plain trajectory
    past FP32_TOL by step 2-3 (`--fp32-drift`; H100 80GB HBM3, 700 W), so
    holding those steps holds the products to cuBLAS's rounding, not to
    fp32's accuracy. flash runs in that form. fused-ffn keeps its separate
    trajectories, every step held, while they pass."""
    flash = name == "flash"
    return phase_training(name, f"training-fp32-{name}", FP32_STEPS, tol=FP32_TOL, plain_steps=FP32_STEPS,
                          lockstep=flash, trajectory=flash, model=FP32)


def phase_training_long() -> dict:
    """TMIDT-flash at `input_sec: 10.24` and 1,024 tokens (K5f and K5b on
    1,014 and 1,023 keys: encoder, decoder self, cross), LONG_STEPS steps at
    batch 64, held as the bf16 training phases are."""
    return phase_training("flash", "training-long-flash", LONG_STEPS, LONG_TOKENS, **LONG)


def tokens_vs_plain(model: ADTModel, cfg: FrameworkConfig, chunks: torch.Tensor) -> dict:
    """Greedy tokens of `chunks` through the kernels against the plain path
    on the card. A row that differs is reported with its first differing
    step, the plain path's top two logits there (the prefix through
    `decode_logits`) and the largest difference of the two paths' logits
    there; `ok` unless such a top two lie further apart than a tie: TIE_TOL
    in fp32, BF16_TIE_REL of the top logit in bf16."""
    bos, eos, length = cfg.tokenizer.BOS_token, cfg.tokenizer.EOS_token, cfg.inference.max_length
    fp32 = model.compute_dtype == torch.float32

    def last_logits(tokens, r, step):
        memory = model.encode(chunks[r : r + 1])
        mask = T.causal_mask_additive(step, device=chunks.device)
        return model.decode_logits(tokens[r : r + 1, :step].long(), memory, mask)[0, -1].float()

    with torch.inference_mode():
        got = greedy_decode(model, chunks, length, bos, eos)
        with plain_kernels():
            ref = greedy_decode(model, chunks, length, bos, eos)
        rows = []
        for r in (got != ref).any(dim=1).nonzero().flatten().tolist():
            step = int((got[r] != ref[r]).nonzero()[0])
            with plain_kernels():
                plain = last_logits(ref, r, step)
            kernel = last_logits(ref, r, step)
            top = torch.topk(plain, 2).values
            tol = TIE_TOL if fp32 else BF16_TIE_REL * abs(float(top[0]))
            rows.append({"row": r, "first_step": step, "top2": top.tolist(), "top2_gap": float(top[0] - top[1]),
                         "tie_tol": tol, "paths_logit_max_diff": float((kernel - plain).abs().max())})
    return {"rows": int(chunks.shape[0]), "longest_row": int((ref != eos).sum(dim=1).max()),
            "rows_equal": int(chunks.shape[0]) - len(rows), "differing": rows,
            "ok": all(x["top2_gap"] <= x["tie_tol"] for x in rows)}


def phase_serving_variant(label: str, cfg: FrameworkConfig, required: tuple, seconds: float = REQUEST_SEC,
                          hold_tokens: bool = True) -> dict:
    """The serving path at a config the shipped YAML does not take through
    these kernels: N_REQUESTS concurrent requests of `seconds` through the
    HTTP server (the `required` kernel variants must launch); on the same
    chunks, K1 against its plain version (1e-4), the encoder memory against
    the plain path (`memory_error`) and the greedy tokens against the plain
    path's (`tokens_vs_plain`; held with `hold_tokens`, else reported)."""
    model = ADTModel(cfg.model, seed=SEED, device="cuda")
    chunk = cfg.shared.chunk_samples
    chunks = torch.from_numpy(np.stack([c for w in request_waves(cfg, seconds) for _, c, _ in chunk_wave(w, chunk)]))
    chunks = chunks.cuda()
    params = mel_params(cfg.model)
    mel_err = (cuda_mel.log_mel(chunks, params) - cuda_mel.log_mel_plain(chunks, params)).abs().max().item()
    with torch.inference_mode():
        mem = model.encode(chunks)
        with plain_kernels():
            ref = model.encode(chunks)
    res = {"phase": label, "compute_dtype": cfg.model.compute_dtype, "sample_rate": cfg.shared.sample_rate,
           "hop": params.hop_length, "mel_route": cuda_mel.frames_route(params), "input_sec": cfg.shared.input_sec,
           "encoder_frames": int(mem.shape[1]), "max_length": cfg.inference.max_length, "requests": N_REQUESTS,
           "request_sec": seconds, "chunks": int(chunks.shape[0]), "log_mel_max_abs_err": mel_err,
           "log_mel_tol": 1e-4, "memory_vs_plain": memory_error(mem, ref)}
    res["tokens_vs_plain"] = tokens_vs_plain(model, cfg, chunks)
    res["tokens_held"] = hold_tokens
    del mem, ref
    results, wall, launches, stats = serve_requests(build_engine(cfg, model), cfg, seconds=seconds, required=required)
    res.update(wall_s=round(wall, 3), request_s=[round(r[2], 3) for r in results],
               n_notes=[json.loads(r[1])["n_notes"] for r in results], launches=launches, engine_stats=stats)
    emit(res)
    if not (mel_err <= 1e-4 and res["memory_vs_plain"]["ok"] and (res["tokens_vs_plain"]["ok"] or not hold_tokens)):
        raise RuntimeError(f"{label}: the kernel path disagrees with the plain path")
    return res


def phase_domain_kernels(gen) -> dict:
    """The new kernel variants against their plain versions and timed, at
    the shapes the domain phases give them."""
    mel = {}
    for sr, tr, batch in ((SR_44K1, 0.01, 16), (22_050, 0.01, 16), (48_000, 0.02, 16)):
        params = MelFrontendParams(sample_rate=sr, win_length=2048, hop_length=int(tr * sr), n_mels=128)
        mel[f"{sr}-hop{params.hop_length}"] = phase_mel(params, batch, gen)
    att = {}
    for s, (tq, tk, causal) in TRAIN_ATTENTION.items():
        att[f"fp32-{s}"] = {"fwd": phase_attention(TRAIN_BATCH, tq, tk, causal, gen, f"fp32 {s}", dtype=torch.float32),
                            "bwd": phase_attention_bwd(TRAIN_BATCH, tq, tk, causal, gen, f"fp32 {s}",
                                                       dtype=torch.float32)}
    # head dim 256 (3 heads at d 768): bf16 and fp16 on the tensor cores, fp32 in 3xTF32
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        key = f"{str(dtype)[6:]}-d256-decoder-self"
        att[key] = {"fwd": phase_attention(TRAIN_BATCH, 511, 511, True, gen, key, 3, 256, dtype),
                    "bwd": phase_attention_bwd(TRAIN_BATCH, 511, 511, True, gen, key, 3, 256, dtype)}
    # fp16 at head dim 128 (the tensor-core kernels)
    for s, (tq, tk, causal) in TRAIN_ATTENTION.items():
        att[f"float16-{s}"] = {"fwd": phase_attention(TRAIN_BATCH, tq, tk, causal, gen, f"fp16 {s}",
                                                      dtype=torch.float16),
                               "bwd": phase_attention_bwd(TRAIN_BATCH, tq, tk, causal, gen, f"fp16 {s}",
                                                          dtype=torch.float16)}
    # past head dim 256 on the wide tensor-core kernels: 2 heads of 384 (the 2-head training shape) in bf16
    # and fp16, the serving encoder at 2 heads of 384 and 1 of 768, 512 and 640, and past the old limit of
    # 768 (896, 1,024, 2,048; fp32 there in 3xTF32, 7-16 column chunks) at a small batch
    for dtype in (torch.bfloat16, torch.float16):
        key = f"{str(dtype)[6:]}-d384-decoder-self"
        att[key] = {"fwd": phase_attention(TRAIN_BATCH, 511, 511, True, gen, key, 2, 384, dtype),
                    "bwd": phase_attention_bwd(TRAIN_BATCH, 511, 511, True, gen, key, 2, 384, dtype)}
    att["bfloat16-d384-encoder-serving"] = {
        "fwd": phase_attention(16, 246, 246, False, gen, "bf16 d384 encoder, B 16", 2, 384, torch.bfloat16)}
    att["float16-d768-encoder-serving"] = {
        "fwd": phase_attention(16, 246, 246, False, gen, "fp16 d768 encoder, B 16", 1, 768, torch.float16)}
    for D in (512, 640):
        key = f"bfloat16-d{D}-decoder-self-b16"
        att[key] = {"fwd": phase_attention(16, 511, 511, True, gen, key, 2, D, torch.bfloat16),
                    "bwd": phase_attention_bwd(16, 511, 511, True, gen, key, 2, D, torch.bfloat16)}
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        for D in PAST_OLD_LIMIT:
            key = f"{str(dtype)[6:]}-d{D}-b2"
            att[key] = {"fwd": phase_attention(2, 256, 256, True, gen, key, 1, D, dtype),
                        "bwd": phase_attention_bwd(2, 256, 256, True, gen, key, 1, D, dtype)}
    for s, (tq, tk, causal) in LONG_ATTENTION.items():
        att[f"bf16-{s}"] = {"fwd": phase_attention(TRAIN_BATCH, tq, tk, causal, gen, f"bf16 {s}"),
                            "bwd": phase_attention_bwd(TRAIN_BATCH, tq, tk, causal, gen, f"bf16 {s}")}
    att["bf16-encoder-1014-serving"] = {"fwd": phase_attention(4, 1014, 1014, False, gen, "bf16 encoder 1014, B 4")}
    ffn32 = {s: phase_ffn(rows, gen, f"fp32 {s}", dtype=torch.float32) for s, rows in TRAIN_FFN_ROWS.items()}
    rows = TRAIN_FFN_ROWS["decoder"]
    # fp16, and widths of the hidden off 128 (1000) and off 8 (1036): padded with zeros in the wrapper
    ffn16 = {"fp16": phase_ffn(rows, gen, "fp16 decoder", dtype=torch.float16),
             "bf16-d_ff1000": phase_ffn(rows, gen, "bf16 decoder, d_ff 1000", d_ff=1000),
             "fp16-d_ff1036": phase_ffn(rows, gen, "fp16 decoder, d_ff 1036", d_ff=1036, dtype=torch.float16),
             "fp32-d_ff1036": phase_ffn(rows, gen, "fp32 decoder, d_ff 1036", d_ff=1036, dtype=torch.float32)}
    return {"mel": mel, "attention": att, "ffn": ffn32, "ffn_more": ffn16}


def phase_repairs_fp16(gen, cfg: FrameworkConfig) -> dict:
    """The batch-invariance kernels at fp16 at the serving bucket's decode
    step (as `phase_repairs` at bf16), and attention_rows past head dim 256
    (2 heads of 384: the split-key design) at bf16 and fp16."""
    bucket, L, S = main_path_bucket(cfg), cfg.inference.max_length, 246
    f16 = torch.float16
    return {
        "layer_norm": phase_layer_norm(gen, bucket, f"fp16 decode step, bucket {bucket}", dtype=f16),
        "add_layer_norm": phase_add_layer_norm(gen, bucket, f"fp16 decode step, bucket {bucket}", dtype=f16),
        "linear": phase_linear(gen, bucket, 3072, 768, f"fp16 decode FFN linear1, bucket {bucket}", dtype=f16),
        "attention_rows": phase_attention_rows(gen, bucket, 1, L, L // 2, f"fp16 decode self, bucket {bucket}",
                                               dtype=f16),
        "attention_rows_d384": phase_attention_rows(gen, bucket, 1, L, L // 2,
                                                    f"bf16 decode self, 2 heads of 384, bucket {bucket}",
                                                    heads=2, hd=384),
        "attention_rows_d384_cross_fp16": phase_attention_rows(gen, bucket, 1, S, None,
                                                               f"fp16 decode cross, 2 heads of 384, bucket {bucket}",
                                                               dtype=f16, heads=2, hd=384),
    }


# the fp32 decode step's products (models/decode.py, models/transformer.py): key: (what, N, K)
FP32_PRODUCTS = {"decode": ("FFN linear1", 3072, 768), "decode_ffn2": ("FFN linear2", 768, 3072),
                 "decode_in_projection": ("self in-projection", 2304, 768),
                 "decode_projection": ("768 -> 768 projection", 768, 768),
                 "decode_generator": ("generator", 1400, 768)}


def phase_repairs_fp32(gen, cfg: FrameworkConfig) -> dict:
    """The batch-invariance kernels at fp32 at the serving bucket's decode
    step (the fp32 serving config's widths: d 768, 6 heads of 128): the
    fused LayerNorm, every product of the step (`FP32_PRODUCTS`: FFN 1 as
    `decode`, each within 1e-5 of fp64, rows bit-equal at 1-64) and the
    beam's in-projection at 5 rows an item (1-16 items), and attention_rows'
    split-key design over the self cache (masked, and the valid keys alone)
    and the cross rows, greedy and beam's 5 rows an item."""
    bucket, L, S, f32 = main_path_bucket(cfg), cfg.inference.max_length, 246, torch.float32
    linear = {key: phase_linear(gen, bucket, n, k, f"fp32 decode {what}, bucket {bucket}", dtype=f32)
              for key, (what, n, k) in FP32_PRODUCTS.items()}
    linear["beam"] = phase_linear(gen, bucket * BEAM_SIZE, 2304, 768,
                                  f"fp32 beam in-projection, {bucket} items x {BEAM_SIZE}", counts=(1, 2, 8, 16),
                                  rows_per=BEAM_SIZE, dtype=f32)
    return {
        "add_layer_norm": phase_add_layer_norm(gen, bucket, f"fp32 decode step, bucket {bucket}", dtype=f32),
        "linear": linear,
        "attention_rows_self": phase_attention_rows(gen, bucket, 1, L, L // 2, f"fp32 decode self, bucket {bucket}",
                                                    dtype=f32),
        "attention_rows_cross": phase_attention_rows(gen, bucket, 1, S, None, f"fp32 decode cross, bucket {bucket}",
                                                     dtype=f32),
        "attention_rows_beam_cross": phase_attention_rows(gen, bucket, BEAM_SIZE, S, None,
                                                          f"fp32 beam cross, {bucket} items x {BEAM_SIZE}", dtype=f32,
                                                          counts=(1, 2, 8, 16)),
    }


FP16 = {"compute_dtype": "float16"}
THREE_HEADS = {"nhead": 3, "d_query": 256}  # d 768 at head dim 256: the head-dim-256 tensor-core K5
TWO_HEADS = {"nhead": 2, "d_query": 384}  # d 768 at head dim 384: the wide tensor-core K5 and attention_rows
WIDE_D = 2048  # d 2,048 at 1 head: K5 past head dim 768, LayerNorm and attention_rows past 1,024
ONE_WIDE_HEAD = {"nhead": 1, "d_query": WIDE_D}
VARIANT_STEPS = 3


def phase_training_variant(name: str, label: str, model: dict) -> dict:
    """VARIANT_STEPS steps of a TMIDT config with `model` overrides (64 x 512
    tokens), every step held at the bf16 rule (PARITY_TOL) to the plain
    path's step from the same weights (`lockstep`), and the variant's
    kernels launched as the step needs."""
    return phase_training(name, label, VARIANT_STEPS, plain_steps=VARIANT_STEPS, lockstep=True,
                          model=model)


def greedy_alone_vs_batch(cfg: FrameworkConfig, batches: tuple = (16,), seed: int = SEED + 81) -> dict:
    """INVARIANCE_CHUNKS chunks decoded alone (bucket 1) and in batches of
    each of `batches` (`greedy_batches`) at `cfg` (seeded weights and
    chunks), INVARIANCE_TOKENS tokens: the tokens must be bit-equal."""
    model = ADTModel(cfg.model, seed=SEED, device="cuda")
    n, L = INVARIANCE_CHUNKS, min(cfg.inference.max_length, INVARIANCE_TOKENS)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    pool = torch.randn(n + max(batches), cfg.shared.chunk_samples, generator=gen, device="cuda") * 0.3
    counters = reset_counters()
    with torch.inference_mode():
        alone, greedy = greedy_batches(model, pool[:n], pool[n:], L, batches)
    launches = {k: c.launches for k, c in counters.items()}
    del model
    torch.cuda.empty_cache()
    return {"chunks": n, "batches": greedy, "equal": all(g["equal"] for g in greedy.values()),
            "tokens_before_eos": int((alone != cfg.tokenizer.EOS_token).sum().item()), "launches": launches}


def phase_fp16_and_wide_heads(gen) -> dict:
    """The paths that run the fp16 and wide-head variants at full width: 3
    TMIDT-flash steps at 3 heads of 256 (bf16: the head-dim-256
    tensor-core K5f and K5b) and at 2 heads of 384 (the wide tensor-core
    K5f and K5b); 3 steps each of TMIDT-flash and TMIDT-fused-ffn at fp16
    (K5 and K4 at fp16; every step held as `run_training` holds fp16 in
    lockstep); the serving config at fp16 and at 2 heads of 384 (3 x 10 s
    requests each, tokens held to the plain path's), and at each 4 chunks
    decoded alone and in a batch of 16, bit-equal."""
    t0 = time.monotonic()
    training = {"flash-3heads": phase_training_variant("flash", "training-3heads-flash", THREE_HEADS),
                "flash-2heads": phase_training_variant("flash", "training-2heads-flash", TWO_HEADS),
                **{f"{c}-fp16": phase_training_variant(c, f"training-fp16-{c}", FP16) for c in TRAIN_YAMLS}}
    fp16_cfg = load_config(SERVING_YAML, model=FP16)
    two_cfg = load_config(SERVING_YAML, model=TWO_HEADS)
    serving = {"fp16": phase_serving_variant("serving-fp16", fp16_cfg, ("log_mel", "fused_attention")),
               "2heads": phase_serving_variant("serving-2heads", two_cfg, ("log_mel", "fused_attention_wide"))}
    invariance = {"fp16": greedy_alone_vs_batch(fp16_cfg), "2heads": greedy_alone_vs_batch(two_cfg)}
    kept = ("losses", "grad_norms", "vs_plain_each_step", "launches", "median_step_ms")
    res = {"phase": "fp16_and_wide_heads", "training": {k: {f: v[f] for f in kept} for k, v in training.items()},
           "invariance": invariance, "wall_s": time.monotonic() - t0}
    emit(res)
    fail_unless("fp16_and_wide_heads", {
        **{f"{k}: {INVARIANCE_CHUNKS} chunks alone = in a batch of 16": v["equal"] for k, v in invariance.items()},
        "fp16: K1, K5f and the repair kernels launched": all(
            invariance["fp16"]["launches"][k] for k in ("log_mel", "fused_attention", *repair_kernels())),
        "2 heads: K1, the wide tensor-core K5f and the repair kernels launched": all(
            invariance["2heads"]["launches"][k] for k in ("log_mel", "fused_attention_wide",
                                                           *repair_kernels(two_cfg))),
        "2 heads: the fp32 K5 not launched": not (invariance["2heads"]["launches"]["fused_attention_tf32"]
                                                   or training["flash-2heads"]["launches"]["fused_attention_tf32"]),
        "2-head training: the wide K5f and K5b launched 36 times each": all(
            training["flash-2heads"]["launches"][k] == 36 for k in ("fused_attention_wide",
                                                                     "fused_attention_bwd_wide")),
    })
    return {"training": training, "serving": serving, "invariance": invariance}


def phase_wide_widths(gen, cfg: FrameworkConfig) -> dict:
    """The widths past the card's old limits, end to end: LayerNorm, the
    fused add and attention_rows at d / head dim 2,048 against their plain
    versions (rows bit-equal at 1-64) and timed at the serving bucket's
    decode step; then the serving config at d_model 2,048 with 1 head of
    2,048 (4 + 4 layers, seeded weights): 3 x 10 s requests through the
    HTTP server (K1 and the wide K5f launched; encoder memory and greedy
    tokens held to the plain path's, ties aside), and 4 chunks decoded
    alone and in a batch of 16, bit-equal, with K5f wide, LayerNorm (past
    1,024) and attention_rows (past 1,024) launched."""
    t0 = time.monotonic()
    bucket, L, S = main_path_bucket(cfg), cfg.inference.max_length, 246
    kernels = {
        "layer_norm": phase_layer_norm(gen, bucket, f"decode step at d {WIDE_D}, bucket {bucket}", d=WIDE_D),
        "add_layer_norm": phase_add_layer_norm(gen, bucket, f"decode step at d {WIDE_D}, bucket {bucket}",
                                               d=WIDE_D),
        "attention_rows_self": phase_attention_rows(gen, bucket, 1, L, L // 2,
                                                    f"bf16 decode self, 1 head of {WIDE_D}, bucket {bucket}",
                                                    heads=1, hd=WIDE_D),
        "attention_rows_cross_fp16": phase_attention_rows(gen, bucket, 1, S, None,
                                                          f"fp16 decode cross, 1 head of {WIDE_D}, bucket {bucket}",
                                                          dtype=torch.float16, heads=1, hd=WIDE_D),
    }
    wide_cfg = load_config(SERVING_YAML, model=ONE_WIDE_HEAD)
    serving = phase_serving_variant("serving-d2048", wide_cfg, ("log_mel", "fused_attention_wide"))
    invariance = greedy_alone_vs_batch(wide_cfg)
    res = {"phase": "wide_widths", "d_model": wide_cfg.model.d_model, "nhead": wide_cfg.model.nhead,
           "invariance": invariance, "serving_launches": serving["launches"], "wall_s": time.monotonic() - t0}
    emit(res)
    fail_unless("wide_widths", {
        f"d 2048: {INVARIANCE_CHUNKS} chunks alone = in a batch of 16": invariance["equal"],
        "d 2048: K1, the wide K5f, LayerNorm and attention_rows launched": all(
            invariance["launches"][k] for k in ("log_mel", "fused_attention_wide", *repair_kernels(wide_cfg))),
        "d 2048: the fp32 K5 not launched": not (invariance["launches"]["fused_attention_tf32"]
                                                  or serving["launches"]["fused_attention_tf32"]),
    })
    return {"kernels": kernels, "serving": serving, "invariance": invariance}


EXPORT_BUCKET = 16  # the fixed-batch artifacts' rows: the 3 requests' chunks, padded with zero rows as served
EXPORT_POLY_ROWS = (1, 16, 64)  # the rows the symbolic-batch artifact serves, each held to the eager decode
# The K1 and K5f routes the shipped widths do not take, each in an artifact at d_model 768 with the depth cut to
# 1 + 1 layers and 64 tokens: K1's any_hop (44.1 kHz) with K5f at head dim 256 (3 heads), and K1's long_hop
# (48 kHz, hop 960) with K5f past head dim 256 (2 heads of 384).
EXPORT_ROUTES = {"44k1-d256": ({"sample_rate": SR_44K1}, {"nhead": 3, "d_query": 256}),
                 "48k-hop960-d384": (LONG_HOP, {"nhead": 2, "d_query": 384})}
EXPORT_ROUTE_MODEL = {"enc_layers": 1, "dec_layers": 1}
EXPORT_ROUTE_TOKENS = 64
EXPORT_ROUTE_ROWS = 4
EXPORT_TIMEOUT = 600  # seconds the artifacts' process may take, every artifact together
ARTIFACT_RUNNER = REPO / "adt_str_tpu_torch" / "scripts" / "run_artifact.py"


def graph_ops(exported) -> set:
    """The `adt_str_tpu_torch::` ops an exported program calls, its loop body's included."""
    prefix = f"{_build.NAMESPACE}."
    graphs = [m.graph for m in exported.graph_module.modules() if isinstance(m, torch.fx.GraphModule)]
    return {str(n.target)[len(prefix):].split(".")[0] for g in graphs for n in g.nodes
            if n.op == "call_function" and str(n.target).startswith(prefix)}


def request_chunks(cfg: FrameworkConfig, rows: int) -> torch.Tensor:
    """The chunks of the serving phase's N_REQUESTS requests at `cfg`'s rate,
    cut to or padded with zero rows to `rows`, as the engine pads a bucket."""
    chunk = cfg.shared.chunk_samples
    chunks = np.stack([c for w in request_waves(cfg) for _, c, _ in chunk_wave(w, chunk)])[:rows]
    return torch.from_numpy(np.concatenate([chunks, np.zeros((rows - len(chunks), chunk), np.float32)]))


def phase_export_serving() -> dict:
    """The compile-once serving export (`scripts/export_serving.py`): the
    serving config exported at bucket 16 and at the symbolic batch in bf16,
    and at bucket 16 in fp32, then the two cut-depth route artifacts; each
    saved to bytes and run, all in one fresh process that imports only
    `torch` and `adt_str_tpu_torch.ops` (`scripts/run_artifact.py`), on the
    chunks of the serving phase's requests. That process starts before the
    first export and runs each artifact once it is written (the exports
    trace on the host, the runs use the card); it times its loops once the
    exports are done, and the eager loop is timed after it ends. Tokens must
    equal the eager `greedy_decode`'s on the same rows, bit for bit (the
    symbolic artifact at 1, 16 and 64 rows); each op in an artifact's graph
    must launch its kernel in the artifact's run, and every registered op
    must in one of them. Export, save and load seconds, the bytes, and wall
    and device ms a decode step of the artifact against the eager loop at
    bucket 16."""
    cfg = load_config(SERVING_YAML, show=False)
    cfg32 = load_config(SERVING_YAML, show=False, model=FP32)
    plans = [("bf16-bucket16", cfg, EXPORT_BUCKET, (EXPORT_BUCKET,)),
             ("bf16-symbolic", cfg, None, EXPORT_POLY_ROWS),
             ("fp32-bucket16", cfg32, EXPORT_BUCKET, (EXPORT_BUCKET,))]
    for label, (shared, model_over) in EXPORT_ROUTES.items():
        c = load_config(SERVING_YAML, show=False, shared=shared, model={**model_over, **EXPORT_ROUTE_MODEL},
                        inference={"max_length": EXPORT_ROUTE_TOKENS})
        plans.append((label, c, EXPORT_ROUTE_ROWS, (EXPORT_ROUTE_ROWS,)))
    work = _build.BUILD_DIR.parent / "export"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    done = work / "exports_done"
    job = {"device": "cuda", "eos": cfg.tokenizer.EOS_token, "out": str(work / "tokens.pt"), "wait_s": EXPORT_TIMEOUT,
           "timed_after": str(done), "artifacts": {}}
    for label, c, batch, rows in plans:
        runs = {f"rows{r}": str(work / f"{label}-rows{r}.pt") for r in rows}
        for r in rows:
            torch.save(request_chunks(c, r), runs[f"rows{r}"])
        # the symbolic artifact's loop is timed as the fixed one's (the same program at the same rows)
        timed = [f"rows{EXPORT_BUCKET}"] if batch == EXPORT_BUCKET else []
        job["artifacts"][label] = {"path": str(work / f"{label}.pt2"), "runs": runs, "timed": timed}
    (work / "job.json").write_text(json.dumps(job))
    res = {"phase": "export_serving", "artifacts": {}}
    models = {}
    t_process = time.monotonic()
    proc = subprocess.Popen([sys.executable, str(ARTIFACT_RUNNER), str(work / "job.json")], cwd=REPO,
                            env=dict(os.environ, PYTHONPATH=str(REPO)), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        for label, c, batch, rows in plans:
            key = (c.model, c.inference.max_length)
            if key not in models:
                models[key] = ADTModel(c.model, seed=SEED, device="cuda")
            tok = c.tokenizer
            t0 = time.monotonic()
            exported = texport.build_exported(models[key], c.inference.max_length, tok.BOS_token, tok.EOS_token,
                                              batch)
            export_s = time.monotonic() - t0
            t0 = time.monotonic()
            blob = texport.to_bytes(exported)
            save_s = time.monotonic() - t0
            path = Path(job["artifacts"][label]["path"])
            path.with_suffix(".tmp").write_bytes(blob)
            os.replace(path.with_suffix(".tmp"), path)  # whole, for the process that waits on it
            loops = [n for n in exported.graph.nodes if n.target is torch.ops.higher_order.while_loop]
            res["artifacts"][label] = {
                "compute_dtype": c.model.compute_dtype, "batch": "symbolic" if batch is None else batch,
                "max_length": c.inference.max_length, "layers": [c.model.enc_layers, c.model.dec_layers],
                "heads": [c.model.nhead, c.model.d_query], "sample_rate": c.shared.sample_rate, "export_s": export_s,
                "save_s": save_s, "artifact_bytes": len(blob), "ops": sorted(graph_ops(exported)),
                "while_loops": len(loops)}
            del exported, blob
        done.write_text("")
        stdout, stderr = proc.communicate(timeout=EXPORT_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    res["process_s"] = time.monotonic() - t_process
    if proc.returncode != 0:
        raise RuntimeError(f"export_serving: the artifacts' process failed:\n{stderr[-4000:]}")
    out = json.loads(stdout.strip().splitlines()[-1])
    tokens = torch.load(work / "tokens.pt", weights_only=True)
    # the eager decode of the same rows, after the artifacts' process: the card is the eager loop's alone
    eager: dict = {}
    for label, c, batch, rows in plans:
        model, max_len, tok = models[(c.model, c.inference.max_length)], c.inference.max_length, c.tokenizer
        eager[label] = {}
        for name in job["artifacts"][label]["runs"]:
            if label == "bf16-symbolic" and name == f"rows{EXPORT_BUCKET}":
                eager[label][name] = eager["bf16-bucket16"][name]  # the same model and rows
                continue
            wave = torch.load(job["artifacts"][label]["runs"][name], weights_only=True).cuda()

            def decode(w):
                return greedy_decode(model, w, max_len, tok.BOS_token, tok.EOS_token)

            if name in job["artifacts"][label]["timed"]:
                res["artifacts"][label]["eager_loop"], rows_out = loop_figures(decode, wave, tok.EOS_token)
            else:
                rows_out = decode(wave)
            eager[label][name] = rows_out.cpu()
    del models
    torch.cuda.empty_cache()
    shutil.rmtree(work)
    res["process_port_modules"] = out["port_modules"]
    launched, equal = {}, {}
    for label, art in out["artifacts"].items():
        mine = res["artifacts"][label]
        mine["load_s"] = art["load_s"]
        for name, run in art["runs"].items():
            equal[f"{label} {name}"] = bool(torch.equal(tokens[label][name], eager[label][name]))
            mine.setdefault("launches", {})[name] = {k: v for k, v in run["launches"].items() if v}
            mine.setdefault("first_call_s", {})[name] = run["first_call_s"]
            if "steps" in run:
                mine["artifact_loop"] = {k: v for k, v in run.items() if k not in ("launches", "first_call_s")}
            launched.update({op: launched.get(op, 0) + run["launches"][op] for op in run["launches"]})
        mine["ops_launched"] = all(r["launches"][op] > 0 for r in art["runs"].values() for op in mine["ops"])
    res["tokens_equal_eager"] = equal
    # each artifact's launches, as every path's, by kernel (add_layer_norm counts on layer_norm)
    res["by_path"] = {f"export_serving-{label}": {k: sum(r["launches"].get(k, 0) for r in art["runs"].values())
                                                  for k in all_counters()}
                      for label, art in out["artifacts"].items()}
    emit({k: v for k, v in res.items() if k != "by_path"})
    fail_unless("export_serving", {
        "every artifact's tokens equal the eager greedy decode's": all(equal.values()),
        "each op in an artifact's graph launched its kernel in the artifact's run":
            all(a["ops_launched"] for a in res["artifacts"].values()),
        "every registered op launched its kernel in an artifact's run": all(launched.get(op) for op in op_wrappers()),
        "the artifacts' process imported no port module but adt_str_tpu_torch.ops": all(
            m == "adt_str_tpu_torch" or m.startswith("adt_str_tpu_torch.ops") for m in out["port_modules"]),
        "every artifact holds one while_loop": all(a["while_loops"] == 1 for a in res["artifacts"].values())},
        {"launched": launched, "equal": equal})
    return res


def fail_unless(phase: str, checks: dict, detail="") -> None:
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"{phase} phase failed {failed} {detail}")


def check_ddp_step(ranks: list, refs: dict, wall: float) -> dict:
    r0, r1 = (r["ddp_step"] for r in ranks)
    first = {k: {"loss": r0[k]["losses"][0], "grad_norm": r0[k]["grad_norms"][0]} for k in ("synth", "flash")}
    res = {"phase": "ddp_step", "ranks": DDP_WORLD, "backend": r0["backend"], "device": r0["device"],
           "rows_a_rank": DDP_ROWS, "global_batch": TRAIN_BATCH, "tokens": TRAIN_TOKENS, "ranks_wall_s": wall,
           "parity": {k: {"two_ranks": first[k], "one_process": refs[k], **PARITY_TOL} for k in first},
           "ddp_weighting": {"loss": r0["ddp_weighting"]["losses"][0], **refs["ddp_weighting"]},
           "bf16": {"grad_norm": r0["bf16"]["grad_norms"][0], "f32_grad_norm": r0["flash"]["grad_norms"][0]},
           "nccl_one_rank": {k: refs["nccl"][k] for k in ("backend", "device", "world", "loss", "grad_norm",
                                                          "step_ms")} | {"no_mesh_loss": refs["flash"]["loss"],
                                                                         "no_mesh_step_ms": refs["flash"]["step_ms"]},
           "shipped_losses": r0["shipped"]["losses"], "ffn_loss": r0["ffn"]["losses"][0],
           "step_ms": {f"rank{i}": {k: r["ddp_step"][k]["step_ms"] for k in ("synth", "flash", "ffn", "shipped")}
                       for i, r in enumerate(ranks)},
           "device_busy_share": {f"rank{i}": r["ddp_step"]["flash_profile"]["device_busy_share"]
                                 for i, r in enumerate(ranks)},
           "flash_profile_rank0": {k: r0["flash_profile"][k] for k in ("wall_ms", "device_busy_ms", "by_group_ms")},
           "allreduce_ms": {"gloo 2 ranks, one card (through host memory)": {f"rank{i}": r["ddp_step"]["allreduce"]
                                                                            for i, r in enumerate(ranks)},
                            "nccl 1 rank": refs["nccl"]["allreduce"]},
           "n_params": r0["n_params"], "launches": {f"rank{i}": r["ddp_step"]["launches"] for i, r in enumerate(ranks)},
           "nccl_launches": refs["nccl"]["launches"], "expected_launches": r0["expected_launches"]}
    emit(res)
    digests = {k: (r0[k]["digest"], r1[k]["digest"]) for k in ("synth", "flash", "bf16", "ddp_weighting", "ffn",
                                                                  "shipped")}
    ddp = res["ddp_weighting"]
    fail_unless("ddp_step", {
        "setting-1 step of 2 ranks = the one-process step": close_to(first["synth"], refs["synth"]),
        "TMIDT-flash step of 2 ranks = the one-process step": close_to(first["flash"], refs["flash"]),
        "the ranks' weights bit-equal after every step": all(a == b for a, b in digests.values()),
        "the ranks report the same numbers": all(r0[k]["losses"] == r1[k]["losses"] for k in digests),
        "shipped setting-1: finite, falling loss": all(math.isfinite(x) for x in res["shipped_losses"])
                                                   and res["shipped_losses"][-1] < res["shipped_losses"][0],
        "fused-FFN step finite": math.isfinite(res["ffn_loss"]),
        "ddp weighting = the mean of the ranks' means": abs(ddp["loss"] - ddp["rank_means"][0] / 2
                                                            - ddp["rank_means"][1] / 2) <= 1e-4 * abs(ddp["loss"]),
        "bf16 transport grad norm within 1% of fp32's": abs(res["bf16"]["grad_norm"] - res["bf16"]["f32_grad_norm"])
                                                        <= 0.01 * res["bf16"]["f32_grad_norm"],
        "NCCL one rank = the no-mesh step": refs["nccl"]["backend"] == "nccl" and abs(
            refs["nccl"]["loss"] - refs["flash"]["loss"]) <= 1e-6 * abs(refs["flash"]["loss"]),
        "gloo on cuda:0": r0["backend"] == r1["backend"] == "gloo" and r0["device"] == "cuda:0",
        "kernels launched as the steps need": r0["launches"] == r1["launches"] == r0["expected_launches"],
        "the NCCL steps' kernels": refs["nccl"]["launches"] == add_launches(
            dict.fromkeys(all_counters(), 0), per_step(load_config(TRAIN_YAMLS["flash"], show=False).model, False),
            2),
    })
    return res


def check_trainer_ddp(ranks: list) -> dict:
    t0, t1 = (r["trainer_ddp"] for r in ranks)
    half = DDP_TRAINER_STEPS // 2
    a = {r["step"]: r for r in t0["straight"]["steps"]}
    b = {r["step"]: r for r in t0["resumed"]["steps"]}
    n_evals = {"straight": 2, "resumed": 1}  # one holdout batch of DDP_ROWS a rank each
    per = {"log_mel": 1, "gather_blend": 1, "place_notes": 1}
    expected = {run: {**dict.fromkeys(kernel_counters(), 0), **{k: n * (len(steps) + n_evals[run]) for k, n in
                                                                 per.items()}}
                for run, steps in (("straight", a), ("resumed", b))}
    res = {"phase": "trainer_ddp", "config": SYNTH_YAML, "ranks": DDP_WORLD, "rows_a_rank": DDP_ROWS,
           "global_batch": DDP_ROWS * DDP_WORLD, "steps": DDP_TRAINER_STEPS,
           "losses": [a[i]["loss"] for i in sorted(a)], "resumed_losses": [b[i]["loss"] for i in sorted(b)],
           **step_rate(t0["straight"], half), "straight_wall_s": t0["straight"]["wall_s"],
           "resumed_wall_s": t0["resumed"]["wall_s"], "eval_history": t0["eval_history"],
           "checkpoints": t0["checkpoints"], "writes": {"rank0": t0["writes"], "rank1": t1["writes"]},
           "launches": {run: {f"rank{i}": r["trainer_ddp"][run]["launches"] for i, r in enumerate(ranks)}
                        for run in ("straight", "resumed")}, "expected_launches": expected}
    emit(res)
    fail_unless("trainer_ddp", {
        "straight run took every step": sorted(a) == list(range(1, DDP_TRAINER_STEPS + 1)),
        "resumed run took the second half": sorted(b) == list(range(half + 1, DDP_TRAINER_STEPS + 1)),
        "every loss finite": all(math.isfinite(x) for x in res["losses"]),
        "resumed losses = straight losses (bit-equal)": all(a[i]["loss"] == b[i]["loss"] for i in b),
        "resumed weights = straight weights (bit-equal)": t0["resumed"]["digest"] == t0["straight"]["digest"],
        "the ranks' weights bit-equal": all(t0[r]["digest"] == t1[r]["digest"] for r in ("straight", "resumed")),
        "rank 0 alone wrote the checkpoints": t1["writes"] == [] and len(t0["writes"]) > 0,
        "one eval line an eval": [h["step"] for h in t0["eval_history"]] == [half, DDP_TRAINER_STEPS]
                                 and all(math.isfinite(h["eval_loss"]) for h in t0["eval_history"]),
        "the trainer left the group it joined": all(t[r]["group_destroyed"] for t in (t0, t1)
                                                    for r in ("straight", "resumed")),
        "K1, K2, K3 once a step and an eval batch": all(tpu_launches(r["trainer_ddp"][run]["launches"]) == expected[run]
                                                        for r in ranks for run in expected),
    })
    return res


def check_eval_ddp(ranks: list, eval_ref: dict, entry_ref: dict) -> dict:
    e0, e1 = (r["eval_ddp"] for r in ranks)
    res = {"phase": "eval_ddp", "ranks": DDP_WORLD, "items": len(eval_ref["wavs"]),
           "wall_s": {"rank0": e0["wall_s"], "rank1": e1["wall_s"]},
           "one_process_wall_s": {"batch 16": eval_ref["wall_s"], "batch 8": entry_ref["wall_s"]},
           "f_measure": e0["metrics"]["all"]["f_measure"],
           "launches": {"rank0": e0["launches"], "rank1": e1["launches"]},
           "rows_differing_from_one_process_at_batch_16": sum(
               not np.array_equal(x, y) for x, y in zip(e0["rows"], eval_ref["rows"]))}
    emit(res)
    fail_unless("eval_ddp", {
        "both ranks hold the one-process metrics at batch 8": e0["metrics"] == e1["metrics"] == entry_ref["metrics"],
        "the decoded tokens = the one-process tokens at batch 8": same_rows(e0["rows"], entry_ref["rows"])
                                                                  and same_rows(e1["rows"], entry_ref["rows"]),
        "rank 0 alone wrote, the one-process files": not e1["wrote"] and e0["files"] == entry_ref["files"],
        "K1 and K5f once a rank's stripe of a batch": tpu_launches(e0["launches"]) == tpu_launches(e1["launches"])
                                                      == tpu_launches(eval_ref["launches"]),
    })
    return res


def eval_run(statics: render.SynthStatics, sc, extra: dict, mesh=None) -> dict:
    """`run_inference` over the eval phase's items with the ENST eval config
    (K1 and K5 on, `inference` fields replaced by `extra`), on cuda or over
    `mesh` -> the decoded token rows, metrics, the files it wrote, the
    kernel launches and the wall seconds."""
    with tempfile.TemporaryDirectory() as out_dir:
        cfg = load_config(EVAL_YAML, show=False, model=KERNELS_ON, inference={"output_path": out_dir, **extra})
        tokenizer = RecordingTokenizer(cfg.tokenizer)
        ds = eval_items(statics, sc, MidiTokenizer(cfg.tokenizer), SEED + 70)
        model = ADTModel(cfg.model, seed=SEED, device="cuda")
        counters = reset_counters()
        t0 = time.monotonic()
        metrics = run_inference(model, cfg.model, ds, tokenizer, cfg.inference, device=None if mesh else "cuda",
                                mesh=mesh)
        wall = time.monotonic() - t0
        launches = {k: c.launches for k, c in counters.items()}
        files = {f: (Path(out_dir) / f).read_bytes() for f in ("metrics.json", "confusion_matrix.csv")}
    return {"rows": tokenizer.rows, "metrics": metrics, "files": files, "launches": launches, "wall_s": wall}


class ProbeStop(Exception):
    """Raised by `OpProbe` once the decode steps it watches have run."""


def _tensors(x) -> list:
    return [t for t in torch.utils._pytree.tree_leaves(x) if isinstance(t, torch.Tensor)]


class OpProbe(TorchDispatchMode):
    """Every op of a run at one row count, held against the same op of a run
    at more rows whose first rows are the same inputs.

    Recording (`ref=None`), it keeps each op's output and its inputs'
    shapes. Forcing (`ref` = a recording), it compares each op's output with
    the reference's first rows (along the one dimension whose size differs:
    the batch, or the batch times a per-row size where rows are flattened)
    and then writes the reference's values into it, so every later op sees
    equal inputs and every op that moves a row's bits is listed, not only
    the first. Views, in-place ops, allocations and `.item()` pass through;
    an output whose size stays while an input's changes (a reduction over
    the batch: `finished.all()`) is not compared. The port's CUDA kernels run
    through ctypes, out of the dispatcher's sight, so a kernel wrapper (K1,
    K5f, the batch-invariance kernels) is compared at its own output with its
    inner ops muted; replaced by its plain version, it is a label and its
    ops are compared one by one. Each op is named by the innermost port
    function around it (`transformer.linear > aten.mm.default`)."""

    SKIP = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "_local_scalar_dense"}

    def __init__(self, ref: "OpProbe | None", steps: int):
        super().__init__()
        self.ref, self.steps = ref, steps
        self.records: list = []  # (name, input shapes, outputs): outputs kept when recording
        self.diffs: list = []  # (name, shape, max abs diff)
        self.labels: list[str] = []
        self.muted = 0
        self.steps_run = 0

    def _observe(self, name: str, args, out) -> None:
        outs, in_shapes = _tensors(out), [tuple(t.shape) for t in _tensors(args)]
        i = len(self.records)
        if self.ref is None:
            self.records.append((name, in_shapes, [t.clone() for t in outs]))
            return
        self.records.append((name, in_shapes, None))
        ref_name, ref_in, ref_outs = self.ref.records[i]
        if ref_name != name or len(ref_outs) != len(outs):
            raise RuntimeError(f"probe op {i}: {name} here, {ref_name} in the reference run")
        for t, r in zip(outs, ref_outs):
            dims = [d for d in range(t.dim()) if t.shape[d] != r.shape[d]] if t.dim() == r.dim() else None
            if dims is None or len(dims) > 1 or (dims and t.shape[dims[0]] > r.shape[dims[0]]):
                continue  # not a row-major slice of the reference's output
            if not dims and in_shapes != ref_in:
                continue  # a reduction over the batch
            r = r.narrow(dims[0], 0, t.shape[dims[0]]) if dims else r
            if not torch.equal(t, r):
                diff = (t.double() - r.double()).abs().max().item() if t.is_floating_point() else float("nan")
                self.diffs.append((name, list(t.shape), diff))
                t.copy_(r)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        schema = func._schema
        if (self.muted or func.overloadpacket.__name__ in self.SKIP or func.is_view or schema.is_mutable
                or any(r.alias_info is not None for r in schema.returns)):
            return out
        self._observe(f"{self.labels[-1] if self.labels else '-'} > {func}", (args, kwargs), out)
        return out

    def wrap(self, label: str, fn, kernel: bool):
        def op(*args, **kw):
            if label == "decode.decode_step":
                self.steps_run += 1
                if self.steps_run > self.steps:
                    raise ProbeStop
            self.labels.append(label)
            self.muted += kernel
            try:
                out = fn(*args, **kw)
            finally:
                self.muted -= kernel
                self.labels.pop()
            if kernel:
                self.muted += 1  # the comparison's own ops
                try:
                    self._observe(f"{label} (kernel)", (args, kw), out)
                finally:
                    self.muted -= 1
            return out
        op.__dict__ = fn.__dict__  # a wrapper counts its launches on itself (`log_mel.launches += 1`)
        return op


def probe_targets() -> list:
    """(module, attribute, kernel wrapper or None): the port functions the
    probe names its ops by, and the kernel wrappers it compares whole."""
    from adt_str_tpu_torch.models import decode as decode_mod
    return [(T, "linear", None), (T, "layer_norm", None), (T, "ffn", None), (T, "attention_core", None),
            (T.MultiheadAttention, "project", None), (decode_mod, "_anc_attention", None),
            (decode_mod, "decode_step", None), (decode_mod, "init_caches", None),
            (cuda_mel, "log_mel", cuda_mel.log_mel), (T, "_flash_attention", T._flash_attention),
            *[(mod, name, wrapper) for (mod, name, _), wrapper in zip(REPAIRS, REPAIR_WRAPPERS.values())],
            (ln_ops, "add_layer_norm", ln_ops.add_layer_norm)]


def probe_run(run, ref: OpProbe | None, steps: int) -> OpProbe:
    """`run()` under a fresh `OpProbe`, its port functions wrapped."""
    probe = OpProbe(ref, steps)
    targets = probe_targets()
    saved = [getattr(mod, attr) for mod, attr, _ in targets]
    try:
        for (mod, attr, kernel), fn in zip(targets, saved):
            label = f"{mod.__name__.rsplit('.', 1)[-1]}.{attr}"
            setattr(mod, attr, probe.wrap(label, fn, fn is kernel))
        with torch.inference_mode(), probe:
            run()
    except ProbeStop:
        pass
    finally:
        for (mod, attr, _), fn in zip(targets, saved):
            setattr(mod, attr, fn)
    return probe


PROBE_ROWS = (64, 32, 16, 8, 4, 2, 1)  # the serving buckets, each against the first rows of the largest
PROBE_BEAM_ITEMS = (16, 8, 2, 1)
PROBE_STEPS = 4  # decode steps of each run


def batch_probe(cfg: FrameworkConfig) -> dict:
    """Every op of the full-width inference path whose output for a row
    differs with the rows beside it although its inputs are equal
    (`OpProbe`): greedy decoding (K1, the encoder, the cross caches and
    PROBE_STEPS steps of the greedy loop) at each of PROBE_ROWS rows
    against the first rows of the largest, and beam BEAM_SIZE decoding
    (PROBE_STEPS steps of the beam loop: `_anc_attention`, the per-item
    cross attention, the selection) at each of PROBE_BEAM_ITEMS items
    against the largest. -> the ops compared and the ops that differ, each
    with its shape and max abs difference at each row count."""
    model = ADTModel(cfg.model, seed=SEED, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 75)
    wav = torch.randn(PROBE_ROWS[0], cfg.shared.chunk_samples, generator=gen, device="cuda") * 0.3
    L = cfg.inference.max_length
    runs = {"greedy": (PROBE_ROWS, lambda w: greedy_decode(model, w, L)),
            "beam": (PROBE_BEAM_ITEMS, lambda w: beam_search_decode(model, w, L, BEAM_SIZE))}
    found: dict = {}
    compared = {}
    for mode, (rows, decode) in runs.items():
        ref = probe_run(lambda: decode(wav[: rows[0]]), None, PROBE_STEPS)
        compared[mode] = len(ref.records)
        for r in rows[1:]:
            for name, shape, diff in probe_run(lambda: decode(wav[:r]), ref, PROBE_STEPS).diffs:
                e = found.setdefault(f"{mode}: {name}", {"shape": {}, "max_abs_diff": {}})
                e["shape"][r] = shape
                e["max_abs_diff"][r] = max(diff, e["max_abs_diff"].get(r, 0.0))
        del ref
    del model
    torch.cuda.empty_cache()
    return {"rows": {"greedy": list(PROBE_ROWS), "beam_items": list(PROBE_BEAM_ITEMS)}, "decode_steps": PROBE_STEPS,
            "ops_compared": compared, "differing_ops": [{"op": k, **v} for k, v in found.items()]}


INVARIANCE_CHUNKS = 4  # chunks decoded alone and in batches (a depth cut for the smoke's time)
# tokens a chunk decodes alone and in a batch (a depth cut for the smoke's time: the configs take 512 or more;
# the tokens must be equal at every step, and the kernel phases check the decode step's rows at 1-64 up to 512 keys)
INVARIANCE_TOKENS = 128
INVARIANCE_BATCHES = (2, 4, 8, 16, 64)
INVARIANCE_BEAM_CHUNKS = 2
INVARIANCE_BEAM_BATCH = 16


def spread(n: int, b: int) -> list[int]:
    """Positions of n chunks spread over a batch of b >= n rows."""
    return [(i * b) // n + b // n - 1 for i in range(n)]


def greedy_batches(model: ADTModel, chunks: torch.Tensor, others: torch.Tensor, L: int,
                   batches: tuple = INVARIANCE_BATCHES) -> tuple:
    """`chunks` decoded greedily each alone (bucket 1), then in batches of
    each of `batches` (below len(chunks): the chunks side by side; from it:
    spread among `others`) -> (the lone tokens, {batch: equal to them, rows
    differing})."""
    n = chunks.shape[0]
    alone = torch.cat([greedy_decode(model, chunks[i : i + 1], L) for i in range(n)])
    greedy = {}
    for b in batches:
        if b < n:
            got = torch.cat([greedy_decode(model, chunks[j : j + b], L) for j in range(0, n, b)])
        else:
            pos = spread(n, b)
            batch = others[:b].clone()
            batch[pos] = chunks
            got = greedy_decode(model, batch, L)[pos]
        greedy[b] = {"equal": bool(torch.equal(got, alone)),
                     "rows_differing": int((got != alone).any(dim=1).sum().item())}
    return alone, greedy


def phase_fp32_invariance(cfg: FrameworkConfig) -> dict:
    """The serving config at `compute_dtype: float32` (K1, the 3xTF32 K5f
    and the batch-invariance kernels at fp32): `greedy_alone_vs_batch` at
    each of INVARIANCE_BATCHES, the tokens bit-equal."""
    t0 = time.monotonic()
    res = {"phase": "fp32_invariance", "compute_dtype": cfg.model.compute_dtype,
           "max_length": min(cfg.inference.max_length, INVARIANCE_TOKENS),
           **greedy_alone_vs_batch(cfg, INVARIANCE_BATCHES, SEED + 82),
           "wall_s": time.monotonic() - t0}
    emit(res)
    fail_unless("fp32_invariance", {
        **{f"fp32 greedy tokens alone = in batches of {b}": g["equal"] for b, g in res["batches"].items()},
        "K1, the 3xTF32 K5f and the repair kernels launched": all(
            res["launches"][k] for k in ("log_mel", "fused_attention_tf32", *repair_kernels(cfg))),
    })
    return res


def phase_batch_invariance(cfg: FrameworkConfig) -> dict:
    """A chunk's tokens on the card do not depend on the rows decoded beside
    it (the serving config at full width, K1, K5f and the batch-invariance
    kernels on, seeded random weights and chunks):
    - greedy: INVARIANCE_CHUNKS chunks each decoded alone (bucket 1) to
      INVARIANCE_TOKENS tokens (beam too), then
      in batches of each of INVARIANCE_BATCHES (below 8: the chunks side by
      side; from 8: spread among other chunks); the tokens must be equal;
    - beam BEAM_SIZE: INVARIANCE_BEAM_CHUNKS chunks alone and spread in a
      batch of INVARIANCE_BEAM_BATCH; the tokens must be equal;
    - serving: the serving phase's requests through `ServingEngine` one at a
      time (a request's 4 chunks, bucket 4) and concurrently (12 chunks,
      bucket 16); the notes must be equal;
    - the op list of `batch_probe`, before the repair (`before_repair`) and
      after it, in this call; after, it must be empty."""
    t0 = time.monotonic()
    model = ADTModel(cfg.model, seed=SEED, device="cuda")
    L, n = min(cfg.inference.max_length, INVARIANCE_TOKENS), INVARIANCE_CHUNKS
    gen = torch.Generator(device="cuda").manual_seed(SEED + 80)
    pool = torch.randn(n + max(INVARIANCE_BATCHES), cfg.shared.chunk_samples, generator=gen, device="cuda") * 0.3
    chunks, others = pool[:n], pool[n:]
    reset_counters()
    alone, greedy = greedy_batches(model, chunks, others, L)
    greedy_launches = {k: c.launches for k, c in all_counters().items()}
    nb, bb = INVARIANCE_BEAM_CHUNKS, INVARIANCE_BEAM_BATCH
    beam_alone = torch.cat([beam_search_decode(model, chunks[i : i + 1], L, BEAM_SIZE) for i in range(nb)])
    pos = spread(nb, bb)
    batch = others[:bb].clone()
    batch[pos] = chunks[:nb]
    beam_in = beam_search_decode(model, batch, L, BEAM_SIZE)[pos]
    beam = {"equal": bool(torch.equal(beam_in, beam_alone)),
            "rows_differing": int((beam_in != beam_alone).any(dim=1).sum().item())}
    one, _, _, one_stats = serve_requests(build_engine(cfg, model), cfg, sequential=True)
    together, _, _, together_stats = serve_requests(build_engine(cfg, model), cfg)
    same_notes = [json.loads(a[1]) == json.loads(b[1]) for a, b in zip(one, together)]
    del model
    torch.cuda.empty_cache()
    decode_s = time.monotonic() - t0
    probe_after = batch_probe(cfg)
    with before_repair():
        probe_before = batch_probe(cfg)
    res = {"phase": "batch_invariance", "chunks": n, "max_length": L,
           "greedy_alone_vs_batch": greedy, "greedy_launches": greedy_launches,
           "tokens_before_eos": int((alone != cfg.tokenizer.EOS_token).sum().item()),
           "beam": {"beam_size": BEAM_SIZE, "chunks": nb, "batch": bb, **beam},
           "serving": {"same_notes_one_at_a_time_and_concurrent": same_notes,
                       "buckets_one_at_a_time": one_stats["occupancy"], "buckets_concurrent": together_stats["occupancy"]},
           "probe_before_repair": probe_before, "probe": probe_after,
           "decode_s": decode_s, "wall_s": time.monotonic() - t0}
    emit(res)
    fail_unless("batch_invariance", {
        **{f"greedy tokens alone = in batches of {b}": g["equal"] for b, g in greedy.items()},
        f"beam {BEAM_SIZE} tokens alone = in a batch of {bb}": beam["equal"],
        "served notes one at a time = concurrent": all(same_notes) and len(same_notes) == N_REQUESTS,
        "the probe lists no op": not probe_after["differing_ops"],
        "the probe before the repair lists ops": bool(probe_before["differing_ops"]),
        "K1, K5f and the repair kernels launched": all(greedy_launches[k] for k in
                                                       ("log_mel", "fused_attention", *repair_kernels())),
    })
    return res


def encode_ms(model: ADTModel, cfg: FrameworkConfig, batch: int) -> float:
    """The median ms (CUDA events) of REPS encodes of `batch` seeded chunks."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    wave = torch.randn(batch, cfg.shared.chunk_samples, generator=gen, device="cuda") * 0.3
    with torch.inference_mode():
        return median_ms(model.encode, [(wave,)] * REPS)


REPAIR_COST_STEPS = 128


def phase_repair_cost(statics: render.SynthStatics, sc) -> dict:
    """What the batch-invariance repair costs, before (`before_repair`) and
    after in this call, at full width with the eval config (K1, K5f on):
    greedy decode ms a step and device ops a step at buckets 1 and 16, beam
    BEAM_SIZE ms a step at 16, the encode ms at 16 (`decode_breakdown`) and
    the median encode ms at buckets 16 and 64 (`encode_ms`), and the eval
    phase's wall s (`eval_run`: 34 items at batch 16). The decodes run
    REPAIR_COST_STEPS steps (a depth cut for the smoke's time: the config
    takes 511, and a step reads a shorter cache here)."""
    cfg = load_config(EVAL_YAML, show=False, model=KERNELS_ON, inference={"max_length": REPAIR_COST_STEPS + 1})
    out: dict = {}
    for label in ("after", "before"):
        with before_repair() if label == "before" else contextlib.nullcontext():
            model = ADTModel(cfg.model, seed=SEED, device="cuda")
            runs = {"greedy_bucket_1": decode_breakdown(model, cfg, 1),
                    "greedy_bucket_16": decode_breakdown(model, cfg, 16),
                    "beam_bucket_16": decode_breakdown(model, cfg, 16, decode=beam_decode(1.0, BEAM_SIZE))}
            out[label] = {k: {"encode_ms": r["encode_ms"], "ms_per_step": r["ms_per_step"],
                              "decode_steps": r["decode_steps"],
                              "device_ops_per_step": r["device_kernels"] / r["profiled_max_steps"],
                              "device_busy_share": r["device_busy_share"]} for k, r in runs.items()}
            out[label]["encode_median_ms"] = {b: encode_ms(model, cfg, b) for b in (16, 64)}
            del model
            out[label]["eval_wall_s"] = eval_run(statics, sc, {})["wall_s"]
    emit({"phase": "repair_cost", **out})
    torch.cuda.empty_cache()
    return out


def same_rows(a: list, b: list) -> bool:
    return len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))


def decode_dp_eval(statics: render.SynthStatics, sc, refs: dict) -> dict:
    """`run_inference` over a mesh of two entries of cuda:0 (each decoding
    its half of every batch of 16), greedy and beam BEAM_SIZE, on the eval
    phase's items. Its tokens, metrics.json and confusion CSV must equal
    the one-device run at the entries' batch of 8, which decodes the same
    blocks of items (the ragged last batch's real items included), and no
    row may differ from the one-device run at batch 16 (`refs`: the eval and
    beam phases): a row's tokens do not depend on the rows decoded beside
    it. -> the result, with the greedy one-device batch-8 run for
    eval_ddp."""
    mesh = mesh_lib.make_mesh(devices=["cuda:0", "cuda:0"])
    res = {"phase": "decode_dp", "part": "eval", "mesh": [str(d) for d in mesh.devices], "runs": {}}
    same, entry_refs = {}, {}
    for name, extra in (("greedy", {}), ("beam", {"use_beam_search": True, "beam_size": BEAM_SIZE})):
        bs = load_config(EVAL_YAML, show=False).inference.batch_size
        entry_refs[name] = ref8 = eval_run(statics, sc, {**extra, "batch_size": bs // mesh.n_data})
        dp = eval_run(statics, sc, extra, mesh=mesh)
        full = refs[name]
        same[name] = {"tokens": same_rows(dp["rows"], ref8["rows"]), "metrics": dp["metrics"] == ref8["metrics"],
                      "files": dp["files"] == ref8["files"],
                      "launches (each entry its half of a batch)": tpu_launches(dp["launches"]) == {
                          k: 2 * n for k, n in tpu_launches(full["launches"]).items()}}
        res["runs"][name] = {
            "batch": bs, "wall_s": dp["wall_s"], "one_device_wall_s": {f"batch {bs}": full["wall_s"],
                                                                      f"batch {bs // 2}": ref8["wall_s"]},
            "launches": dp["launches"], f"equal_to_one_device_at_batch_{bs // 2}": same[name],
            f"vs_one_device_at_batch_{bs}": {
                "rows_differing": sum(not np.array_equal(x, y) for x, y in zip(dp["rows"], full["rows"])),
                "rows": len(full["rows"]), "f_measure": dp["metrics"]["all"]["f_measure"],
                "one_device_f_measure": full["metrics"]["all"]["f_measure"]}}
    emit(res)
    fail_unless("decode_dp", {
        **{f"{n} {k} = one device at the entries' batch": ok for n, s in same.items() for k, ok in s.items()},
        **{f"{n} tokens = one device at batch {r['batch']}": r[f"vs_one_device_at_batch_{r['batch']}"][
            "rows_differing"] == 0 for n, r in res["runs"].items()}})
    torch.cuda.empty_cache()
    res["entry_batch_reference"] = entry_refs["greedy"]  # for eval_ddp
    return res


def decode_dp_serving(cfg: FrameworkConfig, serving: dict) -> dict:
    """A `ServingEngine` over a mesh of two entries of cuda:0 answers the
    serving phase's requests through the port's HTTP server: every answer
    well formed, K1 and K5f launched; a bucket the data axis does not divide
    raises. Its notes must equal the one-device engine's, although the
    micro-batches' shapes follow the requests' timing: a chunk's tokens do
    not depend on the rows decoded beside it."""
    mesh = mesh_lib.make_mesh(devices=["cuda:0", "cuda:0"])
    model = ADTModel(cfg.model, seed=SEED, device="cuda")
    refused = None
    try:
        build_engine(cfg, model, mesh=mesh)  # the config's buckets hold 1
    except ValueError as e:
        refused = str(e)
    buckets = tuple(b for b in cfg.serving.buckets if b % mesh.n_data == 0)
    results, wall, launches, stats = serve_requests(build_engine(cfg, model, mesh=mesh, buckets=buckets), cfg)
    bodies = [json.loads(r[1]) for r in results]
    res = {"phase": "decode_dp", "part": "serving", "mesh": [str(d) for d in mesh.devices], "buckets": buckets,
           "wall_s": wall, "one_device_wall_s": serving["wall_s"], "request_s": [r[2] for r in results],
           "n_notes": [b["n_notes"] for b in bodies], "one_device_n_notes": serving["n_notes"],
           "same_notes_as_one_device": [b == r for b, r in zip(bodies, serving["bodies"])], "launches": launches,
           "engine_stats": stats, "odd_bucket_refused": refused}
    emit(res)
    fail_unless("decode_dp serving", {
        "a bucket of 1 refused": refused is not None and "not divisible by the mesh data axis (2)" in refused,
        "every bucket split over the two entries": stats["n_batches"] > 0
                                                   and all(b % 2 == 0 for b in stats["occupancy"]),
        "the same notes as one device": all(res["same_notes_as_one_device"]),
    })
    del model
    torch.cuda.empty_cache()
    return res


# the training shapes of K5 at B = 64: (Tq, Tk, causal + padding mask)
TRAIN_ATTENTION = {"encoder": (246, 246, False), "decoder-self": (511, 511, True), "cross": (511, 246, False)}
TRAIN_FFN_ROWS = {"encoder": TRAIN_BATCH * 246, "decoder": TRAIN_BATCH * 511}


def phase_synthesis(ptxas: dict) -> dict:
    """Phase 4, the synthesis-fused training phase and the eval and
    inference phases, on one bank built on the card."""
    cfg = load_config(SYNTH_YAML, train=True)
    sc = cfg.synthetiser
    t0 = time.monotonic()
    bank = build_card_bank(sc, SEED + 50)
    statics = render.SynthStatics.from_bank(bank, device="cuda")
    torch.cuda.synchronize()
    table = statics.waveforms
    emit({"phase": "bank", "rows": table.shape[0], "samples": table.shape[1], "dtype": str(table.dtype),
          "gib": table.numel() * table.element_size() / 2**30, "loaded_bins": statics.loaded_bins,
          "build_s": round(time.monotonic() - t0, 3)})
    gen = torch.Generator(device="cuda").manual_seed(SEED + 51)
    out = {"gather_blend": phase_gather_blend(statics, sc, gen),
           "place_notes": phase_place_notes(statics, sc, gen, ptxas["place_notes"]),
           "render": phase_render(statics, sc, gen), "training": phase_synth_training(cfg, statics),
           "eval": phase_eval(statics, sc), "inference": phase_inference(statics, sc),
           "trainer": phase_trainer(bank, statics), "trainer_tmidt": phase_trainer_tmidt(statics, sc),
           "beam": phase_beam(statics, sc)}
    out["decode_dp"] = decode_dp_eval(statics, sc, {"greedy": out["eval"]["reference"],
                                                    "beam": out["beam"]["reference"]})
    out["repair_cost"] = phase_repair_cost(statics, sc)
    out.update(phase_ddp(statics, sc, out["eval"]["reference"], out["decode_dp"]["entry_batch_reference"]))
    del statics, table, bank
    torch.cuda.empty_cache()
    return out


# CLAP curation (`configs/preprocess/clap.yaml`) at laion/clap-htsat-fused's widths
CLAP_YAML = "configs/preprocess/clap.yaml"
CLAP_SR = 48_000
CLAP_BATCH = 32  # the config's batch_size
CLAP_LIBRARY = 1024  # one-shots of 0.2-1.0 s, as tools/bench_curation.py makes them
CLAP_REF_PER_CLASS = 2
CLAP_CPU_CLIPS = 4
CLAP_TEXT_ROWS = 8
CLAP_TIMED_BATCHES = 5
CLAP_NEAR_TIE = 1e-6  # a top-two cosine margin below this may go either way in another summation order


def one_shots(root: Path, n: int, rng, prefix: str) -> list[str]:
    """`n` mono 48 kHz one-shots of 0.2-1.0 s as tools/bench_curation.py
    makes them (a decaying sine of 60-4000 Hz and noise, peak-normalised),
    written as float32 WAVs."""
    root.mkdir(parents=True, exist_ok=True)
    paths = []
    for i in range(n):
        length = int(rng.integers(int(0.2 * CLAP_SR), int(1.0 * CLAP_SR)))
        t = np.arange(length) / CLAP_SR
        sig = np.sin(2 * np.pi * rng.uniform(60, 4000) * t) * np.exp(-t * rng.uniform(3, 30))
        sig += rng.normal(0, 0.05, length)
        paths.append(str(root / f"{prefix}_{i:05d}.wav"))
        write_wav(paths[-1], (sig / (np.abs(sig).max() + 1e-9)).astype(np.float32), CLAP_SR)
    return paths


def phase_clap_mel() -> dict:
    """K1 at CLAP's frontend: (32, 480000) repeat-padded one-shots of
    0.2-1.0 s (silent tails at the 1e-10 floor), each call on other row
    gains, no trim, dB; against its plain version within 1e-3 dB (the card
    tests' dB tolerance) or, for a band in a spectral dip, within 2^-20 (8
    fp32 ulps) of its frame's mel power."""
    rng = np.random.default_rng(SEED + 71)
    fx = clap_features.ClapFeatureExtractor()
    rows = [fx._pad_short(rng.normal(size=int(rng.integers(9600, 48_000))) * 0.3) for _ in range(CLAP_BATCH)]
    base = torch.from_numpy(np.stack(rows).astype(np.float32)).cuda()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 72)
    params = clap_features._clap_mel_params()
    inputs = [(base * (0.5 + torch.rand(CLAP_BATCH, 1, generator=gen, device="cuda")), params, False)
              for _ in range(REPS)]
    res = time_log_mel(inputs, 1e-3, frame_tol=2.0**-20)
    emit({"phase": "kernel", "name": "log_mel", "at": "clap frontend", "batch": CLAP_BATCH,
          "samples": base.shape[1], **res})
    return res


class EmbeddingRecorder:
    """A CLAP wrapper as `curate_library` sees it: every call passes straight
    through, and each batch's embeddings and end time are kept."""

    def __init__(self, wrapper):
        self.wrapper, self.device = wrapper, wrapper.device
        self.batches: list = []
        self.ends: list = []

    def get_audio_features(self, audios, mesh=None):
        out = self.wrapper.get_audio_features(audios, mesh=mesh)
        self.batches.append(out)
        self.ends.append(time.monotonic())
        return out


def stage_rows(batches: list, counts: list) -> list:
    """Per-batch embeddings -> one array per stage of `counts` files (each
    stage's batches padded to CLAP_BATCH rows)."""
    out, at = [], 0
    for n in counts:
        k = -(-n // CLAP_BATCH)
        out.append(np.concatenate(batches[at : at + k])[:n])
        at += k
    return out


def curated_tree(root: Path) -> dict:
    """{file name: "<class>/<bin>"} of a curated tree; raises if a name is there twice."""
    tree: dict = {}
    for p in root.rglob("*.wav"):
        rel = p.relative_to(root)
        if p.name in tree:
            raise RuntimeError(f"clap: {p.name} copied twice ({tree[p.name]}, {rel.parent})")
        tree[p.name] = str(rel.parent)
    return tree


def near_bin_edge(score: float) -> bool:
    """Whether `score` lies within 1e-5 of a point where `score_to_bin_label`'s rounding turns."""
    x = (score + 1.0) * 50.0
    return abs(x - (math.floor(x) + 0.5)) < 5e-4


def clap_breakdown(wrapper, files: list) -> dict:
    """Where one batch's time goes, each part timed on its own over
    CLAP_TIMED_BATCHES batches of decoded library one-shots (medians): the
    host's repeat-padding, the upload, K1, the tower (CUDA events), and the
    whole `get_audio_features` call (host clock)."""
    fx = wrapper.feature_extractor
    batches = [[normalize(load_and_resample(f, CLAP_SR)) for f in files[i * CLAP_BATCH : (i + 1) * CLAP_BATCH]]
               for i in range(CLAP_TIMED_BATCHES)]
    pad_s, up_s, call_s, waves = [], [], [], []
    for clips in batches:
        t0 = time.monotonic()
        padded = np.stack([fx._pad_short(a) for a in clips]).astype(np.float32)
        t1 = time.monotonic()
        waves.append(torch.from_numpy(padded).to(wrapper.device))
        torch.cuda.synchronize()
        pad_s.append(t1 - t0)
        up_s.append(time.monotonic() - t1)
    for clips in batches:
        t0 = time.monotonic()
        wrapper.get_audio_features(clips)
        call_s.append(time.monotonic() - t0)
    with torch.no_grad():
        mels = [clap_features.device_log_mel_db(w)[:, None].expand(-1, 4, -1, -1) for w in waves]
        longer = torch.zeros(CLAP_BATCH, dtype=torch.bool, device=wrapper.device)
        tower_ms = median_ms(wrapper.audio, [(m, longer) for m in mels])
    return {"host_pad_ms": statistics.median(pad_s) * 1e3, "upload_ms": statistics.median(up_s) * 1e3,
            "k1_ms": median_ms(clap_features.device_log_mel_db, [(w,) for w in waves]), "tower_ms": tower_ms,
            "get_audio_features_ms": statistics.median(call_s) * 1e3}


def clap_text(wrapper, cpu_wrapper, audio_emb: np.ndarray) -> dict:
    """CLAP_TEXT_ROWS id rows of 16-77 tokens (BOS, random ids, EOS, padding)
    through the full-width text tower on the card and on the CPU."""
    rng = np.random.default_rng(SEED + 73)
    lengths = rng.integers(16, 78, CLAP_TEXT_ROWS)
    pos = np.arange(77)[None]
    ids = np.where(pos < lengths[:, None], rng.integers(3, wrapper.text_arch.vocab_size, (CLAP_TEXT_ROWS, 77)),
                   wrapper.text_arch.pad_token_id)
    ids[:, 0] = 0
    ids[np.arange(CLAP_TEXT_ROWS), lengths - 1] = 2
    ids, mask = torch.from_numpy(ids), torch.from_numpy((pos < lengths[:, None]).astype(np.float32))
    card = clap_text_features(wrapper.text, ids, mask).cpu().numpy()
    cpu = clap_text_features(cpu_wrapper.text, ids, mask).numpy()
    match = wrapper.semantic_match(audio_emb, card)
    return {"rows": CLAP_TEXT_ROWS, "tokens": lengths.tolist(), "max_abs_vs_cpu": float(np.abs(card - cpu).max()),
            "match_shape": list(match.shape), "match_row_sum_err": float(np.abs(match.sum(axis=1) - 1).max())}


def phase_clap() -> dict:
    """CLAP curation at full width (`ClapAudioArch()`, `ClapTextArch()`: the
    laion/clap-htsat-fused shapes) on seeded random weights; see the module
    docstring, item 8."""
    k1 = phase_clap_mel()
    tmp = Path(tempfile.mkdtemp(prefix="clap_smoke_"))
    try:
        return {**clap_curation_on_card(tmp), "k1": k1}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()


def clap_curation_on_card(tmp: Path) -> dict:
    """The CLAP phase after K1's own check, in `tmp`."""
    res: dict = {"phase": "clap"}
    t0 = time.monotonic()
    audio_arch, text_arch = ClapAudioArch(), ClapTextArch()
    sd = clap_model.random_state_dict(audio_arch, text_arch, SEED + 70)
    model_dir = clap_model.save_checkpoint(tmp / "model", sd, audio_arch, text_arch)
    res["checkpoint"] = {"params": sum(v.numel() for v in sd.values()),
                         "bytes": (model_dir / "model.safetensors").stat().st_size,
                         "write_s": time.monotonic() - t0}
    del sd
    emit({"phase": "clap_checkpoint", **res["checkpoint"]})

    # the library and the reference tree, where configs/preprocess/clap.yaml looks for them
    t0 = time.monotonic()
    rng = np.random.default_rng(SEED + 74)
    data = tmp / "data"
    lib_files = sorted(one_shots(data / "SampleToUse", CLAP_LIBRARY, rng, "shot"))
    ref_root = data / "GM" / "GM_Mapped_Reduced"
    for cls in clap_curation.REFERENCE_CLASSES:
        one_shots(ref_root / str(cls), CLAP_REF_PER_CLASS, rng, f"ref{cls}")
    n_ref = CLAP_REF_PER_CLASS * len(clap_curation.REFERENCE_CLASSES)
    res["data"] = {"library": CLAP_LIBRARY, "reference": n_ref, "make_s": time.monotonic() - t0}
    out_root = clap_curation._augmented_root_for(ref_root)

    # the CLI, as a user runs it
    proc, wall = run_cli(["-m", "adt_str_tpu_torch.scripts.augment_data_with_clap", CLAP_YAML, "--device", "cuda"],
                         env={"CLAP_MODEL_DIR": str(model_dir), "ADT_DATA": str(data)})
    cli_tree = curated_tree(out_root)
    res["cli"] = {"wall_s": wall, "files_per_s": (CLAP_LIBRARY + n_ref) / wall, "copied": len(cli_tree),
                  "log_tail": proc.stderr.strip().splitlines()[-2:]}

    # the same curation in this process, with the launch counters and the embeddings read
    wrapper = clap_model.ClapWrapper.from_dir(model_dir, sample_rate=CLAP_SR, device="cuda")
    recorder = EmbeddingRecorder(wrapper)
    counters = reset_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    clap_curation.curate_library(recorder, str(data / "SampleToUse"), str(ref_root), sample_rate=CLAP_SR,
                                 batch_size=CLAP_BATCH, num_bins=10)
    t_end = time.monotonic()
    launches = {k: c.launches for k, c in counters.items()}
    res["in_process"] = {"wall_s": t_end - t0, "batches": len(recorder.batches),
                         "assign_and_copy_s": t_end - recorder.ends[-1],
                         "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "launches": launches}
    tree = curated_tree(out_root)

    ref_emb, lib_emb = stage_rows(recorder.batches, [n_ref, CLAP_LIBRARY])
    ref_files = clap_curation.sort_paths_by_parent_folder([str(p) for p in ref_root.rglob("*.wav")])
    by_class = {k: [e for f, e in zip(ref_files, ref_emb) if int(Path(f).parent.name) == k]
                for k in clap_curation.REFERENCE_CLASSES}
    labels = [k for k in clap_curation.REFERENCE_CLASSES if by_class[k]]
    means = np.stack([np.mean(by_class[k], axis=0) for k in labels]).astype(np.float32)
    idx, score = clap_curation.assign_classes(lib_emb, means, device="cuda")
    expect = {Path(f).name: f"{labels[int(i)]}/{clap_curation.score_to_bin_label(float(v), 10)}"
              for f, i, v in zip(lib_files, idx, score)}
    assign_s = []
    for _ in range(5):
        t0 = time.monotonic()
        clap_curation.assign_classes(lib_emb, means, device="cuda")
        assign_s.append(time.monotonic() - t0)
    u = lib_emb.astype(np.float64) / np.linalg.norm(lib_emb.astype(np.float64), axis=1, keepdims=True)
    m = means.astype(np.float64) / np.linalg.norm(means.astype(np.float64), axis=1, keepdims=True)
    sims = u @ m.T
    top2 = np.sort(sims, axis=1)[:, -2:]
    margin = top2[:, 1] - top2[:, 0]
    near = margin < CLAP_NEAR_TIE
    cli_diff = sorted(n for n in expect if cli_tree.get(n) != tree.get(n))
    cli_diff_explained = all(margin[lib_files.index(str(data / "SampleToUse" / n))] < 1e-5
                             or near_bin_edge(float(score[lib_files.index(str(data / "SampleToUse" / n))]))
                             for n in cli_diff)
    res["assignment"] = {"classes": len(labels), "classes_used": len(set(idx.tolist())),
                         "mean_score": float(score.mean()), "min_margin": float(margin.min()),
                         "median_margin": float(np.median(margin)), "near_ties": int(near.sum()),
                         "fp64_argmax_differs": int(((sims.argmax(axis=1) != idx) & ~near).sum()),
                         "assign_ms": statistics.median(assign_s) * 1e3,
                         "cli_files_elsewhere": len(cli_diff), "embedding_digest": hashlib.sha256(
                             np.ascontiguousarray(lib_emb).tobytes()).hexdigest()[:16],
                         "embedding_rows_0_1": lib_emb[:2, :6].tolist()}

    # where the time goes
    t0 = time.monotonic()
    with ThreadPoolExecutor(min(16, os.cpu_count() or 1)) as pool:
        list(pool.map(lambda f: normalize(load_and_resample(f, CLAP_SR)), lib_files + ref_files))
    res["breakdown"] = {"decode_s": time.monotonic() - t0, **clap_breakdown(wrapper, lib_files)}
    res["breakdown"]["decode_ms_per_batch"] = res["breakdown"]["decode_s"] * 1e3 * CLAP_BATCH / (CLAP_LIBRARY + n_ref)

    # K1 against its plain version through the tower; the card against the CPU; the mesh; the text tower
    clips = [normalize(load_and_resample(f, CLAP_SR)) for f in lib_files[:CLAP_BATCH]]
    emb = wrapper.get_audio_features(clips)
    with plain_kernels():
        emb_plain = wrapper.get_audio_features(clips)
    res["k1_vs_plain_min_cosine"] = float((emb * emb_plain).sum(axis=1).min())
    cpu_wrapper = clap_model.ClapWrapper.from_dir(model_dir, sample_rate=CLAP_SR, device="cpu")
    cpu_wrapper.device_mel = True  # the card's route: K1 (its plain version), the tower
    emb_cpu = cpu_wrapper.get_audio_features(clips[:CLAP_CPU_CLIPS])
    emb_card = wrapper.get_audio_features(clips[:CLAP_CPU_CLIPS])
    cpu_wrapper.device_mel = False  # the CPU's own route: the float64 host extractor
    emb_cpu_host = cpu_wrapper.get_audio_features(clips[:CLAP_CPU_CLIPS])
    res["card_vs_cpu"] = {"clips": CLAP_CPU_CLIPS, "max_abs": float(np.abs(emb_card - emb_cpu).max()),
                          "max_abs_vs_host_extractor": float(np.abs(emb_card - emb_cpu_host).max())}
    half = CLAP_BATCH // 2
    before = cuda_mel.log_mel.launches
    emb_mesh = wrapper.get_audio_features(clips, mesh=mesh_lib.make_mesh(devices=["cuda:0", "cuda:0"]))
    mesh_launches = cuda_mel.log_mel.launches - before
    emb_halves = np.concatenate([wrapper.get_audio_features(clips[:half]), wrapper.get_audio_features(clips[half:])])
    res["mesh"] = {"entries": 2, "max_abs_vs_entry_batch": float(np.abs(emb_mesh - emb_halves).max()),
                   "max_abs_vs_full_batch": float(np.abs(emb_mesh - emb).max()), "k1_launches": mesh_launches}
    res["text"] = clap_text(wrapper, cpu_wrapper, emb_card)
    emit(res)

    checks = {
        "every library file copied once": sorted(tree) == sorted(expect),
        "the tree is score_to_bin_label's": tree == expect,
        "the CLI's tree agrees but for near ties": cli_tree.keys() == tree.keys() and cli_diff_explained,
        "fp64 argmax agrees but for near ties": res["assignment"]["fp64_argmax_differs"] == 0,
        "K1 launched once a batch, nothing else": launches == {**dict.fromkeys(counters, 0),
                                                             "log_mel": len(recorder.batches)},
        "embeddings finite": bool(np.isfinite(lib_emb).all() and np.isfinite(ref_emb).all()),
        "K1 vs plain cosine >= 0.9999": res["k1_vs_plain_min_cosine"] >= 0.9999,
        "card vs CPU < 1e-3": res["card_vs_cpu"]["max_abs"] < 1e-3,
        "mesh equals one device at the entries' batch": res["mesh"]["max_abs_vs_entry_batch"] <= 1e-6
                                                         and mesh_launches == 2,
        "text card vs CPU < 1e-3": res["text"]["max_abs_vs_cpu"] < 1e-3,
        "semantic_match rows sum to 1": res["text"]["match_row_sum_err"] <= 1e-6,
    }
    fail_unless("clap", checks)
    return res



# ---- several trees' decode-step kernels side by side (`--compare`)

COMPARE_LINEAR = {  # name: (rows, N, K, rows per count of the bit-equality check)
    "in-projection 16 x 768 -> 2304": (16, 2304, 768, 1),
    "out- / q-projection 16 x 768 -> 768": (16, 768, 768, 1),
    "FFN 1 16 x 768 -> 3072": (16, 3072, 768, 1),
    "FFN 2 16 x 3072 -> 768": (16, 768, 3072, 1),
    "generator 16 x 768 -> 1400": (16, 1400, 768, 1),
    "beam in-projection 80 x 768 -> 2304": (80, 2304, 768, 5),
}
COMPARE_ATTENTION = {  # name: (rows, query rows, keys, the mask's step or None, counts)
    "decode self 16 x 1 x 512, step 256": (16, 1, 512, 256, [1, 2, 4, 8, 16, 32, 64]),
    "decode cross 16 x 1 x 246": (16, 1, 246, None, [1, 2, 4, 8, 16, 32, 64]),
    "beam cross 16 items x 5 x 246": (16, 5, 246, None, [1, 2, 8, 16]),
    "beam self 80 x 1 x 512, step 256": (80, 1, 512, 256, [1, 5, 10, 40, 80]),
}

# One run, in a tree's root: that tree's `chip_smoke.py` is imported for the functions every tree's smoke
# has since the products and attentions became kernels (`phase_linear`, `phase_attention_rows`,
# `decode_breakdown`, `beam_decode`), so an older tree needs no change. argv[1]: the JSON of
# (COMPARE_LINEAR, COMPARE_ATTENTION); argv[2]: the file the run's outputs on fixed seeded inputs go to.
COMPARE_RUN = r"""
import json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from adt_str_tpu_torch.models.adt import ADTModel
from adt_str_tpu_torch.models.decode import greedy_decode_from_memory
from adt_str_tpu_torch.ops import _build, attention_rows, linear as linear_ops
from adt_str_tpu_torch.ops import layer_norm as ln_ops

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
linear_shapes, attention_shapes = json.loads(sys.argv[1])
_build.build_all()
keys = ("max_abs_err", "ms", "device_ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "rows_bit_equal")
gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
out = {"linear": {}, "attention_rows": {}, "decode": {}, "layer_norm": {}}
for name, rows, counts, per in (("decode 16 x 768", 16, (1, 2, 4, 8, 16, 32, 64), 1),
                                ("encoder 16 x 246 x 768", 16 * 246, (1, 2, 16), 246)):
    res = cs.phase_layer_norm(gen, rows, name, counts=counts, rows_per=per)
    out["layer_norm"][name] = {key: res[key] for key in keys}
    if hasattr(cs, "phase_add_layer_norm"):  # the fused entry, where the tree has it
        res = cs.phase_add_layer_norm(gen, rows, name, counts=counts, rows_per=per)
        out["layer_norm"]["add " + name] = {key: res[key] for key in keys + ("unfused_ms", "unfused_device_ms")}
for name, (m, n, k, per) in linear_shapes.items():
    counts = (1, 2, 8, 16) if per > 1 else (1, 2, 4, 8, 16, 32, 64)
    res = cs.phase_linear(gen, m, n, k, name, counts=counts, rows_per=per)
    out["linear"][name] = {key: res[key] for key in keys}
out["linear_fp32"] = {}
for name, (m, n, k, per) in linear_shapes.items():  # the fp32 route at the same shapes
    counts = (1, 2, 8, 16) if per > 1 else (1, 2, 4, 8, 16, 32, 64)
    res = cs.phase_linear(gen, m, n, k, "fp32 " + name, counts=counts, rows_per=per, dtype=torch.float32)
    out["linear_fp32"][name] = {key: res[key] for key in keys + ("fp32_max_rel_err", "library_device_ms") if key in res}
for name, (b, tq, tk, step, counts) in attention_shapes.items():
    res = cs.phase_attention_rows(gen, b, tq, tk, step, name, counts=tuple(counts))
    out["attention_rows"][name] = {key: res[key] for key in keys + ("valid_keys",) if key in res}
cfg = cs.load_config(cs.EVAL_YAML, show=False, model=cs.KERNELS_ON)
model = ADTModel(cfg.model, seed=cs.SEED, device="cuda")
for label, batch, decode in (("greedy_bucket_1", 1, None), ("greedy_bucket_16", 16, None),
                             ("beam_bucket_16", 16, cs.beam_decode(1.0, cs.BEAM_SIZE))):
    r = cs.decode_breakdown(model, cfg, batch, **({} if decode is None else {"decode": decode}))
    out["decode"][label] = {"ms_per_step": r["ms_per_step"], "decode_steps": r["decode_steps"],
                            "device_ops_per_step": r["device_kernels"] / r["profiled_max_steps"],
                            "device_busy_share": r["device_busy_share"]}
g = torch.Generator(device="cuda").manual_seed(1234)
kept = {}
with torch.inference_mode():
    for name, (m, n, k, per) in linear_shapes.items():
        x = torch.randn(m, k, generator=g, device="cuda").to(torch.bfloat16)
        w = (torch.randn(n, k, generator=g, device="cuda") / k ** 0.5).to(torch.bfloat16)
        b = (0.1 * torch.randn(n, generator=g, device="cuda")).to(torch.bfloat16)
        kept["linear " + name] = linear_ops.linear(x, w, b).cpu()
    for name, (b, tq, tk, step, counts) in attention_shapes.items():
        q, k, v = (torch.randn(b, 6, t, 128, generator=g, device="cuda").to(torch.bfloat16) for t in (tq, tk, tk))
        mask = None if step is None else torch.where(torch.arange(tk, device="cuda") > step, -1e4, 0.0)[None, None, None]
        kept["attention_rows " + name] = attention_rows.attention(q, k, v, mask).cpu()
    for name, rows in (("decode 16 x 768", 16), ("encoder 16 x 246 x 768", 16 * 246)):
        x = (torch.randn(rows, 768, generator=g, device="cuda") * 2.0 + 0.5).to(torch.bfloat16)
        w = 1.0 + 0.1 * torch.randn(768, generator=g, device="cuda")
        b = 0.1 * torch.randn(768, generator=g, device="cuda")
        kept["layer_norm " + name] = ln_ops.layer_norm(x, w, b, 1e-5).cpu()
    wave = torch.randn(16, cfg.shared.chunk_samples, generator=g, device="cuda") * 0.3
    memory = model.encode(wave)
    kept["greedy tokens"] = greedy_decode_from_memory(model, memory, cfg.inference.max_length).cpu()
    kept["beam tokens"] = cs.beam_decode(1.0, cs.BEAM_SIZE)(model, memory, cfg.inference.max_length,
                                                            cfg.tokenizer.BOS_token, cfg.tokenizer.EOS_token).cpu()
    # the fp32 route: the products at the same shapes, and the fp32 serving config's greedy and beam tokens
    g32 = torch.Generator(device="cuda").manual_seed(4321)
    for name, (m, n, k, per) in linear_shapes.items():
        x = torch.randn(m, k, generator=g32, device="cuda")
        w = torch.randn(n, k, generator=g32, device="cuda") / k ** 0.5
        b = 0.1 * torch.randn(n, generator=g32, device="cuda")
        kept["linear fp32 " + name] = linear_ops.linear(x, w, b).cpu()
    cfg32 = cs.load_config(cs.SERVING_YAML, show=False, model=cs.FP32)
    model32 = ADTModel(cfg32.model, seed=cs.SEED, device="cuda")
    memory32 = model32.encode(torch.randn(16, cfg32.shared.chunk_samples, generator=g32, device="cuda") * 0.3)
    bos, eos = cfg32.tokenizer.BOS_token, cfg32.tokenizer.EOS_token
    kept["fp32 greedy tokens"] = greedy_decode_from_memory(model32, memory32, cfg32.inference.max_length).cpu()
    kept["fp32 beam tokens"] = cs.beam_decode(1.0, cs.BEAM_SIZE)(model32, memory32, cfg32.inference.max_length,
                                                                 bos, eos).cpu()
torch.save(kept, sys.argv[2])


def decode_device(cfg, steps=64):
    # wall and device ms a step of a `steps`-step greedy decode at bucket 16 (torch.profiler), the
    # attention_rows kernels' device ms a step by name, and every kernel's device ms and launches a step
    m = ADTModel(cfg.model, seed=cs.SEED, device="cuda")
    wave = torch.randn(16, cfg.shared.chunk_samples, generator=torch.Generator(device="cuda").manual_seed(cs.SEED + 2),
                       device="cuda") * 0.3
    bos, eos = cfg.tokenizer.BOS_token, cfg.tokenizer.EOS_token
    with torch.inference_mode():
        memory = m.encode(wave)
        greedy_decode_from_memory(m, memory, steps + 1, bos, eos)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        greedy_decode_from_memory(m, memory, steps + 1, bos, eos)
        end.record()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            greedy_decode_from_memory(m, memory, steps + 1, bos, eos)
            torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.device_time_total > 0]

    def name(e):
        return e.key.replace("(anonymous namespace)::", "").split("(")[0]

    return {"wall_ms_per_step": start.elapsed_time(end) / steps,
            "device_ms_per_step": sum(e.device_time_total for e in ev) / 1e3 / steps,
            "attention_rows_ms_per_step": {name(e): e.device_time_total / 1e3 / steps for e in ev
                                           if "attention_rows" in e.key},
            # every kernel's device ms and launches a step, largest first (a step's split by kernel)
            "by_kernel": [{"kernel": name(e)[:100], "ms_per_step": e.device_time_total / 1e3 / steps,
                           "launches_per_step": e.count / steps}
                          for e in sorted(ev, key=lambda e: -e.device_time_total)]}


# the widths and the fp32 config past the bf16 serving config, where the tree has them
for name in ("ONE_WIDE_HEAD", "TWO_HEADS", "FP32"):
    if hasattr(cs, name):
        out["decode"]["greedy_bucket_16_" + name.lower()] = decode_device(
            cs.load_config(cs.SERVING_YAML, show=False, model=getattr(cs, name)))
if hasattr(cs, "phase_training_fp32"):
    r = cs.phase_training_fp32("fused-ffn")
    out["training_fp32_fused_ffn"] = {"step_ms": r["step_ms"], "median_step_ms": r["median_step_ms"]}
print("COMPARE " + json.dumps(out), flush=True)
"""


def compare_run(root: Path, keep: Path) -> dict:
    """One run of COMPARE_RUN in the tree at `root`, in a process of its own
    (the tree's `adt_str_tpu_torch` and `csrc/` are the ones built and
    loaded) -> its JSON line."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", COMPARE_RUN, json.dumps([COMPARE_LINEAR, COMPARE_ATTENTION]),
                           str(keep)], cwd=root, env=env, capture_output=True, text=True, timeout=900)
    sys.stderr.write(proc.stderr[-4000:])
    lines = [line for line in proc.stdout.splitlines() if line.startswith("COMPARE ")]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"the run in {root} failed ({proc.returncode}):\n{proc.stdout[-4000:]}")
    return json.loads(lines[-1][len("COMPARE "):])


def equal_groups(runs: dict[str, dict], name: str) -> list[list[str]]:
    """The runs whose output `name` is bit-equal, in groups, in run order."""
    groups: list[tuple[torch.Tensor, list[str]]] = []
    for run, kept in runs.items():
        for first, members in groups:
            if torch.equal(first, kept[name]):
                members.append(run)
                break
        else:
            groups.append((kept[name], [run]))
    return [members for _, members in groups]


def token_difference(a: torch.Tensor, b: torch.Tensor) -> dict:
    """How two runs' greedy token rows differ: the rows, and the first step
    of each row that differs (its tokens after that follow other inputs)."""
    diff = a != b
    rows = diff.any(dim=1)
    return {"rows_differing": int(rows.sum()), "of_rows": a.shape[0],
            "first_step_differing": {int(r): int(diff[r].nonzero()[0]) for r in rows.nonzero().flatten()}}


def compare_trees(argv: list[str]) -> int:
    """`--compare LABEL=DIR ... --order LABEL,...`: one JSON line a run (its
    kernels' checks and times, the products in bf16 and fp32, its decode
    loops), then one line that groups the runs by bit-equal outputs on fixed
    seeded inputs (each product in bf16 and fp32, each attention, one
    batch's greedy and beam tokens at bf16 and on the fp32 serving config)
    and gives how each run's tokens differ from the first run's. Every run is compared, two runs of one tree
    too, so a run whose bits follow what ran before shows."""
    import argparse

    ap = argparse.ArgumentParser(prog="chip_smoke.py", description=compare_trees.__doc__)
    ap.add_argument("--compare", action="append", required=True, metavar="LABEL=DIR", help="a tree's root")
    ap.add_argument("--order", required=True, help="labels in run order, comma-separated")
    args = ap.parse_args(argv)
    trees = dict(t.split("=", 1) for t in args.compare)
    order = args.order.split(",")
    if len(order) < 2:
        raise SystemExit("--order needs two runs or more: one run has nothing to be compared with")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    runs: dict[str, dict] = {}
    with tempfile.TemporaryDirectory() as tmp:
        for i, label in enumerate(order):
            keep = Path(tmp) / f"{i}-{label}.pt"
            print(json.dumps({"label": label, "run": i, **compare_run(Path(trees[label]).resolve(), keep)}),
                  flush=True)
            runs[f"{label}#{i}"] = torch.load(keep)
    first = next(iter(runs))
    print(json.dumps({"card": smi, "order": order,
                      "bit_equal_groups": {name: equal_groups(runs, name) for name in runs[first]},
                      "greedy_tokens_against": first,
                      **{f"{p}greedy_tokens": {run: token_difference(runs[first][f"{q}greedy tokens"],
                                                                     kept[f"{q}greedy tokens"])
                                               for run, kept in runs.items() if run != first}
                         for p, q in (("", ""), ("fp32_", "fp32 "))},
                      **{f"{p}beam_tokens": {run: bool(torch.equal(runs[first][f"{q}beam tokens"],
                                                                   kept[f"{q}beam tokens"]))
                                             for run, kept in runs.items() if run != first}
                         for p, q in (("", ""), ("fp32_", "fp32 "))}}), flush=True)
    return 0


def at_shape(res: dict) -> dict:
    """A kernel phase's numbers for a `kernels` entry beside its main shape."""
    keys = ("shape", "batch", "rows", "d_ff", "tq", "tk", "heads", "head_dim", "dtype", "route", "max_abs_err", "tol", "ms",
            "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library_device_ms")
    return {k: res[k] for k in keys if k in res}


def tp_entry(tp: dict, kernel: str, col0: int | None = None) -> dict:
    """A kernel's numbers at a tensor-parallel rank's shape (the tp phase)."""
    res = tp["kernel_results"][kernel]
    res = res if col0 is None else res[col0]
    keys = ("max_abs_err", "tol", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    return {"shape": f"tp phase, {'col0 ' + str(col0) if col0 is not None else '3 heads'}",
            **{k: res[k] for k in keys if k in res}}


# ------------------------------------------- fp32 trajectories (python3 chip_smoke.py --fp32-drift)

def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 x rounded to TF32 as cvt.rna.tf32.f32 (and hopper.cuh's tf32_rna) round it."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b from three TF32 products of operands split as the 3xTF32
    kernels split them (the two small terms first), each product and the
    sums in fp32 rounded to nearest (cuBLAS, TF32 off)."""
    ab, bb = tf32_rna(a), tf32_rna(b)
    return torch.matmul(tf32_rna(a - ab), bb) + torch.matmul(ab, tf32_rna(b - bb)) + torch.matmul(ab, bb)


def mm_halves(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in another fp32 order: each half of the shared dimension, then their sum."""
    h = a.shape[-1] // 2
    return torch.matmul(a[..., h:], b[..., h:, :]) + torch.matmul(a[..., :h], b[..., :h, :])


def attention_with(mm) -> list:
    """Swaps that route K5f and K5b to `attention_plain` and
    `attention_bwd_plain` (fp32) with every product through `mm`."""
    def scores(q, k, mask):
        s = mm(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
        return s if mask is None else s + mask[:, None]

    def fwd(q, k, v, mask=None, n_virtual=0):
        s = scores(q, k, mask)
        m = s.amax(dim=-1, keepdim=True)
        if n_virtual:
            m = torch.clamp(m, min=cuda_attention.NEG_MASK)
        e = torch.exp(s - m)
        denom = e.sum(dim=-1, keepdim=True)
        if n_virtual:
            denom = denom + n_virtual * torch.exp(cuda_attention.NEG_MASK - m)
        return mm(e / denom, v), (m + torch.log(denom)).transpose(-1, -2)

    def bwd(q, k, v, mask, out, lse, do):
        p = torch.exp(scores(q, k, mask) - lse.transpose(-1, -2))
        dv = mm(p.transpose(-1, -2), do)
        ds = p * (mm(do, v.transpose(-1, -2)) - (do * out).sum(dim=-1, keepdim=True)) * (1.0 / math.sqrt(q.shape[-1]))
        return mm(ds, k), mm(ds.transpose(-1, -2), q), dv

    return [(cuda_attention, "fused_attention", fwd), (cuda_attention, "fused_attention_bwd", bwd)]


def _sdpa_fwd(q, k, v, mask=None, n_virtual=0):
    """out from fp32 SDPA (`_sdpa`); lse from the plain version."""
    return _sdpa(q, k, v, mask, n_virtual), cuda_attention.attention_plain(q, k, v, mask, n_virtual)[1]


def _sdpa_bwd(q, k, v, mask, out, lse, do):
    """dq, dk, dv from autograd through fp32 SDPA."""
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        return _sdpa_grads(_sdpa(*leaves, mask, 0), *leaves, do)


def drift_trajectory(inputs: tuple, swaps: list | None) -> dict:
    """FP32_STEPS steps of `inputs` (`training_inputs`) from the seeded
    weights: through the kernels (`swaps` None), or through the plain
    versions with `swaps` on top -> each step's metrics and step 1's clipped
    gradient (mu / (1 - b1)) and weights."""
    cfg, tcfg, batch, keys = inputs
    model = ADTModel(cfg.model, seed=SEED, device="cuda")
    opt, _ = make_optimizer(tcfg, FP32_STEPS, model)
    step, state = make_train_step(cfg.model, opt, device="cuda"), init_train_state(model, opt)
    metrics, first = [], None
    with plain_kernels() if swaps is not None else contextlib.nullcontext(), swapped(swaps or []):
        for i in range(FP32_STEPS):
            state, m = step(state, batch, keys[i])
            metrics.append({k: float(v) for k, v in m.items()})
            if i == 0:
                first = {"g": {n: mu / (1 - opt.b1) for n, mu in state.opt_state.mu.items()},
                         "w": {n: p.detach().clone() for n, p in state.model.named_parameters()}}
    return {"metrics": metrics, "first": first}


def drift_against(run: dict, plain: dict, lr: float) -> dict:
    """How `run` parts from `plain`: each step's loss and grad norm, and
    after step 1, per leaf, the gradient elements of opposite sign (Adam's
    first update moves an element by lr times its gradient's sign), the
    weights more than lr apart, the leaf's largest gradient, their largest
    difference, and the largest gradient among the flipped elements."""
    steps = [{"loss_rel": abs(a["loss"] - b["loss"]) / abs(b["loss"]),
              "grad_norm_rel": abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"]}
             for a, b in zip(run["metrics"], plain["metrics"])]
    leaves = []
    for n, gp in plain["first"]["g"].items():
        go = run["first"]["g"][n]
        flip = torch.sign(go) != torch.sign(gp)
        leaves.append({"leaf": n, "elements": gp.numel(), "sign_flips": int(flip.sum()),
                       "weights_over_lr_apart": int(((run["first"]["w"][n] - plain["first"]["w"][n]).abs() > lr).sum()),
                       "largest_grad": gp.abs().max().item(), "largest_grad_gap": (go - gp).abs().max().item(),
                       "largest_flipped_grad": gp.abs()[flip].max().item() if flip.any() else 0.0})
    flipped = [lf for lf in leaves if lf["sign_flips"]]
    return {"each_step": steps, "sign_flips": sum(lf["sign_flips"] for lf in leaves),
            "weights_over_lr_apart": sum(lf["weights_over_lr_apart"] for lf in leaves),
            "leaves_flipped": len(flipped), "of_leaves": len(leaves),
            "flipped_within_the_gap": sum(lf["largest_flipped_grad"] <= lf["largest_grad_gap"] for lf in flipped),
            "most_flipped": sorted(flipped, key=lambda lf: -lf["sign_flips"])[:8]}


def masked_row_witness() -> dict:
    """The card test `fp32-masked-row` (B 1, 2 heads of 128, 30 x 30,
    causal, row 3's keys all at -1e4; inputs as the test seeds them) in
    fp64: the fp32 score s = q.k / sqrt(128) - 1e4 lies on a 2^-10 grid
    there; the exact score nearest a rounding boundary, and the kernel's
    and the plain version's out on row 3 against out in fp64 from the exact
    scores and from the exact scores rounded once to fp32
    (`cuda_attention.attention_fp64_rounded_scores`, the test's reference
    on that row)."""
    B, H, T, D, row = 1, 2, 30, 128, 3
    g = torch.Generator(device="cpu").manual_seed(T + T + D)
    q, k, v = (torch.randn(B, H, T, D, generator=g).cuda() for _ in range(3))
    mask = torch.triu(torch.full((T, T), -1e4), diagonal=1).expand(B, T, T).clone()
    mask[:, row] = -1e4
    mask, n_virtual = mask.cuda(), cuda_attention.virtual_keys(T, T)
    out, _ = cuda_attention.fused_attention(q, k, v, mask, n_virtual)
    ref, _ = cuda_attention.attention_plain(q, k, v, mask, n_virtual)
    s64 = (q.double() @ k.double().transpose(-1, -2)) / math.sqrt(D) + mask.double()[:, None]
    s32 = s64.float()
    toward = torch.nextafter(s32, torch.where(s64 > s32.double(), torch.inf, -torch.inf).float())
    boundary = (s32.double() + toward.double()) / 2
    dist = (s64 - boundary).abs()[:, :, row]
    m = s64.amax(-1, keepdim=True).clamp(min=cuda_attention.NEG_MASK)
    e = torch.exp(s64 - m)
    exact = ((e / (e.sum(-1, keepdim=True) + n_virtual * torch.exp(cuda_attention.NEG_MASK - m))) @ v.double())
    exact = exact[:, :, row]
    rounded = cuda_attention.attention_fp64_rounded_scores(q, k, v, mask, n_virtual)[:, :, row]
    h, key = divmod(int(dist.argmin()), T)

    def gap(a, b):
        return (a.double() - b).abs().max().item()

    return {"row": row, "nearest_boundary": {"head": h, "key": key, "score_fp64": s64[0, h, row, key].item(),
                                             "distance": dist.min().item(), "grid": 2.0**-10},
            "kernel_vs_fp64": gap(out[:, :, row], exact), "plain_vs_fp64": gap(ref[:, :, row], exact),
            "kernel_vs_fp64_rounded_scores": gap(out[:, :, row], rounded),
            "plain_vs_fp64_rounded_scores": gap(ref[:, :, row], rounded),
            "kernel_vs_plain": gap(out[:, :, row], ref[:, :, row].double()), "test_tol": 1e-5}


def ffn_with(mm) -> list:
    """A swap that routes K4 to `ffn_dropout_plain` (fp32) with both of its
    products through `mm`."""
    def fwd(*args):
        with swapped([(ffn, "_dot32", lambda a, b: mm(a.float(), b.float()))]):
            return ffn.ffn_dropout_plain(*args)

    return [(cuda_ffn, "ffn_dropout", fwd)]


def fp32_drift() -> int:
    """`--fp32-drift`: the 3xTF32 K5 at its fp32 rows and the 3xTF32 K4 at
    its (held and timed as the smoke holds them), the `fp32-masked-row`
    witness, then TMIDT-flash and TMIDT-fused-ffn at fp32 (64 x 512 tokens,
    FP32_STEPS steps, seeded) on separate trajectories from the same
    weights, each held to the plain fp32 path: the kernel path, the plain
    path again (through `attention_with(torch.matmul)` or `ffn_with`: must
    equal it), the plain path with its products in emulated 3xTF32 or
    summed in two fp32 halves, and (flash) with attention through fp32 SDPA
    (its memory-efficient kernel, which forms fp32 products as three TF32
    products); one JSON line each."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_card()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for s, (tq, tk, causal) in TRAIN_ATTENTION.items():
        phase_attention(TRAIN_BATCH, tq, tk, causal, gen, f"fp32 {s}", dtype=torch.float32)
        phase_attention_bwd(TRAIN_BATCH, tq, tk, causal, gen, f"fp32 {s}", dtype=torch.float32)
    for s, rows in TRAIN_FFN_ROWS.items():
        phase_ffn(rows, gen, f"fp32 {s}", dtype=torch.float32)
    emit({"phase": "masked_row_witness", **masked_row_witness()})
    variants = {"flash": {"kernel path": None, "plain again": attention_with(torch.matmul),
                          "3xTF32 products, fp32 sums": attention_with(mm_3xtf32),
                          "fp32 products in halves": attention_with(mm_halves),
                          "SDPA": [(cuda_attention, "fused_attention", _sdpa_fwd),
                                   (cuda_attention, "fused_attention_bwd", _sdpa_bwd)]},
                "fused-ffn": {"kernel path": None, "plain again": ffn_with(torch.matmul),
                              "3xTF32 products, fp32 sums": ffn_with(mm_3xtf32),
                              "fp32 products in halves": ffn_with(mm_halves)}}
    for config, runs in variants.items():
        inputs = training_inputs(config, FP32_STEPS, model=FP32)
        plain = drift_trajectory(inputs, [])
        emit({"phase": "fp32_drift", "config": config, "run": "plain",
              **{k: [m[k] for m in plain["metrics"]] for k in ("loss", "grad_norm")}})
        for name, swaps in runs.items():
            run = drift_trajectory(inputs, swaps)
            emit({"phase": "fp32_drift", "config": config, "run": name,
                  **{k: [m[k] for m in run["metrics"]] for k in ("loss", "grad_norm")},
                  "lr": TRAIN_LR, **FP32_TOL, **drift_against(run, plain, TRAIN_LR)})
            del run
            torch.cuda.empty_cache()
        del plain
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # plain fp32 products stay fp32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.monotonic()
    smi, name = phase_card()
    ptxas = phase_build()
    cfg = load_config(SERVING_YAML)
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
    domain = phase_domain_kernels(gen)
    repairs = phase_repairs(gen, cfg)
    repairs_fp16 = phase_repairs_fp16(gen, cfg)
    repairs_fp32 = phase_repairs_fp32(gen, cfg)
    synth = phase_synthesis(ptxas)
    training = {c: phase_training(c) for c in TRAIN_YAMLS}
    training[SYNTH_NAME] = synth["training"]
    serving = phase_serving(cfg)
    dp_serving = decode_dp_serving(cfg, serving)
    invariance = phase_batch_invariance(cfg)
    bench = phase_bench()
    clap = phase_clap()
    tp = phase_tp(params, gen)
    fsdp = phase_fsdp()
    youtube = phase_youtube()
    # the configs JAX's gates send to its kernels beyond the shipped ones
    fp32_training = {c: phase_training_fp32(c) for c in TRAIN_YAMLS}
    long_training = phase_training_long()
    fp32_serving = phase_serving_variant("serving-fp32", load_config(SERVING_YAML, model=FP32),
                                         ("log_mel", "fused_attention_tf32"))
    fp32_invariance = phase_fp32_invariance(load_config(SERVING_YAML, model=FP32))
    long_serving = phase_serving_variant(
        "serving-long", load_config(SERVING_YAML, shared={"input_sec": LONG_SEC},
                                    inference={"max_length": LONG_TOKENS}),
        ("log_mel", "fused_attention"), seconds=LONG_REQUEST_SEC, hold_tokens=False)
    serving_44k1 = phase_serving_variant("serving-44k1", load_config(SERVING_YAML, shared={"sample_rate": SR_44K1}),
                                         ("log_mel_any_hop", "fused_attention"))
    serving_48k = phase_serving_variant("serving-48k-hop960", load_config(SERVING_YAML, shared=LONG_HOP),
                                        ("log_mel_long_hop", "fused_attention"))
    # fp16, 3 heads of 256, 2 heads of 384
    variants = phase_fp16_and_wide_heads(gen)
    # d and head dim 2,048: past the old limits of K5, LayerNorm and attention_rows
    wide = phase_wide_widths(gen, cfg)
    # the compile-once serving export: artifacts run in a process of their own
    export = phase_export_serving()

    def ranks_sum(per_rank: dict) -> dict:
        return {k: sum(n[k] for n in per_rank.values()) for k in all_counters()}

    ddp, trainer_ddp = synth["ddp_step"], synth["trainer_ddp"]
    by_path = {"serving": serving["launches"], **{f"training-{c}": r["launches"] for c, r in training.items()},
               "bench": bench["launches"], "eval": synth["eval"]["launches"],
               "inference": synth["inference"]["launches"],
               "trainer": synth["trainer"]["launches"]["straight"],
               "trainer-resumed": synth["trainer"]["launches"]["resumed"],
               "trainer_tmidt": synth["trainer_tmidt"]["launches"],
               "beam": synth["beam"]["launches"],
               "beam-serving": synth["beam"]["serving"]["launches"],
               "ddp_step (2 ranks)": ranks_sum(ddp["launches"]), "ddp_step-nccl": ddp["nccl_launches"],
               "trainer_ddp (2 ranks)": ranks_sum(trainer_ddp["launches"]["straight"]),
               "trainer_ddp-resumed (2 ranks)": ranks_sum(trainer_ddp["launches"]["resumed"]),
               "eval_ddp (2 ranks)": ranks_sum(synth["eval_ddp"]["launches"]),
               "decode_dp": synth["decode_dp"]["runs"]["greedy"]["launches"],
               "decode_dp-beam": synth["decode_dp"]["runs"]["beam"]["launches"],
               "decode_dp-serving": dp_serving["launches"], "clap": clap["in_process"]["launches"],
               "batch_invariance-greedy": invariance["greedy_launches"],
               **{f"tp-{c} (2 ranks)": ranks_sum({r: n[c] for r, n in tp["launches"].items()}) for c in TP_CONFIGS},
               "tp-trainer (2 ranks)": ranks_sum({f"{r}-{k}": n[k] for r, n in tp["trainer"]["launches"].items()
                                                  for k in ("straight", "resumed")}),
               **{f"fsdp-{c} (2 ranks)": ranks_sum({r: n[c] for r, n in fsdp["launches"].items()})
                  for c in FSDP_CONFIGS},
               "fsdp-2x2 (4 ranks)": ranks_sum(fsdp["grid_2x2"]["launches"]),
               "fsdp-trainer (2 ranks)": ranks_sum({f"{r}-{k}": n[k] for r, n in fsdp["trainer"]["launches"].items()
                                                    for k in ("straight", "resumed")}),
               **{f"youtube-{k}": v["launches"] for k, v in youtube["in_process"].items()},
               **{f"training-fp32-{c}": r["launches"] for c, r in fp32_training.items()},
               "training-long-flash": long_training["launches"], "serving-fp32": fp32_serving["launches"],
               "invariance-fp32": fp32_invariance["launches"],
               "serving-long": long_serving["launches"], "serving-44k1": serving_44k1["launches"],
               "serving-48k-hop960": serving_48k["launches"],
               **{f"training-{k}": r["launches"] for k, r in variants["training"].items()},
               **{f"serving-{k}": r["launches"] for k, r in variants["serving"].items()},
               **{f"invariance-{k}": r["launches"] for k, r in variants["invariance"].items()},
               "serving-d2048": wide["serving"]["launches"], "invariance-d2048": wide["invariance"]["launches"],
               **export["by_path"]}
    # the 3xTF32 K5 takes fp32 alone: no bf16 or fp16 path launches it, and every fp32 path does
    tf32_paths = {p: (n["fused_attention_tf32"], n["fused_attention_bwd_tf32"]) for p, n in by_path.items()
                  if "fp32" not in p and (n["fused_attention_tf32"] or n["fused_attention_bwd_tf32"])}
    # every kernel row this run timed by device kernel: none may be a retired design's kernel
    rows = [*(r for v in domain["attention"].values() for r in v.values()), *domain["ffn"].values(),
            *domain["ffn_more"].values(), *ffn_train.values(), *repairs["attention_rows"].values(),
            *(v for k, v in repairs_fp16.items() if k.startswith("attention_rows")),
            *(v for k, v in repairs_fp32.items() if k.startswith("attention_rows")),
            *(v for k, v in wide["kernels"].items() if k.startswith("attention_rows"))]
    device = {n for r in rows for part in (r, r.get("valid_keys", {})) for n in part.get("device_ms", {})}
    retired = sorted(n for n in device if any(k in n for k in RETIRED))
    split_paths = ("serving-2heads", "invariance-2heads", "serving-d2048", "invariance-d2048", "serving-fp32",
                   "invariance-fp32")
    fail_unless("routes", {
        "no bf16 or fp16 path launches the 3xTF32 K5": not tf32_paths,
        "the fp32 paths launch the 3xTF32 K5f": all(by_path[p]["fused_attention_tf32"] for p in (
            "training-fp32-flash", "serving-fp32", "invariance-fp32")),
        "fp32 flash training launches the 3xTF32 K5b": by_path["training-fp32-flash"]["fused_attention_bwd_tf32"] > 0,
        "fp32 fused-ffn training launches the 3xTF32 K4 8 times a step":
            by_path["training-fp32-fused-ffn"]["ffn_dropout_tf32"] == 8 * FP32_STEPS,
        "no other path launches the 3xTF32 K4": not [p for p, n in by_path.items() if n["ffn_dropout_tf32"]
                                                     and p != "training-fp32-fused-ffn"],
        "the fp32, 2-head and d-2,048 decode paths launch attention_rows' split-key design":
            all(by_path[p]["attention_rows_split"] for p in split_paths),
        "no path launches a retired kernel (CUDA-core K5, FMA K4, CUDA-core attention_rows)": not retired,
        "the fp32 decode paths launch the product kernel": all(by_path[p]["linear"] for p in ("serving-fp32",
                                                                                              "invariance-fp32")),
        "every fp32 product row ran the strip design": all(
            n.startswith("void linear_f32_kernel<") for r in repairs_fp32["linear"].values() for n in r["device_ms"])},
        {"tf32_paths": tf32_paths, "retired": retired})

    def entry(kname, source, replaces, shape, res):
        keys = ("max_abs_err", "tol", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
        per_path = {p: n[kname] for p, n in by_path.items()}  # every run counts every kernel
        return {"name": kname, "route": "cuda", "source": source, "replaces": replaces,
                "launches": sum(per_path.values()), "launches_by_path": per_path, "shape": shape,
                **{k: res[k] for k in keys}, **{k: res[k] for k in ("device_ms", "library_device_ms") if k in res}}

    emit({"kernels": [
        {**entry("log_mel", "adt_str_tpu_torch/csrc/log_mel.cu", "adt_str_tpu/ops/pallas_mel.py:112 pallas_log_mel",
                 f"B={TRAIN_BATCH} chunks of 2.56 s (training; largest serving bucket)", mel[TRAIN_BATCH]),
         "at_clap_frontend": {
             "replaces": "adt_str_tpu/clap/features.py:81-90 _device_mel -> pallas_log_mel",
             "shape": f"B={CLAP_BATCH} x 480000 (10 s at 48 kHz), n_fft 1024, hop 480, 64 mels, dB, no trim",
             "launches": clap["in_process"]["launches"]["log_mel"],
             **{k: clap["k1"][k] for k in ("max_abs_err", "tol", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                                           "library_ms")}}},
        {**entry("fused_attention", "adt_str_tpu_torch/csrc/attention.cu",
                 "adt_str_tpu/ops/pallas_attention.py:99 _fwd",
                 f"B={TRAIN_BATCH}, 6 heads, decoder self 511 x 511, causal + padding mask", att_train["decoder-self"]),
         "at_3_heads": tp_entry(tp, "fused_attention"),
         "past_512_keys": {s: at_shape(domain["attention"][f"bf16-{s}"]["fwd"]) for s in LONG_ATTENTION},
         "fp16": {s: at_shape(domain["attention"][f"float16-{s}"]["fwd"]) for s in TRAIN_ATTENTION}},
        {**entry("fused_attention_bwd", "adt_str_tpu_torch/csrc/attention_bwd.cu",
                 "adt_str_tpu/ops/pallas_attention.py:156 _vjp_bwd",
                 f"B={TRAIN_BATCH}, 6 heads, decoder self 511 x 511, causal + padding mask", bwd_train["decoder-self"]),
         "at_3_heads": tp_entry(tp, "fused_attention_bwd"),
         "past_512_keys": {s: at_shape(domain["attention"][f"bf16-{s}"]["bwd"]) for s in LONG_ATTENTION},
         "fp16": {s: at_shape(domain["attention"][f"float16-{s}"]["bwd"]) for s in TRAIN_ATTENTION}},
        {**entry("fused_attention_d256", "adt_str_tpu_torch/csrc/attention.cu (D 256)",
                 "adt_str_tpu/ops/pallas_attention.py:99 _fwd",
                 f"bf16, B={TRAIN_BATCH}, 3 heads of 256, decoder self 511 x 511, causal + padding mask",
                 domain["attention"]["bfloat16-d256-decoder-self"]["fwd"]),
         "fp16": at_shape(domain["attention"]["float16-d256-decoder-self"]["fwd"])},
        {**entry("fused_attention_bwd_d256", "adt_str_tpu_torch/csrc/attention_bwd.cu (D 256)",
                 "adt_str_tpu/ops/pallas_attention.py:156 _vjp_bwd",
                 f"bf16, B={TRAIN_BATCH}, 3 heads of 256, decoder self 511 x 511, causal + padding mask",
                 domain["attention"]["bfloat16-d256-decoder-self"]["bwd"]),
         "fp16": at_shape(domain["attention"]["float16-d256-decoder-self"]["bwd"])},
        {**entry("ffn_dropout", "adt_str_tpu_torch/csrc/ffn_dropout.cu",
                 "adt_str_tpu/ops/pallas_ffn.py:132 _fwd_call",
                 f"N={TRAIN_FFN_ROWS['decoder']} rows (B={TRAIN_BATCH} x 511), d 768, d_ff 3072", ffn_train["decoder"]),
         "partial_d_ff_1536": {c: tp_entry(tp, "ffn_dropout", c) for c in (0, 1536)},
         **{k: {"shape": f"N={TRAIN_FFN_ROWS['decoder']} rows, d 768, {k}", **at_shape(v)}
            for k, v in domain["ffn_more"].items() if not k.startswith("fp32")}},
        {**entry("log_mel_any_hop", "adt_str_tpu_torch/csrc/log_mel.cu (route any_hop)",
                 "adt_str_tpu/ops/pallas_mel.py:112 pallas_log_mel",
                 "B=16 chunks of 2.56 s at 44.1 kHz, hop 441, n_fft 2048", domain["mel"]["44100-hop441"]),
         "at_22050_hop_220": at_shape(domain["mel"]["22050-hop220"])},
        entry("log_mel_long_hop", "adt_str_tpu_torch/csrc/log_mel.cu (route long_hop)",
              "adt_str_tpu/ops/pallas_mel.py:112 pallas_log_mel",
              "B=16 chunks of 2.56 s at 48 kHz, hop 960, n_fft 2048", domain["mel"]["48000-hop960"]),
        {**entry("fused_attention_tf32", "adt_str_tpu_torch/csrc/attention_tf32.cu",
                 "adt_str_tpu/ops/pallas_attention.py:99 _fwd",
                 f"fp32, B={TRAIN_BATCH}, 6 heads, decoder self 511 x 511, causal + padding mask",
                 domain["attention"]["fp32-decoder-self"]["fwd"]),
         "other_shapes": {k: at_shape(v["fwd"]) for k, v in domain["attention"].items()
                          if v["fwd"]["kernel"] == "fused_attention_tf32" and k != "fp32-decoder-self"}},
        {**entry("fused_attention_bwd_tf32", "adt_str_tpu_torch/csrc/attention_tf32.cu",
                 "adt_str_tpu/ops/pallas_attention.py:156 _vjp_bwd",
                 f"fp32, B={TRAIN_BATCH}, 6 heads, decoder self 511 x 511, causal + padding mask",
                 domain["attention"]["fp32-decoder-self"]["bwd"]),
         "other_shapes": {k: at_shape(v["bwd"]) for k, v in domain["attention"].items()
                          if "bwd" in v and v["bwd"]["kernel"] == "fused_attention_bwd_tf32"
                          and k != "fp32-decoder-self"}},
        {**entry("fused_attention_wide", "adt_str_tpu_torch/csrc/attention_wide.cu",
                 "adt_str_tpu/ops/pallas_attention.py:99 _fwd",
                 f"bf16, B={TRAIN_BATCH}, 2 heads of 384, decoder self 511 x 511, causal + padding mask",
                 domain["attention"]["bfloat16-d384-decoder-self"]["fwd"]),
         "other_shapes": {k: at_shape(v["fwd"]) for k, v in domain["attention"].items()
                          if v["fwd"]["kernel"] == "fused_attention_wide" and k != "bfloat16-d384-decoder-self"}},
        {**entry("fused_attention_bwd_wide", "adt_str_tpu_torch/csrc/attention_wide.cu",
                 "adt_str_tpu/ops/pallas_attention.py:156 _vjp_bwd",
                 f"bf16, B={TRAIN_BATCH}, 2 heads of 384, decoder self 511 x 511, causal + padding mask",
                 domain["attention"]["bfloat16-d384-decoder-self"]["bwd"]),
         "other_shapes": {k: at_shape(v["bwd"]) for k, v in domain["attention"].items()
                          if "bwd" in v and v["bwd"]["kernel"] == "fused_attention_bwd_wide"
                          and k != "bfloat16-d384-decoder-self"}},
        {**entry("ffn_dropout_tf32", "adt_str_tpu_torch/csrc/ffn_dropout_tf32.cu",
                 "adt_str_tpu/ops/pallas_ffn.py:132 _fwd_call",
                 f"fp32, N={TRAIN_FFN_ROWS['decoder']} rows (B={TRAIN_BATCH} x 511), d 768, d_ff 3072",
                 domain["ffn"]["decoder"]),
         "encoder_rows": at_shape(domain["ffn"]["encoder"]),
         "d_ff_1036": {"shape": f"N={TRAIN_FFN_ROWS['decoder']} rows, d 768, d_ff 1036",
                       **at_shape(domain["ffn_more"]["fp32-d_ff1036"])}},
        entry("gather_blend", "adt_str_tpu_torch/csrc/gather_blend.cu",
              "adt_str_tpu/synth/pallas_place.py:99 gather_blend",
              f"N={TRAIN_BATCH} x 27 requests of 30720 bf16 from a 100,035-row bank (5.72 GiB)",
              synth["gather_blend"]),
        entry("place_notes", "adt_str_tpu_torch/csrc/place_notes.cu",
              "adt_str_tpu/synth/pallas_place.py:189 place_notes",
              f"B={TRAIN_BATCH}, 128 note slots, 27 blend rows of 30720 bf16, chunk 61440", synth["place_notes"]),
        # the batch-invariance kernels: no pallas_call is behind them; `replaces` names the JAX function whose
        # arithmetic each computes on the port's inference path
        {**entry("layer_norm", "adt_str_tpu_torch/csrc/layer_norm.cu",
                 "none (no pallas_call; a batch-invariance repair): adt_str_tpu/models/transformer.py:113 layer_norm",
                 f"decode step, bucket {bucket}: LayerNorm(x + r), the residual add fused, {bucket} rows of 768 bf16",
                 repairs["add_layer_norm"]["decode"]),
         "one_input": {k: repairs["layer_norm"]["decode"][k] for k in ("max_abs_err", "tol", "ms", "plain_ms",
                                                                       "bound_ms", "bound_by", "library_ms")},
         "encoder_fused": {k: repairs["add_layer_norm"]["encoder"][k] for k in ("max_abs_err", "ms", "device_ms",
                                                                                "plain_ms", "bound_ms", "library_ms",
                                                                                "unfused_ms", "unfused_device_ms")},
         "fp16": at_shape(repairs_fp16["add_layer_norm"]), "fp16_one_input": at_shape(repairs_fp16["layer_norm"]),
         "fp32": at_shape(repairs_fp32["add_layer_norm"]),
         "d2048": at_shape(wide["kernels"]["add_layer_norm"]),
         "d2048_one_input": at_shape(wide["kernels"]["layer_norm"])},
        {**entry("linear", "adt_str_tpu_torch/csrc/linear.cu",
                 "none (no pallas_call; a batch-invariance repair): adt_str_tpu/models/transformer.py:105 linear",
                 f"decode FFN linear1, bucket {bucket}: ({bucket}, 768) x (3072, 768)^T bf16",
                 repairs["linear"]["decode"]),
         "fp16": at_shape(repairs_fp16["linear"]),
         "fp32": {"source": "adt_str_tpu_torch/csrc/linear.cu linear_f32_kernel (strips of columns, chains of FMAs)",
                  "launches": by_path["serving-fp32"]["linear"] + by_path["invariance-fp32"]["linear"],
                  **at_shape(repairs_fp32["linear"]["decode"]),
                  "other_shapes": {k: at_shape(v) for k, v in repairs_fp32["linear"].items() if k != "decode"}}},
        {**entry("attention_rows", "adt_str_tpu_torch/csrc/attention_rows.cu",
                 "none (no pallas_call; a batch-invariance repair): adt_str_tpu/models/transformer.py:223 "
                 "attention_core",
                 f"decode self-attention, bucket {bucket}: 6 heads, 1 query over the "
                 f"{repairs['attention_rows']['decode_self']['valid_keys']['keys']} valid of 512 cached keys "
                 f"(valid_keys, bit-equal to the masked read of all 512), bf16",
                 {**repairs["attention_rows"]["decode_self"], **repairs["attention_rows"]["decode_self"]["valid_keys"]}),
         "fp16": at_shape(repairs_fp16["attention_rows"])},
        {**entry("attention_rows_split", "adt_str_tpu_torch/csrc/attention_rows.cu (split-key design)",
                 "none (no pallas_call; a batch-invariance repair): adt_str_tpu/models/transformer.py:223 "
                 "attention_core",
                 f"decode self-attention at d_model 2,048, bucket {bucket}: 1 head of 2,048, 1 query over the "
                 f"{wide['kernels']['attention_rows_self']['valid_keys']['keys']} valid of 512 cached keys "
                 f"(valid_keys), bf16",
                 {**wide["kernels"]["attention_rows_self"], **wide["kernels"]["attention_rows_self"]["valid_keys"]}),
         "masked_read_d2048": at_shape(wide["kernels"]["attention_rows_self"]),
         "cross_fp16_d2048": at_shape(wide["kernels"]["attention_rows_cross_fp16"]),
         **{k: at_shape(repairs_fp16[k]) for k in ("attention_rows_d384", "attention_rows_d384_cross_fp16")},
         **{f"fp32_{k}": at_shape(v) for k, v in repairs_fp32.items() if k.startswith("attention_rows")}},
    ], "serving_bucket": bucket, "serving_at_bucket": {"log_mel": mel[bucket]["ms"], "fused_attention": att[bucket]["ms"]},
        "total_s": round(time.monotonic() - t_start, 3)})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--fp32-drift"]:
        sys.exit(fp32_drift())
    sys.exit(compare_trees(sys.argv[1:]) if len(sys.argv) > 1 else main())
