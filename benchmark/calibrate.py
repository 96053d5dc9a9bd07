"""The readings the limits of `correct` are set from, on the card at a
cell's own size, many seeds in one process:

    python -m benchmark.calibrate <cell> --seeds 11 12 ... [--controls 3] [--out FILE]

For each seed, the program's sound reading of every number the cell
compares; for the first `--controls` seeds also the control's (the
reference in fp8 put in the program's place: for serving, its own
decode, whose rows go through the same comparison) and each fault the cell
can have, planted in the reference put in the program's place (training:
half the batch left out, the mean over the rest; a state left unchanged
reads 1 by the measure and needs no run) or in the program's output
(serving: one token of each row altered where it is produced). One JSON
line a seed; the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from benchmark import run as bench_run
from benchmark import traffic
from benchmark.drivers import Context, serve_backlog, sync, train_synth


def train_seed(ctx: Context, control: bool) -> dict:
    prog = train_synth.Program(ctx)
    warm = prog.warm_up()
    sync(ctx.device)
    b1 = prog.opt.b1
    prog.free()
    ref = train_synth.follow(prog, warm["rec"])
    out = {"sound": train_synth.numbers(prog.weights, train_synth.program_readings(warm, b1), ref)}
    if control:
        out["control_fp8"] = train_synth.numbers(prog.weights, train_synth.follow(prog, warm["rec"], "fp8"), ref)
        half = slice(0, prog.B // 2)
        out["fault_half_batch"] = train_synth.numbers(prog.weights, train_synth.follow(prog, warm["rec"], rows=half),
                                                      ref)
    del prog
    torch.cuda.empty_cache()
    return out


def first_choice_gap(weights: dict, dims: dict, waves: list, rows: list, block: int, device) -> float:
    """At each position of the program's greedy rows, the gap by which the
    token the fp8 reference puts first lies below the reference's best ->
    the widest."""
    from benchmark.reference import true_fp32
    from benchmark.reference.model import Reference

    widest = 0.0
    with true_fp32(), torch.no_grad():
        ref, low = Reference(weights, dims), Reference(weights, dims, precision="fp8")
        for i in range(0, len(rows), block):
            w = torch.from_numpy(np.stack(waves[i : i + block])).to(device)
            tok = torch.from_numpy(np.stack(rows[i : i + block]).astype(np.int64)).to(device)
            logits = ref.causal_logits(w, tok)
            first = low.causal_logits(w, tok).argmax(-1)
            gap = logits.amax(-1) - torch.gather(logits, -1, first[..., None])[..., 0]
            widest = max(widest, float(gap.max()))
    return widest


def serve_seed(ctx: Context, control: bool, chunks: int | None = None) -> dict:
    """`chunks` chunks of the mix's songs (the mix's sample size by default)
    through the serving driver's own system, in full batches of the largest
    bucket, all held to the reference. The control: the reference's own fp8
    decode of the same chunks, whose rows go through the same comparison;
    for greedy also read, without decoding, along the program's rows."""
    from adt_str_tpu_torch.domain.segmenter import chunk_wave

    mix, dev, seed = ctx.mix, ctx.device, ctx.seed
    system = serve_backlog.build(ctx)
    engine, rule, weights, dims = system["engine"], system["rule"], system["weights"], system["dims"]
    bucket, chunk, sr = engine.buckets[-1], engine.chunk_samples, system["cfg"].shared.sample_rate
    n = -(-(chunks or mix["check_chunks"]) // bucket) * bucket
    waves, lengths = [], traffic.song_seconds(mix, seed, mix["songs"])
    for i in range(10**6):
        length = float(lengths[i % len(lengths)])
        waves += [piece for _, piece, _ in chunk_wave(traffic.song(system["pool"], seed, i, length, sr), chunk)]
        if len(waves) >= n:
            break
    waves = waves[:n]
    rows = [f.result() for f in [engine.submit_chunk(w) for w in waves]]
    engine.close()
    del engine, system
    torch.cuda.empty_cache()
    block = mix["check_block"]

    def reading(served: list) -> dict:
        return {"served_gap": float(serve_backlog.row_gaps(weights, dims, waves, served, rule, block, dev).max())}

    out = {"chunks": n, "sound": reading(rows)}
    if control:
        low = serve_backlog.reference_beams(weights, dims, waves, rule, mix["beam_block"], dev, precision="fp8")
        out["control_fp8"] = reading(list(low[:, 0].numpy()))
        if rule["K"] == 1:
            out["control_fp8_first"] = {"served_gap": first_choice_gap(weights, dims, waves, rows, block, dev)}
        altered = []
        for row in rows:
            row = row.copy()
            row[len(row) // 2] = (row[len(row) // 2] + 1) % dims["vocab"]
            altered.append(row)
        out["fault_token_altered"] = reading(altered)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="readings for the limits of correct, on the card")
    parser.add_argument("cell")
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--controls", type=int, default=3, help="seeds (the first ones) that also run the control")
    parser.add_argument("--chunks", type=int, default=None, help="serving: chunks compared (the mix's sample size)")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    bench_run._environment()
    _, cell, config, mix = bench_run.load_cell(args.cell)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    kind = train_seed if mix["kind"] == "train_synth" else \
        (lambda ctx, control: serve_seed(ctx, control, args.chunks))
    sink = open(args.out, "a") if args.out else None
    try:
        for k, seed in enumerate(args.seeds):
            t = time.monotonic()
            ctx = Context(seed=seed, seconds=0.0, trace=False, device=torch.device("cuda:0"), config=config, mix=mix,
                          t_start=t, work_dir=bench_run.WORK)
            line = {"cell": args.cell, "seed": seed, **kind(ctx, k < args.controls),
                    "seconds": time.monotonic() - t}
            print(json.dumps(line), flush=True)
            if sink:
                sink.write(json.dumps(line) + "\n")
                sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
