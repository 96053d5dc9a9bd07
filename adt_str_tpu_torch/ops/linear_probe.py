"""Where the fp32 product's time goes: `python -m adt_str_tpu_torch.ops.linear_probe`
on the machine with the card.

Builds `csrc/linear.cu` as shipped and in variants made by editing its
source text (each edit must find its anchor, or the probe fails), runs each
fp32 route through its C entry point at the decode step's shapes (bucket
16: the in-projection, the 768 -> 768 projections, FFN 1 and 2, the
generator; the beam's in-projection at 80 rows) on 12 sets of inputs (a W
each, so W is read from device memory, not L2) and prints one JSON line a
shape with each variant's device time (torch.profiler, mean of 12 calls,
the least of two rounds). The variants:

- `copies_only`: the ring's copies without the products (wrong output);
- `x_copies`, `w_copies`: the same with W's (x's) rows zero-filled instead
  of read, so only x (W) crosses from L2 or device memory;
- `products_only`: the products over whatever the ring holds, no copies
  (wrong output).

Beside them: the FMA chain floor (132 blocks of 128 threads, each thread a
chain of K dependent fmaf, no loads: the least an order-keeping kernel
takes), `F.linear`'s own device kernels on the same inputs (TF32 off), the
bytes bound and whether the shipped variant's outputs are bit-equal to a
run at the first rows alone.
"""

from __future__ import annotations

import ctypes
import json
import subprocess

import torch

from adt_str_tpu_torch.ops import _build

_COPIES_ONLY = [("    for (int kk = 0; kk < BK; kk += 4) {\n      float4 a[RT], b[CT];",
                 "    for (int kk = 0; kk < 0; kk += 4) {\n      float4 a[RT], b[CT];")]
EDITS = {
    "shipped": [],
    "copies_only": _COPIES_ONLY,
    "x_copies": _COPIES_ONLY + [("r < (is_x ? M : n_end);", "r < (is_x ? M : 0);")],
    "w_copies": _COPIES_ONLY + [("r < (is_x ? M : n_end);", "r < (is_x ? 0 : n_end);")],
    "products_only": [
        ("  float acc[RT][CT] = {};\n#pragma unroll\n  for (int s = 0; s < STAGES - 1; ++s) {\n"
         "    if (s < k_tiles) load(s, s);",
         "  float acc[RT][CT] = {};\n#pragma unroll\n  for (int s = 0; s < STAGES - 1; ++s) {\n"
         "    if (false) load(s, s);"),
        ("load((kt + STAGES - 1) % STAGES, kt + STAGES - 1);\n    cp_async_commit();\n    const float* xs",
         "(void)0;\n    cp_async_commit();\n    const float* xs")],
}
CHAIN = r"""
#include <cuda_runtime.h>
__global__ void fma_chain_kernel(float* out, int K, float a, float b) {
  float s = threadIdx.x;
  for (int k = 0; k < K; ++k) s = __fmaf_rn(a, s, b);
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int launch_chain(float* out, int K, void* stream) {
  fma_chain_kernel<<<132, 128, 0, static_cast<cudaStream_t>(stream)>>>(out, K, 0.999f, 0.001f);
  return static_cast<int>(cudaGetLastError());
}
"""
SHAPES = {"in-projection 16 x 768 -> 2304": (16, 2304, 768), "out- / q-projection 16 x 768 -> 768": (16, 768, 768),
          "FFN 1 16 x 768 -> 3072": (16, 3072, 768), "FFN 2 16 x 3072 -> 768": (16, 768, 3072),
          "generator 16 x 768 -> 1400": (16, 1400, 768), "beam in-projection 80 x 768 -> 2304": (80, 2304, 768)}
REPS = 12
PEAK_BYTES = 3.35e12


def build_variants() -> tuple[dict, ctypes.CDLL]:
    src = (_build.CSRC / "linear.cu").read_text()
    out = _build.BUILD_DIR.parent / "linear_probe"
    out.mkdir(parents=True, exist_ok=True)
    sources = {"chain": CHAIN}
    for name, edits in EDITS.items():
        text = src
        for anchor, repl in edits:
            if anchor not in text:
                raise RuntimeError(f"variant {name}: {anchor!r} is not in csrc/linear.cu")
            text = text.replace(anchor, repl)
        sources[name] = text
    procs = {}
    for name, text in sources.items():
        (out / f"{name}.cu").write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(out / f"lib{name}.so"),
               str(out / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(out / f"lib{name}.so"))
    chain = libs.pop("chain")
    chain.launch_chain.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fns = {}
    for name, lib in libs.items():
        fn = lib.launch_linear
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns, chain


def device_ms(fn, args: list) -> float:
    """Mean device time of every kernel `fn` launches, per call; a profiler
    session that records none is taken again, 3 times at most."""
    fn(*args[0])
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(3):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for a in args:
                fn(*a)
            torch.cuda.synchronize()
        total = sum(e.device_time_total for e in prof.key_averages() if e.device_time_total > 0)
        if total > 0:
            break
    return total / len(args) / 1e3


def runner(fn):
    def run(x, w, b):
        y = torch.empty(x.shape[0], w.shape[0], device="cuda")
        _build.check(fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), x.shape[0], w.shape[0], x.shape[1], 0,
                        torch.cuda.current_stream().cuda_stream), "linear variant")
        return y
    return run


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    fns, chain = build_variants()
    g = torch.Generator(device="cuda").manual_seed(0)
    sink = torch.empty(132 * 128, device="cuda")
    for shape, (m, n, k) in SHAPES.items():
        args = [(torch.randn(m, k, generator=g, device="cuda"),
                 torch.randn(n, k, generator=g, device="cuda") / k**0.5,
                 0.1 * torch.randn(n, generator=g, device="cuda")) for _ in range(REPS)]
        times = {name: min(device_ms(runner(fn), args) for _ in range(2)) for name, fn in fns.items()}
        shipped = runner(fns["shipped"])
        full = shipped(*args[0])
        x, w, b = args[0]
        print(json.dumps({
            "shape": shape, "m": m, "n": n, "k": k, "device_ms": times,
            "fma_chain_ms": min(device_ms(lambda *_: chain.launch_chain(sink.data_ptr(), k,
                                                                        torch.cuda.current_stream().cuda_stream),
                                          [()] * REPS) for _ in range(2)),
            "library_device_ms": min(device_ms(torch.nn.functional.linear, args) for _ in range(2)),
            "bound_ms": (m * k + n * k + n + m * n) * 4 / PEAK_BYTES * 1e3,
            "rows_alone_bit_equal": all(torch.equal(shipped(x[:r].contiguous(), w, b), full[:r]) for r in (1, 5))}),
            flush=True)


if __name__ == "__main__":
    main()
