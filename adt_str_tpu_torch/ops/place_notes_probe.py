"""Where K3's time goes: `python -m adt_str_tpu_torch.ops.place_notes_probe`
on the machine with the card.

Builds `csrc/place_notes.cu` as shipped and in variants made by editing its
source text (each edit must find its anchor, or the probe fails), runs each
on the same inputs at the training shape (B 64, 27 bf16 rows of 30720, 128
note slots with 8-128 sounding, chunk 61440) and prints one JSON line per
variant with its device time (torch.profiler, mean of 12 calls, two rounds)
and whether it is bit-equal to the plain version. The variants:

- `start16`: each copy starts on the 16-byte boundary at or before the
  note's first sample, instead of the 128-byte one;
- `tile4096`: 256 consumer threads (4096-sample tiles, 3 blocks an SM);
- `ring12`: 12 slots a block (4 blocks an SM);
- `copies_only`: the consumers skip the adds (wrong output: attribution);
- `adds_only`: no copies, the slots are released at once (wrong output);
- `one_row`: every window copied from segment 0's first row, which stays
  in L2 (wrong output: is the source's place in memory what binds?);
- `reversed`: the last tile of a segment first (its tiles overlap the
  most notes);
- `stream_stores`: the output written with evict-first stores (`__stcs`);
- `evict_last`: the copies carry an L2 evict-last policy.

Last, the L2 rate of a `copy_` of 2 x 8 MiB and the device-memory rate of
2 x 1 GiB (read plus written over the copy kernel's device time).
"""

from __future__ import annotations

import ctypes
import json
import subprocess

import torch

from adt_str_tpu_torch.ops import _build
from adt_str_tpu_torch.ops.place import place_notes_plain

_EVICT_LAST = """
__device__ __forceinline__ void bulk_load_evict_last(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(policy));
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint [%0], [%1], %2, [%3], %4;"
               ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_addr(bar)),
               "l"(policy) : "memory");
}
"""
EDITS = {
    "shipped": [],
    "start16": [("const int ja = jlo & ~63,", "const int ja = jlo & ~7,"),
                ("constexpr int SLOT_ELEMS = TILE + 64;", "constexpr int SLOT_ELEMS = TILE + 8;")],
    "tile4096": [("constexpr int CONSUMER_WARPS = 4;", "constexpr int CONSUMER_WARPS = 8;"),
                 ("__launch_bounds__(THREADS, 6)", "__launch_bounds__(THREADS, 3)")],
    "ring12": [("constexpr int RING = 8;", "constexpr int RING = 12;"),
               ("__launch_bounds__(THREADS, 6)", "__launch_bounds__(THREADS, 4)")],
    "copies_only": [("if (w.lo == 0 && w.hi == len) {", "if (true) {} else if (w.lo == 0 && w.hi == len) {")],
    "adds_only": [("mbar_arrive_expect_tx(&full[s], (jb - ja) * 2);", "mbar_arrive(&full[s]);"),
                  ("bulk_load_1d(ring + s * SLOT_ELEMS, rows + static_cast<long long>(sl) * L + ja, (jb - ja) * 2, "
                   "&full[s]);", "")],
    "one_row": [("rows + static_cast<long long>(sl) * L + ja", "blend + ja")],
    "reversed": [("const int t0 = blockIdx.x * TILE;", "const int t0 = (gridDim.x - 1 - blockIdx.x) * TILE;")],
    "stream_stores": [("dst[u] = acc[i];", "__stcs(&dst[u], acc[i]);")],
    "evict_last": [("using namespace hopper;", "using namespace hopper;" + _EVICT_LAST),
                   ("bulk_load_1d(ring", "bulk_load_evict_last(ring")],
}
B, S, L, N, CHUNK, REPS = 64, 27, 30720, 128, 61440, 12


def build_variants() -> dict:
    src = (_build.CSRC / "place_notes.cu").read_text()
    out = _build.BUILD_DIR.parent / "place_notes_probe"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in EDITS.items():
        text = src
        for anchor, repl in edits:
            if anchor not in text:
                raise RuntimeError(f"variant {name}: {anchor!r} is not in csrc/place_notes.cu")
            text = text.replace(anchor, repl)
        (out / f"{name}.cu").write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(out / f"lib{name}.so"),
               str(out / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        fn = ctypes.CDLL(str(out / f"lib{name}.so")).launch_place_notes
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def inputs(seed: int = 0) -> list:
    g = torch.Generator(device="cuda").manual_seed(seed)
    out = []
    for _ in range(REPS):
        blend = (torch.randn(B, S, L, generator=g, device="cuda") * 0.3).to(torch.bfloat16)
        slot = torch.randint(0, S, (B, N), generator=g, device="cuda", dtype=torch.int32)
        onset = torch.randint(0, CHUNK, (B, N), generator=g, device="cuda", dtype=torch.int32)
        count = torch.randint(8, N + 1, (B,), generator=g, device="cuda")
        sounding = torch.arange(N, device="cuda")[None] < count[:, None]
        gain = torch.where(sounding, torch.rand(B, N, generator=g, device="cuda") + 0.1, 0.0)
        out.append((blend, slot, onset, gain))
    return out


def device_ms(fn, args: list, key: str) -> float:
    """Mean device time of the kernels named `key` per call; a profiler
    session that records none of them is taken again, 3 times at most."""
    fn(*args[0])
    torch.cuda.synchronize()
    for _ in range(3):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for a in args:
                fn(*a)
            torch.cuda.synchronize()
        total = sum(e.device_time_total for e in prof.key_averages() if key in e.key)
        if total > 0:
            break
    return total / len(args) / 1e3


def main() -> None:
    fns, args = build_variants(), inputs()
    ref = place_notes_plain(*args[0], CHUNK)

    def runner(fn):
        def run(blend, slot, onset, gain):
            out = torch.empty(B, CHUNK, device="cuda")
            err = fn(blend.data_ptr(), slot.data_ptr(), onset.data_ptr(), gain.data_ptr(), out.data_ptr(), B, S, L,
                     N, CHUNK, torch.cuda.current_stream().cuda_stream)
            _build.check(err, "place_notes variant")
            return out
        return run

    times = {name: [] for name in fns}
    for _ in range(2):
        for name, fn in fns.items():
            times[name].append(device_ms(runner(fn), args, "place_notes_kernel"))
    macs = sum(float((torch.clamp(CHUNK - a[2].long(), max=L) * (a[3] != 0)).sum()) for a in args) / REPS
    for name, fn in fns.items():
        print(json.dumps({"variant": name, "device_ms": times[name],
                          "equal_to_plain": bool(torch.equal(runner(fn)(*args[0]), ref)),
                          "mean_multiply_adds": macs}), flush=True)
    for n_bytes in (8 << 20, 1 << 30):
        x = torch.randn(n_bytes // 4, device="cuda")
        y = torch.empty_like(x)
        t = device_ms(lambda *_: y.copy_(x), [()] * REPS, "")
        print(json.dumps({"copy_bytes": n_bytes, "device_ms": t, "bytes_per_s": 2 * n_bytes / (t / 1e3)}), flush=True)


if __name__ == "__main__":
    main()
