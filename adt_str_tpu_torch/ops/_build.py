"""Build and load the hand-written CUDA kernels under `csrc/`.

Each `csrc/<name>.cu` has a plain C interface and is compiled on its own with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC

into `build/kernels/lib<name>-<hash>.so` at the repo root (listed in
`.gitignore`) at first use, then loaded with `ctypes`. The hash covers the
source, the shared headers (`csrc/*.cuh`) and the flags, so an edited source
or header is rebuilt and a stale library is never loaded. The kernels that
use TMA encode their tensor maps with the driver's `cuTensorMapEncodeTiled`,
fetched through `cudaGetDriverEntryPointByVersion`, so nothing links
against libcuda. Pointers and the stream go in as `c_void_p`; each C entry
point returns `cudaGetLastError()`, which `check` raises on. `launch` calls
an entry point on a device's current stream, and `records_grad` says when a
wrapper must leave the call to autograd (no kernel here has a backward).

`register_op` makes a kernel a PyTorch custom op in the `adt_str_tpu_torch`
namespace, so `torch.export` records it in a graph: the kernels that
greedy decoding launches are registered when their modules are imported
(`import adt_str_tpu_torch.ops` imports them all). A wrapper calls its op
only while `torch.compiler.is_exporting()`; the eager path calls the kernel
directly.

With spans on (`utils/spans.py`), each library's first load records
`kernels.load` (ids library, built: whether nvcc ran), over the wait for
nvcc and the library's load, and a build adds one to the counter
`kernels.built`.
This module does not import the spans module: a process that runs an
exported program loads `ops` alone, and has no spans to record.

Only the sources in the repo are compiled: no PyTorch headers (the build
takes seconds, not minutes) and no library of finished kernels.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path
from typing import Callable, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the machine with the card")


def _lib_path(name: str) -> Path:
    """The library of `csrc/<name>.cu`, named by a digest of that source,
    every shared header (`csrc/*.cuh`) and the flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _start(name: str) -> tuple[Path, Path, subprocess.Popen | None]:
    """Start nvcc for `csrc/<name>.cu` into a temporary file unless the
    library exists; -> (library path, temporary path, process or None)."""
    out = _lib_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if out.exists():
        return out, tmp, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return out, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _finish(name: str, out: Path, tmp: Path, proc: subprocess.Popen | None) -> str:
    if proc is None:
        return ""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return log


def build_all() -> dict[str, str]:
    """Compile every `csrc/*.cu` in parallel (one nvcc each, all started
    together); returns each kernel's ptxas report (empty if it was built)."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    with _lock:
        started = {n: _start(n) for n in names}
        return {n: _finish(n, *started[n]) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            out, tmp, proc = _start(name)
            spans = sys.modules.get("adt_str_tpu_torch.utils.spans")
            with spans.span("kernels.load", library=name, built=proc is not None) if spans else \
                    contextlib.nullcontext():
                _finish(name, out, tmp, proc)
                lib = _libs[name] = ctypes.CDLL(str(out))
            if spans and proc is not None:
                spans.count("kernels.built")
        return lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero `cudaError_t` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")


def launch(device: torch.device, fn: Callable[..., int], *args) -> int:
    """`fn(*args, stream)` on `device`'s current stream (its raw handle, an
    int): a kernel's C entry point, whose `cudaError_t` it returns. The
    current device is switched only when `device` is another one."""
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    if index == current:
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(index):
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))


NAMESPACE = "adt_str_tpu_torch"


def register_op(name: str, fn: Callable, fake: Callable):
    """`fn` as the op `torch.ops.adt_str_tpu_torch.<name>`: pure (it mutates
    no input) and without a backward. `fn` launches its kernel on CUDA
    tensors (raising where the kernel does) and runs the plain version on
    CPU tensors, never the one in place of the other; `fake` takes the same
    arguments and returns empty outputs of the real shapes and dtypes, read
    from the inputs' shapes alone (a symbolic batch included), touching no
    data, library or device cache. Returns the op, callable as `fn` is."""
    op = torch.library.custom_op(f"{NAMESPACE}::{name}", fn, mutates_args=())
    op.register_fake(fake)
    return op


def records_grad(*tensors: Optional[torch.Tensor]) -> bool:
    """Whether autograd records an op on these operands: the training path."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)
