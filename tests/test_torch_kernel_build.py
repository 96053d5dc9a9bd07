"""The kernel build's cache key and `chip_smoke.py`'s attribution of device
time, on the CPU (no nvcc, no card: neither needs one).

`ops/_build.py` names each library by a digest of its source, the shared
headers (`csrc/*.cuh`) and the flags: an edit to a header must rebuild every
kernel and never load a stale library. `chip_smoke._group` must file the
port's own GEMMs (K4) under their kernel, not under the library GEMMs.
"""

import sys
from pathlib import Path

import pytest

from adt_str_tpu_torch.ops import _build

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "hopper.cuh").write_text("// shared header v1\n")
    (src / "a.cu").write_text('#include "hopper.cuh"\n// kernel a\n')
    (src / "b.cu").write_text("// kernel b\n")
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return src


@pytest.mark.parametrize("edit", ["header", "new-header", "source", "flags"])
def test_library_path_follows_sources_headers_and_flags(csrc, monkeypatch, edit):
    before = {n: _build._lib_path(n) for n in ("a", "b")}
    assert all(p.parent == _build.BUILD_DIR and p.name.startswith(f"lib{n}-") for n, p in before.items())
    if edit == "header":
        (csrc / "hopper.cuh").write_text("// shared header v2\n")
    elif edit == "new-header":
        (csrc / "other.cuh").write_text("// another header\n")
    elif edit == "source":
        (csrc / "a.cu").write_text('#include "hopper.cuh"\n// kernel a, edited\n')
    else:
        monkeypatch.setattr(_build, "NVCC_FLAGS", (*_build.NVCC_FLAGS, "-lineinfo"))
    after = {n: _build._lib_path(n) for n in ("a", "b")}
    changed = {n for n in before if before[n] != after[n]}
    # every kernel hears of a header or a flag; a source edit rebuilds only its own library
    assert changed == ({"a"} if edit == "source" else {"a", "b"})


def test_library_path_is_stable(csrc):
    assert _build._lib_path("a") == _build._lib_path("a")
    assert _build._lib_path("a") != _build._lib_path("b")


def test_repo_kernels_share_the_hopper_header():
    """The four redesigned kernels include the one header the digest covers."""
    for name in ("ffn_dropout", "attention", "attention_bwd", "log_mel"):
        assert '#include "hopper.cuh"' in (_build.CSRC / f"{name}.cu").read_text()
    assert (_build.CSRC / "hopper.cuh").exists()


def _chip_smoke():
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    return chip_smoke


@pytest.mark.parametrize(
    "kernel, group",
    [
        ("void (anonymous namespace)::ffn_dropout_kernel_gemm1(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
         "CUtensorMap_st, __nv_bfloat16 const*, int, int, int, unsigned int, unsigned int, unsigned int, float)",
         "K4 fused FFN"),
        ("void (anonymous namespace)::ffn_dropout_kernel_gemm2(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
         "__nv_bfloat16 const*, int, int, int, unsigned int, unsigned int, unsigned int, float)", "K4 fused FFN"),
        ("void (anonymous namespace)::attention_fwd_kernel(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
         "CUtensorMap_st, float const*, float*, int, int, int, int, float)", "K5f attention fwd"),
        ("void (anonymous namespace)::attention_bwd_kernel(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
         "CUtensorMap_st, float const*, float const*, float const*, float*, __nv_bfloat16*, __nv_bfloat16*, "
         "__nv_bfloat16*, int, int, int, float)", "K5b attention bwd"),
        ("void (anonymous namespace)::attention_delta_kernel(__nv_bfloat16 const*, __nv_bfloat16 const*, float*, "
         "int)", "K5b attention bwd"),
        ("void (anonymous namespace)::log_mel_kernel(CUtensorMap_st, CUtensorMap_st, float const*, float4 const*, "
         "float*, int, int, int, int, int, int, int, int, int, float, float, float, int)", "K1 log-mel"),
        ("void (anonymous namespace)::log_mel_reduce_kernel(float const*, float*, unsigned long, int, float, float, "
         "float, int)", "K1 log-mel"),
        ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_warpgroupsize1x1x1_execute_kernel",
         "GEMM (cuBLAS)"),
        ("nvjet_hsh_128x256_64x4_1x2_h_bz_coopA_NTN", "GEMM (cuBLAS)"),
    ],
    ids=["k4-gemm1", "k4-gemm2", "k5f", "k5b", "k5b-delta", "k1", "k1-reduce", "cublas-sm90", "cublas-nvjet"],
)
def test_chip_smoke_files_kernels_under_their_group(kernel, group):
    assert _chip_smoke()._group(kernel) == group
