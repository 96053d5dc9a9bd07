"""The kernel build's cache key and `chip_smoke.py`'s attribution of device
time, on the CPU (no nvcc, no card: neither needs one).

`ops/_build.py` names each library by a digest of its source, the shared
headers (`csrc/*.cuh`) and the flags: an edit to a header must rebuild every
kernel and never load a stale library. `chip_smoke._group` must file the
port's own GEMMs (K4) under their kernel, not under the library GEMMs, and
`chip_smoke.device_time_by_group` must fail when a kernel that a profiled
call launched has no device time in the trace. The kernel probes
(`ops/*_probe.py`) edit the shipped sources' text, so each edit's anchor
must still be found there.
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
    """The redesigned kernels include the one header the digest covers."""
    for name in ("ffn_dropout", "attention", "attention_bwd", "log_mel", "place_notes", "linear", "attention_rows",
                 "attention_wide"):
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
        ("void (anonymous namespace)::place_notes_kernel(__nv_bfloat16 const*, int const*, int const*, "
         "float const*, float*, int, int, int, int)", "K3 note placement"),
        ("void (anonymous namespace)::gather_blend_kernel<__nv_bfloat16, true>(__nv_bfloat16 const*, int const*, "
         "int const*, float const*, __nv_bfloat16*, int, int)", "K2 gather + blend"),
        ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_warpgroupsize1x1x1_execute_kernel",
         "GEMM (cuBLAS)"),
        ("nvjet_hsh_128x256_64x4_1x2_h_bz_coopA_NTN", "GEMM (cuBLAS)"),
        ("void (anonymous namespace)::wide_fwd_kernel<__nv_bfloat16>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
         "float const*, __nv_bfloat16*, float*, int, int, int, int, int, float)", "K5f attention fwd"),
        ("void (anonymous namespace)::wide_bwd_kernel<__half>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
         "CUtensorMap_st, float const*, float const*, float const*, float*, float const*, __half*, __half*, __half*, "
         "int, int, int, int, float)", "K5b attention bwd"),
        ("void (anonymous namespace)::wide_delta_kernel<__nv_bfloat16>(__nv_bfloat16 const*, __nv_bfloat16 const*, "
         "__nv_bfloat16 const*, float*, float*, int, int, int)", "K5b attention bwd"),
        ("(anonymous namespace)::attention_tf32_dkdv(float const*, float const*, float const*, float const*, "
         "float const*, float const*, float const*, float*, float*, int, int, int, int, float)", "K5b attention bwd"),
        ("void (anonymous namespace)::attention_tf32_fwd<128, true>(float const*, float const*, float const*, "
         "float const*, float*, float*, int, int, int, int, int, float)", "K5f attention fwd"),
        ("(anonymous namespace)::attention_tf32_dq(float const*, float const*, float const*, float const*, "
         "float const*, float const*, float const*, float*, int, int, int, int, float)", "K5b attention bwd"),
        ("(anonymous namespace)::attention_tf32_delta(float const*, float const*, float*, int, int)",
         "K5b attention bwd"),
    ],
    ids=["k4-gemm1", "k4-gemm2", "k5f", "k5b", "k5b-delta", "k1", "k1-reduce", "k3", "k2", "cublas-sm90",
         "cublas-nvjet", "k5f-wide", "k5b-wide", "k5b-wide-delta", "k5b-fp32", "k5f-fp32", "k5b-fp32-dq",
         "k5b-fp32-delta"],
)
def test_chip_smoke_files_kernels_under_their_group(kernel, group):
    assert _chip_smoke()._group(kernel) == group


def test_chip_smoke_groups_every_kernel_wrapper():
    smoke = _chip_smoke()
    assert smoke.KERNEL_GROUPS.keys() == smoke.kernel_counters().keys()


# a step's trace events as torch.profiler's chrome trace writes them (device
# kernels, a memset, a host op that is not device time)
_EVENTS = [
    {"cat": "kernel", "name": "void (anonymous namespace)::log_mel_kernel(CUtensorMap_st, float const*)", "dur": 440.0},
    {"cat": "kernel", "name": "void (anonymous namespace)::place_notes_kernel(__nv_bfloat16 const*)", "dur": 50.0},
    {"cat": "kernel", "name": "nvjet_hsh_128x256_64x4_1x2_h_bz_coopA_NTN", "dur": 1000.0},
    {"cat": "kernel", "name": "nvjet_hsh_128x256_64x4_1x2_h_bz_coopA_NTN", "dur": 500.0},
    {"cat": "gpu_memset", "name": "Memset (Device)", "dur": 10.0},
    {"cat": "cpu_op", "name": "aten::mm", "dur": 9999.0},
]


def test_device_time_is_filed_under_each_kernel_group():
    res = _chip_smoke().device_time_by_group(_EVENTS, {"log_mel": 1, "place_notes": 1, "ffn_dropout": 0})
    assert res["device_kernels"] == 5
    assert res["by_group_ms"] == pytest.approx({"GEMM (cuBLAS)": 1.5, "K1 log-mel": 0.44, "K3 note placement": 0.05,
                                                "copies, casts": 0.01})
    assert list(res["by_group_ms"])[0] == "GEMM (cuBLAS)"  # largest first
    assert res["device_busy_ms"] == pytest.approx(2.0)
    assert res["top_kernels_ms"][0] == ("nvjet_hsh_128x256_64x4_1x2_h_bz_coopA_NTN", pytest.approx(1.5))


@pytest.mark.parametrize("missing", ["log_mel", "fused_attention_bwd"])
def test_device_time_check_fails_when_a_launched_kernel_is_not_in_the_trace(missing):
    events = [e for e in _EVENTS if "log_mel" not in e["name"]] if missing == "log_mel" else _EVENTS
    with pytest.raises(RuntimeError, match=f"no device time for \\['{missing}'\\]"):
        _chip_smoke().device_time_by_group(events, {"log_mel": 1, "place_notes": 1, missing: 12})


@pytest.mark.parametrize("probe", ["place_notes_probe", "linear_probe"])
def test_probe_edits_find_their_anchors(probe):
    """Each kernel probe builds its variants by editing the shipped source's
    text: every edit's anchor must appear in it exactly once, so an edit of
    the kernel that moves an anchor fails here and not on the card."""
    import importlib

    mod = importlib.import_module(f"adt_str_tpu_torch.ops.{probe}")
    source = (_build.CSRC / f"{probe.removesuffix('_probe')}.cu").read_text()
    for name, edits in mod.EDITS.items():
        for anchor, _ in edits:
            assert source.count(anchor) == 1, (name, anchor)
