"""The inputs that JAX's gates send to its Pallas kernels, on the port's side,
on the CPU: fp32 and fp16 compute for K4 and K5, keys past 512 and every
head dim that is a multiple of 128 for K5, any d_ff for K4, any hop and
n_fft for K1; and LayerNorm and the decode attention at widths past 1,024.

- each kernel's plain version (which its wrapper runs for CPU tensors, and
  which the card holds each kernel variant to) against the JAX kernel in
  interpret mode, at those inputs;
- a small model (2+2 layers, 2 heads of 128, fp32 compute, every kernel
  flag on, 5.28 s chunks: 518 encoder frames) whose `forward_loss`, gradients
  and greedy tokens match the JAX package's, and the same model at d 384
  with 1 head (head dim 384), whose greedy tokens match;
- a table of (dtype, head dim, keys, d_ff, hop, n_fft) points that JAX's
  gates send to a kernel, each of which the wrappers' published limit
  functions (`cuda_attention.kernel_for`, `cuda_ffn.kernel_for`,
  `cuda_mel.frames_route`) send to the kernel that the routing table
  names, so no ValueError is left on the card that JAX's kernels do not
  have.

Inputs are made with numpy (or JAX's own init) from a seed and fed to both
sides.
"""

import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adt_str_tpu.config import ModelConfig as JModelConfig
from adt_str_tpu.models import adt as jadt
from adt_str_tpu.models import decode as jdecode
from adt_str_tpu.models import transformer as JT
from adt_str_tpu.ops import mel as jmel
from adt_str_tpu.ops.pallas_mel import pallas_log_mel
from adt_str_tpu_torch.config import ModelConfig
from adt_str_tpu_torch.models import decode as tdecode
from adt_str_tpu_torch.models import transformer as TT
from adt_str_tpu_torch.models.adt import ADTModel
from adt_str_tpu_torch.models.convert import state_dict_from_jax_params
from adt_str_tpu_torch.ops import attention_rows, cuda_attention, cuda_ffn, cuda_mel
from adt_str_tpu_torch.ops import ffn as tffn
from adt_str_tpu_torch.ops import mel as tmel
from adt_str_tpu_torch.utils.misc import fp32_products
from test_torch_model import jax_flags_on_memory
from test_torch_train_step import assert_grads_close, jax_site_keys, jbatch, make_batch, tbatch

# Tolerances: fp32 on both sides in other summation orders. K5: outputs 1e-5,
# gradients 1e-4 of each gradient's largest element (as
# test_torch_attention_bwd.py); K1 "norm" outputs 1e-5 (as test_torch_mel.py:
# the same bf16 frames and bases, fp32 sums in another order); K4 as
# test_torch_ffn.py (2e-5 forward, 1e-4 gradients).
OUT_TOL, GRAD_TOL = 1e-5, 1e-4


def _attention_inputs(Tq, Tk, D, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(1, 1, t, D)).astype(np.float32) for t in (Tq, Tk, Tk, Tq)]  # q, k, v, dout
    return [jnp.asarray(a) for a in arrs], [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("Tq, Tk, D, causal", [(1014, 1014, 128, False), (1023, 1023, 128, True),
                                               (60, 100, 256, False), (64, 64, 256, True), (60, 70, 384, False),
                                               (33, 33, 384, True), (40, 57, 512, False), (30, 50, 768, False),
                                               (24, 24, 768, True), (20, 30, 896, False), (17, 17, 1024, True),
                                               (12, 20, 2048, False)],
                         ids=["encoder-1014", "decoder-self-1023", "d256-cross", "d256-causal", "d384-cross",
                              "d384-causal", "d512-cross", "d768-cross", "d768-causal", "d896-cross",
                              "d1024-causal", "d2048-cross"])
def test_k5_plain_fp32_matches_jax_vjp_of_the_interpret_kernel(Tq, Tk, D, causal):
    """fp32 q, k, v past 512 keys and at head dims 256..2,048, through both
    packages' `_flash_attention` (JAX pads to a multiple of 8 and masks the
    padded keys; the port counts them): outputs and the three gradients."""
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _attention_inputs(Tq, Tk, D, seed=Tq + D)
    mask = np.triu(np.full((Tq, Tk), -1e4, np.float32), k=1)[None, None] if causal else None
    jmask = None if mask is None else jnp.asarray(mask)
    ref, vjp = jax.vjp(lambda q, k, v: JT._flash_attention(q, k, v, jmask), jq, jk, jv)
    ref, ref_grads = np.asarray(ref), [np.asarray(g) for g in vjp(jdo)]
    del vjp, jq, jk, jv, jdo  # the interpret kernel's residuals are freed before the port's graph is built
    tq, tk, tv = (t.requires_grad_() for t in (tq, tk, tv))
    assert cuda_attention.kernel_for(tq.dtype, D) == "tf32x3"

    @fp32_products  # true fp32 products, whatever matmul precision a test before this one left set
    def port_side():
        out = TT._flash_attention(tq, tk, tv, None if mask is None else torch.from_numpy(mask))
        out.backward(tdo)
        return out.detach().numpy()

    out = port_side()
    checks = [("out", out, ref, OUT_TOL)] + [(name, t.grad.numpy(), r, GRAD_TOL * np.abs(r).max())
                                              for name, t, r in zip(("dq", "dk", "dv"), (tq, tk, tv), ref_grads)]
    for name, got, r, atol in checks:
        try:
            np.testing.assert_allclose(got, r, atol=atol, rtol=0, err_msg=name)
        except AssertionError as fail:
            raise AssertionError(f"{fail}\n{_k5_witness(tq, tk, tv, mask, out, ref)}") from None


def _k5_witness(q, k, v, mask, out, ref) -> str:
    """Which side of a failed K5 comparison moved: each side's output error
    against the fp64 softmax of the same inputs, and the process settings
    that choose a CPU product's precision and order."""
    s = q.detach().double()[0, 0] @ k.detach().double()[0, 0].T / np.sqrt(q.shape[-1])
    if mask is not None:
        s = s + torch.from_numpy(mask[0, 0]).double()
    exact = (torch.softmax(s, -1) @ v.detach().double()[0, 0]).numpy()
    return (f"out against fp64: port {np.abs(out[0, 0] - exact).max():.3g}, JAX {np.abs(ref[0, 0] - exact).max():.3g}; "
            f"torch matmul precision {torch.get_float32_matmul_precision()!r}, mkldnn fp32 "
            f"{torch.backends.mkldnn.matmul.fp32_precision!r}, {torch.get_num_threads()} threads")


def test_k5_tf32_wrappers_run_plain_for_cpu_tensors():
    _, (q, k, v, do) = _attention_inputs(40, 70, 256, seed=5)
    f0, b0 = cuda_attention.fused_attention_tf32.launches, cuda_attention.fused_attention_bwd_tf32.launches
    out, lse = cuda_attention.fused_attention_tf32(q, k, v, None, 2)
    ref, ref_lse = cuda_attention.attention_plain(q, k, v, None, 2)
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)
    grads = cuda_attention.fused_attention_bwd_tf32(q, k, v, None, out, lse, do)
    refs = cuda_attention.attention_bwd_plain(q, k, v, None, out, lse, do)
    assert all(torch.equal(a, b) for a, b in zip(grads, refs))
    assert (cuda_attention.fused_attention_tf32.launches, cuda_attention.fused_attention_bwd_tf32.launches) == (f0, b0)


def test_new_kernel_wrappers_run_plain_for_cpu_tensors():
    """The split-key decode attention and the 3xTF32 K4 take CPU tensors to
    their plain versions, bit for bit, and leave their counts unmoved."""
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 1, t, 384)).astype(np.float32)) for t in (1, 40, 40))
    a0, f0 = attention_rows.attention_split.launches, cuda_ffn.ffn_dropout_tf32.launches
    assert torch.equal(attention_rows.attention_split(q, k, v, valid_keys=30),
                       attention_rows.attention_plain(q, k, v, None, 30))
    x, w1, w2 = (torch.from_numpy(rng.normal(size=s).astype(np.float32)) for s in ((37, 128), (256, 128), (128, 256)))
    b1, b2 = torch.zeros(256), torch.zeros(128)
    got = cuda_ffn.ffn_dropout_tf32(x, w1, b1, w2, b2, (1, 2, 3, 4), 0.9, 0.9)
    ref = tffn.ffn_dropout_plain(x, w1, b1, w2, b2, (1, 2, 3, 4), 0.9, 0.9)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert (attention_rows.attention_split.launches, cuda_ffn.ffn_dropout_tf32.launches) == (a0, f0)


@pytest.mark.parametrize("hd", [8, 64, 128, 256, 384, 768, 1024, 2048, 4096, 57_000, attention_rows.MAX_FLOATS - 1])
def test_attention_rows_splits_follow_the_head_dim_and_the_keys_alone(hd):
    """The split-key design cuts a row's keys into splits of
    `keys_per_split(hd)`: a function of the head dim alone (so the number of
    splits, ceil(keys / ks), follows the keys read and the head dim, never
    the batch or the rows, and a row keeps its bits in any batch), a power
    of two up to 256 that fits a block's shared memory beside a query row.
    The mma design keeps the 16-bit head dims up to 256 up to the keys its
    block holds (~21,000 at 256); past them the split-key design takes over."""
    ks = attention_rows.keys_per_split(hd)
    assert ks & (ks - 1) == 0 and 1 <= ks <= attention_rows.SPLIT_MAX_KEYS
    assert hd + ks <= attention_rows.MAX_FLOATS
    assert ks == {128: 128, 384: 32, 2048: 32}.get(hd, ks)  # the fp32, 2-head and d-2,048 decode widths
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        for keys in (1, 257, 512, 5990, attention_rows.MAX_FLOATS - hd):
            route = attention_rows.kernel_for(dtype, hd, keys)
            mma = dtype != torch.float32 and hd <= 256 and keys <= attention_rows.mma_max_keys(hd)
            assert route == ("mma" if mma else "split"), (dtype, keys)
    if hd == 256:
        assert attention_rows.mma_max_keys(hd) == 21_120
        assert attention_rows.kernel_for(torch.bfloat16, hd, 21_121) == "split"


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """`cvt.rna.tf32.f32` on fp32 bits: round to 10 mantissa bits, to
    nearest with ties away from zero (add half of the dropped range, then
    clear the low 13 bits)."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as `csrc/attention_tf32.cu` forms it: each operand split into a
    TF32 big part and a TF32 small part, the small terms first, small x
    small dropped (each TF32 x TF32 product is exact in fp32)."""
    ab, bb = _tf32(a), _tf32(b)
    return (torch.matmul(_tf32(a - ab), bb) + torch.matmul(ab, _tf32(b - bb))) + torch.matmul(ab, bb)


def _mm_1xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(_tf32(a), _tf32(b))


def _attention_via(mm, q, k, v, mask, out, lse, do):
    """`attention_plain` and `attention_bwd_plain` (fp32, no virtual keys)
    with every product through `mm`, p and ds included; out and lse of the
    backward are the plain forward's, as the card's backward takes them."""
    scale = 1.0 / np.sqrt(q.shape[-1])
    s = mm(q, k.transpose(-1, -2)) * scale + mask
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    denom = e.sum(dim=-1, keepdim=True)
    got_out, got_lse = mm(e / denom, v), (m + torch.log(denom)).transpose(-1, -2)
    p = torch.exp(s - lse.transpose(-1, -2))
    dp = mm(do, v.transpose(-1, -2))
    ds = p * (dp - (do * out).sum(dim=-1, keepdim=True)) * scale
    grads = (mm(ds, k), mm(ds.transpose(-1, -2), q), mm(p.transpose(-1, -2), do))
    return got_out, got_lse, grads


def _ffn_errors(mm, n: int, product: str) -> float:
    """K4's plain fp32 forward (the model's dropout 0.1) with both products
    through `mm`, against the fp32 plain version: GEMM 1's output `pre`
    (K = d = 768) or GEMM 2's `out` (K = d_ff = 3,072), each over its
    largest element."""
    rng = np.random.default_rng(n)
    d, d_ff = 768, 3072
    x, w1, w2 = (torch.from_numpy(rng.normal(size=s).astype(np.float32)) for s in ((n, d), (d_ff, d), (d, d_ff)))
    w1, w2 = w1 / np.sqrt(d), w2 / np.sqrt(d_ff)
    b1, b2 = (torch.from_numpy(rng.normal(size=s).astype(np.float32)) * 0.1 for s in (d_ff, d))
    seeds = (11, 12, 13, 14)
    ref_out, ref_pre = tffn.ffn_dropout_plain(x, w1, b1, w2, b2, seeds, 0.9, 0.9)
    plain_dot = tffn._dot32
    tffn._dot32 = lambda a, b: mm(a.float(), b.float())
    try:
        out, pre = tffn.ffn_dropout_plain(x, w1, b1, w2, b2, seeds, 0.9, 0.9)
    finally:
        tffn._dot32 = plain_dot
    got, ref = (pre, ref_pre) if product == "gemm1" else (out, ref_out)
    return ((got - ref).abs().max() / ref.abs().max()).item()


@pytest.mark.parametrize("Tq, Tk, D", [(1023, 1023, 128), (64, 64, 256), (17, 17, 1024), (512, 768, "gemm1"),
                                       (512, 3072, "gemm2")],
                         ids=["d128-1023", "d256-64", "d1024-17", "k4-gemm1-k768", "k4-gemm2-k3072"])
def test_3xtf32_products_keep_the_fp32_tolerances_and_1xtf32_does_not(Tq, Tk, D):
    """The 3xTF32 kernels' arithmetic, emulated on the CPU: every product of
    the plain forward and backward formed in 3xTF32 stays within the card's
    fp32 tolerances of the fp32 plain version (out 1e-5, lse 1e-4, each
    gradient 1e-5 of its largest element, as chip_smoke's `attention_tols`),
    and in plain TF32 (one product, operands rounded) it does not. K4's two
    products (`csrc/ffn_dropout_tf32.cu`, N 512 rows: GEMM 1 at K 768, GEMM
    2 at K 3,072): pre and out within 1e-5 of their largest element in
    3xTF32, not in TF32."""
    if isinstance(D, str):
        three, one = _ffn_errors(_mm_3xtf32, Tq, D), _ffn_errors(_mm_1xtf32, Tq, D)
        assert three <= 1e-5 < one, (three, one)
        return
    _, (q, k, v, do) = _attention_inputs(Tq, Tk, D, seed=Tq + D + 1)
    mask = torch.from_numpy(np.triu(np.full((Tq, Tk), -1e4, np.float32), k=1))[None]
    out, lse = cuda_attention.attention_plain(q, k, v, mask)
    refs = cuda_attention.attention_bwd_plain(q, k, v, mask, out, lse, do)

    def errors(mm):
        got_out, got_lse, grads = _attention_via(mm, q, k, v, mask[:, None], out, lse, do)
        return ((got_out - out).abs().max().item(), (got_lse - lse).abs().max().item(),
                max(((g - r).abs().max() / r.abs().max()).item() for g, r in zip(grads, refs)))

    limits = (1e-5, 1e-4, 1e-5)
    three, one = errors(_mm_3xtf32), errors(_mm_1xtf32)
    assert all(e <= lim for e, lim in zip(three, limits)), three
    assert not all(e <= lim for e, lim in zip(one, limits)), one


D_K4, RATE = 256, 0.1


def test_k4_fp32_plain_matches_pallas_interpret():
    """`ffn_dropout_fp32`'s plain version (fp32 operands, the model's
    dropout 0.1) against the JAX kernel in interpret mode: forward, zero
    pattern and every gradient, through `ffn_dropout_block` on both sides."""
    kp, kx, kh, ko = jax.random.split(jax.random.PRNGKey(3), 4)
    p = JT.ffn_init(kp, D_K4, 4 * D_K4)
    x = jax.random.normal(kx, (2, 37, D_K4), jnp.float32)

    def jloss(p, x):
        return jnp.sum(jnp.sin(JT.ffn_dropout_block(p, x, RATE, kh, ko, interpret=True)))

    ref = np.asarray(JT.ffn_dropout_block(p, x, RATE, kh, ko, interpret=True))
    gp, gx = jax.grad(jloss, argnums=(0, 1))(p, x)
    layer = torch.nn.Module()
    layer.linear1, layer.linear2 = torch.nn.Linear(D_K4, 4 * D_K4), torch.nn.Linear(4 * D_K4, D_K4)
    with torch.no_grad():
        for name in ("linear1", "linear2"):
            getattr(layer, name).weight.copy_(torch.from_numpy(np.asarray(p[name]["w"]).T.copy()))
            getattr(layer, name).bias.copy_(torch.from_numpy(np.array(p[name]["b"])))
    tx = torch.from_numpy(np.array(x)).requires_grad_()
    words = [tuple(int(w) for w in np.asarray(jax.random.key_data(k)).reshape(-1)) for k in (kh, ko)]
    assert cuda_ffn.kernel_for(tx.dtype, D_K4, 4 * D_K4) == "tf32x3"
    out = TT.ffn_dropout_block(layer, tx, RATE, *words)
    np.testing.assert_array_equal(out.detach().numpy() == 0.0, ref == 0.0)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=2e-5, atol=2e-5)
    torch.sin(out).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=1e-4, atol=1e-4)
    for name in ("linear1", "linear2"):
        mod = getattr(layer, name)
        np.testing.assert_allclose(mod.weight.grad.numpy().T, np.asarray(gp[name]["w"]), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(mod.bias.grad.numpy(), np.asarray(gp[name]["b"]), rtol=1e-4, atol=1e-4)


# (sample rate, hop, n_fft): 44.1 and 22.05 kHz at time_res 0.01 (hops not
# multiples of 8), 48 kHz at 0.02 (a window past shared memory), and an
# n_fft that is not a multiple of 64
MEL_CASES = {"44k1-hop441": (44100, 441, 2048), "22k05-hop220": (22050, 220, 2048),
             "48k-hop960": (48000, 960, 2048), "44k1-nfft2000": (44100, 441, 2000)}
MEL_ROUTES = {"44k1-hop441": "any_hop", "22k05-hop220": "any_hop", "48k-hop960": "long_hop", "44k1-nfft2000": "any_hop"}


@pytest.mark.parametrize("case", list(MEL_CASES))
def test_k1_plain_at_any_hop_matches_pallas_interpret(case):
    sr, hop, n_fft = MEL_CASES[case]
    kw = dict(sample_rate=sr, win_length=n_fft, hop_length=hop, n_mels=128)
    rng = np.random.default_rng(hop)
    t = np.arange(int(0.8 * sr)) / sr
    wave = np.stack([0.5 * np.sin(2 * np.pi * 330 * t) + 0.05 * rng.normal(size=t.shape),
                     0.2 * rng.normal(size=t.shape)]).astype(np.float32)
    ref = np.asarray(pallas_log_mel(jnp.asarray(wave), jmel.MelFrontendParams(**kw), interpret=True))
    params = tmel.MelFrontendParams(**kw)
    assert cuda_mel.frames_route(params) == MEL_ROUTES[case]
    out = cuda_mel.log_mel(torch.from_numpy(wave), params).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


# The small model: 2 heads of 128 (d 256), fp32, every kernel flag on, 5.28 s
# at 4 kHz with hop 40 and win 320: 1 + 528 frames less 2 * 5 + 1 trimmed =
# 518 encoder frames, past the 512 keys the card's K5 once took.
SMALL = dict(sample_rate=4000, win_length=320, time_res=0.01, input_sec=5.28, enc_layers=2, dec_layers=2,
             nhead=2, d_query=128, tgt_vocab_size=40, n_mels=16, compute_dtype="float32", max_positions=1024,
             use_pallas_mel=True, use_flash_attention=True, use_pallas_ffn=True)


def _build(kw, seed=0):
    jcfg, tcfg = JModelConfig(**kw), ModelConfig(**kw)
    params = jadt.init_params(jax.random.PRNGKey(seed), jcfg)
    model = ADTModel(tcfg, device="cpu")
    model.load_state_dict(state_dict_from_jax_params(jax.tree.map(np.asarray, params)), strict=True)
    return params, jcfg, model, tcfg


def test_small_model_has_518_frames_and_takes_every_kernel():
    cfg = ModelConfig(**SMALL)
    params = tmel.MelFrontendParams(sample_rate=4000, win_length=320, hop_length=40, n_mels=16)
    assert params.out_frames(cfg.chunk_samples) == 518
    assert cuda_attention.kernel_for(torch.float32, cfg.d_model // cfg.nhead) == "tf32x3"
    assert cuda_ffn.kernel_for(torch.float32, cfg.d_model, cfg.ffn_dim) == "tf32x3"
    assert cuda_mel.frames_route(params) == "ldmatrix"


@pytest.mark.parametrize("dropout", [0.0, 0.1], ids=["k5-trains", "k4-trains"])
def test_small_model_forward_loss_and_grads_match_jax(dropout):
    """Train mode: at dropout 0 the attention runs K5's forward and backward
    (plain versions here) over 518 keys; at 0.1 the FFN runs K4 (the
    attention keeps its probability dropout, as in JAX). JAX's
    `forward_loss` takes its XLA path on the CPU, which computes the same
    function (`test_torch_train_step.py`); K1 stays on the XLA rfft there,
    so the port's mel flag is off for the loss (no gradient reaches it)."""
    kw = dict(SMALL, dropout=dropout, use_pallas_mel=False)
    params, jcfg, model, tcfg = _build(kw)
    b = make_batch(tcfg, B=2, T=20, seed=1)
    jb = jbatch(b)
    rng = jax.random.PRNGKey(5)

    def jloss(p):
        return jadt.forward_loss(p, jb["wavs"], jb["tokens"], jb["token_lengths"], jcfg, rng=rng, train=True)

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jloss))(params)
    tb = tbatch(b)
    loss = model.forward_loss(tb["wavs"], tb["tokens"], tb["token_lengths"],
                              keys=torch.from_numpy(jax_site_keys(rng, jcfg)), train=True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=2e-6)
    assert_grads_close({n: p.grad for n, p in model.named_parameters()},
                       state_dict_from_jax_params(jax.tree.map(np.asarray, ref_grads)))


def test_small_model_greedy_tokens_equal_jax():
    """The JAX side decodes from the memory its Pallas kernels (interpret
    mode: K1 at 518 frames, K5 over 518 keys) produce; the port runs its
    kernels' plain versions. The generator is scaled by 4 so that greedy
    emits varied tokens (as test_torch_decode.py)."""
    params, jcfg, model, _ = _build(SMALL)
    params["decoder"]["generator"]["w"] = params["decoder"]["generator"]["w"] * 4.0
    model.load_state_dict(state_dict_from_jax_params(jax.tree.map(np.asarray, params)), strict=True)
    rng = np.random.default_rng(2)
    w = (rng.normal(size=(2, jcfg.chunk_samples)) * 0.3).astype(np.float32)
    memory = jax_flags_on_memory(params, jcfg, w)
    assert memory.shape[1] == 518
    ref = np.asarray(jdecode.greedy_decode_from_memory(params, memory, jcfg, 12))
    out = tdecode.greedy_decode(model, torch.from_numpy(w), max_length=12)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert len(np.unique(ref[:, 1:])) > 1


# The points of JAX's gates: every compute dtype `compute_dtype` can name
# (bfloat16, float32, float16), the head dims of d 768 at 6, 3, 2 and 1 heads,
# 512, 640, and 896, 1,024, 2,048 (d 2,048 at 1 head), key counts from
# one to `max_positions` (2048), widths of the hidden off 128 and off 8, and
# the frontends of 16-48 kHz at time_res 0.005-0.02 and win_length 512-4096.
DTYPES = (torch.bfloat16, torch.float32, torch.float16)
HEAD_DIMS = (128, 256, 384, 512, 640, 768, 896, 1024, 2048)
KEYS = (1, 246, 511, 512, 513, 1014, 1023, 2048)
RATES = (16000, 22050, 24000, 32000, 44100, 48000)
TIME_RES = (0.005, 0.01, 0.02)
WIN_LENGTHS = (512, 1000, 1024, 2048, 4096)


def attention_route(dtype, D) -> str:
    """Part of the routing table (`cuda_attention`'s docstring): the K5
    kernels that take (dtype, head dim) on the card."""
    if dtype == torch.float32:
        return "tf32x3"
    return {128: "hopper", 256: "hopper256"}.get(D, "wide")


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "fp32", "fp16"])
def test_every_gated_attention_and_ffn_point_has_a_kernel(dtype):
    for D, tk in itertools.product(HEAD_DIMS, KEYS):
        q = torch.zeros(1, 1, 1, D, dtype=dtype)
        k = torch.zeros(1, 1, tk, D, dtype=dtype)
        assert JT._fused_attention_ok(jnp.zeros((1, 1, 1, D)), False, 0.0)  # JAX's gate sends it
        assert TT._fused_attention_ok(q, False, 0.0)
        assert cuda_attention.kernel_for(dtype, D) == attention_route(dtype, D)
        cuda_attention._check(q, k, k, None, cuda_attention.virtual_keys(1, tk))
    for d, d_ff in ((768, 3072), (256, 1024), (768, 1536), (768, 1000), (768, 1036), (384, 1001), (128, 1)):
        assert JT._fused_ffn_ok(jnp.zeros((1, d)), True, 0.1, jax.random.PRNGKey(0))  # JAX's gate: d alone
        assert cuda_ffn.kernel_for(dtype, d, d_ff) == ("tf32x3" if dtype == torch.float32 else "hopper")


def test_every_gated_frontend_has_a_kernel_route():
    routes = {}
    for sr, tr, win in itertools.product(RATES, TIME_RES, WIN_LENGTHS):
        params = tmel.MelFrontendParams(sample_rate=sr, win_length=win, hop_length=int(tr * sr), n_mels=128)
        route = cuda_mel.frames_route(params)
        assert route == "long_hop" or cuda_mel.smem_bytes(params.hop_length, win) <= cuda_mel.SMEM_LIMIT
        assert route != "ldmatrix" or params.hop_length % 8 == 0
        assert cuda_mel.mel_table(params).shape[0] % cuda_mel.FREQ_TILE == 0  # the kernel's table builds
        routes.setdefault(route, []).append((sr, params.hop_length, win))
    assert set(routes) == {"ldmatrix", "any_hop", "long_hop"}
    assert (24000, 240, 2048) in routes["ldmatrix"] and (44100, 441, 2048) in routes["any_hop"]
    assert (48000, 960, 2048) in routes["long_hop"]




# Each point this slice opened goes to the kernel the routing tables name
# (`cuda_attention`, `cuda_ffn`, `attention_rows`, `layer_norm`, `linear`):
# fp16 wherever bf16 goes, the head-dim-256 tensor-core kernels, the
# tensor-core K5 past 256 (bf16, fp16) and the 3xTF32 one (fp32), K4 at
# widths of the hidden off 128 and off 8.
NEW_POINTS = {
    "fp16-d128": ("attention", torch.float16, 128, "hopper"),
    "bf16-d256": ("attention", torch.bfloat16, 256, "hopper256"),
    "fp16-d256": ("attention", torch.float16, 256, "hopper256"),
    "fp32-d384": ("attention", torch.float32, 384, "tf32x3"),
    "bf16-d384": ("attention", torch.bfloat16, 384, "wide"),
    "fp16-d512": ("attention", torch.float16, 512, "wide"),
    "bf16-d640": ("attention", torch.bfloat16, 640, "wide"),
    "fp16-d768": ("attention", torch.float16, 768, "wide"),
    "fp32-d768": ("attention", torch.float32, 768, "tf32x3"),
    "ffn-fp16": ("ffn", torch.float16, 3072, "hopper"),
    "ffn-bf16-d_ff1000": ("ffn", torch.bfloat16, 1000, "hopper"),
    "ffn-fp16-d_ff1036": ("ffn", torch.float16, 1036, "hopper"),
    "ffn-fp32-d_ff1001": ("ffn", torch.float32, 1001, "tf32x3"),
    "ffn-fp32": ("ffn", torch.float32, 3072, "tf32x3"),
    # the decode attention (`attention_rows.kernel_for`) over 512 keys: the mma design at 16-bit head dims up
    # to 256, the split-key design past 256 and at fp32
    "rows-bf16-d128": ("rows", torch.bfloat16, 128, "mma"),
    "rows-fp16-d256": ("rows", torch.float16, 256, "mma"),
    "rows-bf16-d384": ("rows", torch.bfloat16, 384, "split"),
    "rows-fp16-d2048": ("rows", torch.float16, 2048, "split"),
    "rows-fp32-d128": ("rows", torch.float32, 128, "split"),
    "rows-fp32-d2048": ("rows", torch.float32, 2048, "split"),
}


@pytest.mark.parametrize("point", list(NEW_POINTS))
def test_each_new_point_goes_to_the_kernel_its_table_names(point):
    kind, dtype, width, route = NEW_POINTS[point]
    if kind == "attention":
        assert cuda_attention.kernel_for(dtype, width) == route
        assert (dtype, width) in cuda_attention.routed(route)
    elif kind == "rows":
        assert attention_rows.kernel_for(dtype, width, 512) == route
    else:
        assert cuda_ffn.kernel_for(dtype, 768, width) == route
        w1, b1, w2 = cuda_ffn.padded_weights(torch.ones(width, 768), torch.ones(width), torch.ones(768, width))
        assert w1.shape[0] % cuda_ffn.TILE == 0 and w1.shape[0] - width < cuda_ffn.TILE
        assert torch.equal(w1[:width], torch.ones(width, 768)) and not w1[width:].any() and not b1[width:].any()
        assert w2.shape == (768, w1.shape[0]) and not w2[:, width:].any()


def test_what_the_card_still_refuses():
    """No head-dim limit is left on K5: every multiple of 128 up to 4,096
    goes to a kernel in each dtype (bf16 and fp16 past 256 to the wide
    tensor-core kernels, fp32 to the 3xTF32 ones). The card refuses only what
    JAX's gates never send: a head dim off 128, a d off 128, fp64."""
    for dtype in DTYPES:
        routes = {D: cuda_attention.kernel_for(dtype, D) for D in range(128, 4097, 128)}
        assert routes == {D: attention_route(dtype, D) for D in routes}
    assert cuda_attention.routed("wide") == {(t, D) for t in (torch.bfloat16, torch.float16) for D in range(384, 4097, 128)}
    assert cuda_attention.routed("tf32x3") == {(torch.float32, D) for D in range(128, 4097, 128)}
    for D in (64, 192, 200, 1000):
        with pytest.raises(ValueError, match="multiples of 128"):
            cuda_attention.kernel_for(torch.float16, D)
    with pytest.raises(ValueError, match="multiples of 128"):
        cuda_attention.kernel_for(torch.bfloat16, 192)
    with pytest.raises(ValueError, match="bf16, fp16 or fp32"):
        cuda_attention.kernel_for(torch.float64, 128)
    with pytest.raises(ValueError, match="multiple of 128"):
        cuda_ffn.kernel_for(torch.float16, 200, 800)
    with pytest.raises(ValueError, match="bf16, fp16 or fp32"):
        cuda_ffn.kernel_for(torch.float64, 768, 3072)


def test_k5_plain_fp16_matches_jax_vjp_of_the_interpret_kernel():
    """fp16 q, k, v at head dim 128 (1 head, 70 x 90, a mask), through both
    packages' `_flash_attention`. Both round p and the output to fp16 at the
    same points, from fp32 sums in other orders: out within 2^-10 of its
    largest element (one fp16 ulp of it), each gradient within 2^-9 of its
    largest (JAX's backward rounds its fp32 results to fp16 once, the port's
    plain version too)."""
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _attention_inputs(70, 90, 128, seed=16)
    jq, jk, jv, jdo = (a.astype(jnp.float16) for a in (jq, jk, jv, jdo))
    tq, tk, tv, tdo = (t.half() for t in (tq, tk, tv, tdo))
    mask = np.where(np.random.default_rng(1).random((70, 90)) < 0.2, -1e4, 0.0).astype(np.float32)[None, None]
    ref, vjp = jax.vjp(lambda q, k, v: JT._flash_attention(q, k, v, jnp.asarray(mask)), jq, jk, jv)
    ref_grads = vjp(jdo)
    tq, tk, tv = (t.requires_grad_() for t in (tq, tk, tv))
    assert cuda_attention.kernel_for(tq.dtype, 128) == "hopper"
    out = TT._flash_attention(tq, tk, tv, torch.from_numpy(mask))
    out.backward(tdo)
    ref = np.asarray(ref).astype(np.float32)
    assert out.dtype == torch.float16
    np.testing.assert_allclose(out.detach().float().numpy(), ref, atol=2**-10 * np.abs(ref).max(), rtol=0)
    for name, t, r in zip(("dq", "dk", "dv"), (tq, tk, tv), ref_grads):
        r = np.asarray(r).astype(np.float32)
        assert t.grad.dtype == torch.float16, name
        np.testing.assert_allclose(t.grad.float().numpy(), r, atol=2**-9 * np.abs(r).max(), rtol=0, err_msg=name)


@pytest.mark.parametrize("d_ff", [1000, 1036])
def test_k4_plain_at_any_d_ff_matches_pallas_interpret(d_ff):
    """K4's plain version (fp32, the model's dropout 0.1) against the JAX
    kernel in interpret mode at widths of the hidden that are not multiples
    of 128 (1000, 1036), through
    `ffn_dropout_block` on both sides; tolerances as the fp32 test above."""
    kp, kx, kh, ko = jax.random.split(jax.random.PRNGKey(d_ff), 4)
    p = JT.ffn_init(kp, D_K4, d_ff)
    x = jax.random.normal(kx, (2, 37, D_K4), jnp.float32)

    def jloss(p, x):
        return jnp.sum(jnp.sin(JT.ffn_dropout_block(p, x, RATE, kh, ko, interpret=True)))

    ref = np.asarray(JT.ffn_dropout_block(p, x, RATE, kh, ko, interpret=True))
    gp, gx = jax.grad(jloss, argnums=(0, 1))(p, x)
    layer = torch.nn.Module()
    layer.linear1, layer.linear2 = torch.nn.Linear(D_K4, d_ff), torch.nn.Linear(d_ff, D_K4)
    with torch.no_grad():
        for name in ("linear1", "linear2"):
            getattr(layer, name).weight.copy_(torch.from_numpy(np.asarray(p[name]["w"]).T.copy()))
            getattr(layer, name).bias.copy_(torch.from_numpy(np.array(p[name]["b"])))
    tx = torch.from_numpy(np.array(x)).requires_grad_()
    words = [tuple(int(w) for w in np.asarray(jax.random.key_data(k)).reshape(-1)) for k in (kh, ko)]
    assert cuda_ffn.kernel_for(tx.dtype, D_K4, d_ff) == "tf32x3"
    out = TT.ffn_dropout_block(layer, tx, RATE, *words)
    np.testing.assert_array_equal(out.detach().numpy() == 0.0, ref == 0.0)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=2e-5, atol=2e-5)
    torch.sin(out).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=1e-4, atol=1e-4)
    for name in ("linear1", "linear2"):
        mod = getattr(layer, name)
        np.testing.assert_allclose(mod.weight.grad.numpy().T, np.asarray(gp[name]["w"]), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(mod.bias.grad.numpy(), np.asarray(gp[name]["b"]), rtol=1e-4, atol=1e-4)


def _wide_head_greedy_tokens_equal_jax(head_dim: int, seed: int) -> None:
    """The small model at 1 head of `head_dim` (d = head_dim): JAX decodes
    from the memory its Pallas kernels (interpret mode) produce, the port
    runs its kernels' plain versions; greedy tokens equal at fp32."""
    kw = dict(SMALL, nhead=1, d_query=head_dim)
    params, jcfg, model, tcfg = _build(kw, seed=seed)
    assert tcfg.d_model // tcfg.nhead == head_dim and cuda_attention.kernel_for(torch.float32, head_dim) == "tf32x3"
    params["decoder"]["generator"]["w"] = params["decoder"]["generator"]["w"] * 4.0
    model.load_state_dict(state_dict_from_jax_params(jax.tree.map(np.asarray, params)), strict=True)
    rng = np.random.default_rng(seed + 1)
    w = (rng.normal(size=(2, jcfg.chunk_samples)) * 0.3).astype(np.float32)
    memory = jax_flags_on_memory(params, jcfg, w)
    ref = np.asarray(jdecode.greedy_decode_from_memory(params, memory, jcfg, 12))
    out = tdecode.greedy_decode(model, torch.from_numpy(w), max_length=12)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert len(np.unique(ref[:, 1:])) > 1


def test_wide_head_model_greedy_tokens_equal_jax():
    """Head dim 384 (d 384, 1 head), which the card's K5 and attention_rows take."""
    _wide_head_greedy_tokens_equal_jax(384, seed=3)


def test_wide_head_model_past_every_old_limit_greedy_tokens_equal_jax():
    """Head dim 1,152 (d 1,152, 1 head): past each limit the card had before
    (K5 at head dim 768, LayerNorm at d 1,024, attention_rows at 1,024)."""
    _wide_head_greedy_tokens_equal_jax(1152, seed=5)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_k5_plain_half_at_d1024_matches_jax_vjp_of_the_interpret_kernel(dtype):
    """bf16 and fp16 q, k, v at head dim 1,024 (1 head, 24 x 40, a mask;
    the card's wide tensor-core kernels take them), through both packages'
    `_flash_attention`. Both round p and the output to q's dtype at the same
    points, from fp32 sums in other orders, and the backward's fp32 results
    once: fp16 as the head-dim-128 test above (out 2^-10, gradients 2^-9 of
    the largest element); bf16 within 2^-6 of the largest element (two bf16
    ulps of it: one from p's rounding, one from the output's)."""
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _attention_inputs(24, 40, 1024, seed=24)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv, jdo = (a.astype(jdt) for a in (jq, jk, jv, jdo))
    tq, tk, tv, tdo = (t.to(tdt) for t in (tq, tk, tv, tdo))
    mask = np.where(np.random.default_rng(2).random((24, 40)) < 0.2, -1e4, 0.0).astype(np.float32)[None, None]
    ref, vjp = jax.vjp(lambda q, k, v: JT._flash_attention(q, k, v, jnp.asarray(mask)), jq, jk, jv)
    ref_grads = vjp(jdo)
    tq, tk, tv = (t.requires_grad_() for t in (tq, tk, tv))
    assert cuda_attention.kernel_for(tdt, 1024) == "wide"
    out = TT._flash_attention(tq, tk, tv, torch.from_numpy(mask))
    out.backward(tdo)
    out_tol, grad_tol = (2.0**-10, 2.0**-9) if dtype == "float16" else (2.0**-6, 2.0**-6)
    ref = np.asarray(ref).astype(np.float32)
    assert out.dtype == tdt
    np.testing.assert_allclose(out.detach().float().numpy(), ref, atol=out_tol * np.abs(ref).max(), rtol=0)
    for name, t, r in zip(("dq", "dk", "dv"), (tq, tk, tv), ref_grads):
        r = np.asarray(r).astype(np.float32)
        assert t.grad.dtype == tdt, name
        np.testing.assert_allclose(t.grad.float().numpy(), r, atol=grad_tol * np.abs(r).max(), rtol=0, err_msg=name)


WIDE_D = 2048  # d 2,048 at 1 head: LayerNorm rows and the decode attention's head dim past 1,024


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_plain_at_d2048_matches_jax(dtype):
    """The plain LayerNorm and LayerNorm(x + r) (which the card's kernel
    computes at any d, rows past 1,024 read again on each pass) against the
    JAX package's `layer_norm` at d 2,048: fp32 within 1e-5 (sums in other
    orders); bf16 within one bf16 ulp of each output (2^-7 of its magnitude
    and 2^-7 absolute below 1)."""
    from adt_str_tpu_torch.ops import layer_norm as tln
    rng = np.random.default_rng(7)
    x, r = (rng.normal(size=(3, 5, WIDE_D)).astype(np.float32) for _ in range(2))
    w, b = rng.normal(size=WIDE_D).astype(np.float32), rng.normal(size=WIDE_D).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    p = {"scale": jnp.asarray(w), "bias": jnp.asarray(b)}
    jx, jr = jnp.asarray(x).astype(jdt), jnp.asarray(r).astype(jdt)
    tx, tr = torch.from_numpy(x).to(tdt), torch.from_numpy(r).to(tdt)
    tw, tb = torch.from_numpy(w), torch.from_numpy(b)
    for got, ref in ((tln.layer_norm(tx, tw, tb, 1e-5), JT.layer_norm(p, jx)),
                     (tln.add_layer_norm(tx, tr, tw, tb, 1e-5), JT.layer_norm(p, jx + jr))):
        ref = np.asarray(ref.astype(jnp.float32))
        assert got.dtype == tdt
        tol = 1e-5 if dtype == "float32" else 2.0**-7 * np.maximum(np.abs(ref), 1.0)
        np.testing.assert_array_less(np.abs(got.float().numpy() - ref), tol + 1e-30)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_rows_plain_at_hd2048_matches_jax(dtype):
    """The decode attention's plain version (which the card's kernel holds
    to at any head dim) against the JAX package's `attention_core` at head
    dim 2,048: one query row over 37 cached keys of which 30 are valid (the
    decode step's `valid_keys`, JAX's mask past the step), and 3 rows over
    20 keys with an additive mask. fp32 within 1e-5; bf16 within 2^-6 of
    the largest output (both round p to bf16, then the output)."""
    from adt_str_tpu_torch.ops import attention_rows as tar
    rng = np.random.default_rng(8)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    for tq, tk, valid in ((1, 37, 30), (3, 20, None)):
        q, k, v = (rng.normal(size=(2, 1, t, WIDE_D)).astype(np.float32) for t in (tq, tk, tk))
        if valid is None:
            mask = np.where(rng.random((2, 1, tq, tk)) < 0.3, -1e4, 0.0).astype(np.float32)
        else:
            mask = np.where(np.arange(tk) >= valid, -1e4, 0.0).astype(np.float32)[None, None, None]
        ref = JT.attention_core(*(jnp.asarray(a).astype(jdt) for a in (q, k, v)), jnp.asarray(mask))
        ref = np.asarray(ref.astype(jnp.float32))
        tq_, tk_, tv_ = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
        got = (tar.attention_plain(tq_, tk_, tv_, None, valid_keys=valid) if valid is not None
               else tar.attention_plain(tq_, tk_, tv_, torch.from_numpy(mask)))
        assert got.dtype == tdt
        tol = 1e-5 if dtype == "float32" else 2.0**-6 * np.abs(ref).max()
        np.testing.assert_allclose(got.float().numpy(), ref, atol=tol, rtol=0)
