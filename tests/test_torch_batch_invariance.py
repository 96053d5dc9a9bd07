"""A chunk's tokens do not depend on the rows decoded beside it, on the CPU:
the port's greedy and beam tokens for rows decoded alone equal the same
rows inside batches of 2, 4 and 8 and equal the JAX package's; the plain
versions of the batch-invariance kernels (`ops/layer_norm.py`,
`ops/linear.py`, `ops/attention_rows.py`) are bit-equal to the formulas
the model used before them, so JAX parity at fp32 is unchanged; K1's
band sums are the same bits at the frequency split of every batch; and `chip_smoke.py`'s
op probe lists an op whose rows move with the batch and nothing else.

The kernels themselves run only on the card (`tests/test_torch_cuda_kernels.py`).
"""

import math
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adt_str_tpu.models import decode as jdecode
from adt_str_tpu_torch.clap.features import _clap_mel_params
from adt_str_tpu_torch.models import decode as tdecode
from adt_str_tpu_torch.models import transformer as T
from adt_str_tpu_torch.models.adt import mel_params
from adt_str_tpu_torch.ops import attention_rows, cuda_mel
from adt_str_tpu_torch.ops import layer_norm as ln_ops
from adt_str_tpu_torch.ops import linear as linear_ops
from test_torch_decode import SERVING_TINY, build, waves
from test_torch_mel_table import _kernel_mel, _power

REPO = Path(__file__).resolve().parent.parent
MAX_LEN = 16
ROWS = 8


def _spread(decode, w: torch.Tensor, batch: int) -> torch.Tensor:
    """The rows of `w` decoded in batches of `batch` (below 8: side by side;
    8: in reversed order) -> the rows in `w`'s order."""
    if batch < len(w):
        return torch.cat([decode(w[i : i + batch]) for i in range(0, len(w), batch)])
    return decode(w.flip(0)).flip(0)


@pytest.mark.parametrize("batch", [2, 4, 8])
@pytest.mark.parametrize("mode", ["greedy", "beam"])
def test_rows_decode_alone_as_in_a_batch_and_as_jax(mode, batch):
    params, jcfg, model = build(SERVING_TINY, eos_bias=2.0)
    w = waves(jcfg, n=ROWS, seed=4)
    if mode == "greedy":
        def decode(x):
            return tdecode.greedy_decode(model, x, max_length=MAX_LEN)
        ref = np.asarray(jdecode.greedy_decode(params, jnp.asarray(w), jcfg, max_length=MAX_LEN))
    else:
        def decode(x):
            return tdecode.beam_search_decode(model, x, max_length=MAX_LEN, beam_size=3)
        ref = np.asarray(jdecode.beam_search_decode(params, jnp.asarray(w), jcfg, max_length=MAX_LEN, beam_size=3))
    wt = torch.from_numpy(w)
    alone = torch.cat([decode(wt[i : i + 1]) for i in range(ROWS)])
    np.testing.assert_array_equal(_spread(decode, wt, batch).numpy(), alone.numpy())
    np.testing.assert_array_equal(alone.numpy(), ref)


# the model's formulas before the batch-invariance kernels took them over
def _layer_norm_before(mod, x):
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + mod.eps)
    return (y * mod.weight.float() + mod.bias.float()).to(x.dtype)


def _linear_before(mod, x):
    y = x @ mod.weight.to(x.dtype).T
    if mod.bias is not None:
        y = y + mod.bias.to(x.dtype)
    return y


def _attention_before(q, k, v, mask):
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if mask is not None:
        scores = scores + mask.float()
    return torch.matmul(torch.softmax(scores, dim=-1).to(q.dtype), v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_plain_versions_bit_equal_the_formulas_before(dtype):
    g = torch.Generator().manual_seed(0)
    norm = torch.nn.LayerNorm(48)
    lin = torch.nn.Linear(48, 40)
    with torch.no_grad():
        norm.weight.normal_(1.0, 0.1, generator=g)
        norm.bias.normal_(0.0, 0.1, generator=g)
    x = (torch.randn(3, 5, 48, generator=g) * 2 + 0.5).to(dtype)
    assert torch.equal(T.layer_norm(norm, x), _layer_norm_before(norm, x))
    assert torch.equal(ln_ops.layer_norm_plain(x, norm.weight, norm.bias, norm.eps), _layer_norm_before(norm, x))
    assert torch.equal(T.linear(lin, x), _linear_before(lin, x))
    assert torch.equal(T.linear(lin, x, fixed_order=True), _linear_before(lin, x))
    q, k, v = (torch.randn(2, 3, t, 16, generator=g).to(dtype) for t in (4, 9, 9))
    mask = torch.where(torch.arange(9) > 5, T.NEG_MASK, 0.0)[None, None, None]
    for m in (None, mask):
        assert torch.equal(T.attention_core(q, k, v, m), _attention_before(q, k, v, m))
        assert torch.equal(attention_rows.attention_plain(q, k, v, m), _attention_before(q, k, v, m))


def test_wrappers_run_their_plain_versions_on_the_cpu_and_keep_autograd():
    norm, lin = torch.nn.LayerNorm(16), torch.nn.Linear(16, 8)
    x = torch.randn(4, 16, requires_grad=True)
    counts = (ln_ops.layer_norm.launches, linear_ops.linear.launches, attention_rows.attention.launches)
    y = T.linear(lin, T.layer_norm(norm, x), fixed_order=True)
    q = y.reshape(1, 2, 4, 4)
    out = T.attention_core(q, q, q, None)
    out.sum().backward()
    assert x.grad is not None and lin.weight.grad is not None and norm.weight.grad is not None
    assert (ln_ops.layer_norm.launches, linear_ops.linear.launches, attention_rows.attention.launches) == counts


def test_log_mel_split_is_a_function_of_a_rows_shape():
    """K1's split follows the launch (one wave of 132 SMs: 8, 4 and 1 for
    the model's 2.56 s chunks at B 1, 16 and 64), so what must be a function
    of a row's shape alone is a row's bits: the kernel's band sums, replayed
    in numpy, are the same bits at the split of every batch, for the model's
    frontend and CLAP's 10 s at 48 kHz."""
    from adt_str_tpu_torch.config import FrameworkConfig

    cfg = FrameworkConfig.from_yaml(REPO / "configs/serve/ENSTserving.yaml")
    for params, n_samples in ((mel_params(cfg.model), cfg.shared.chunk_samples), (_clap_mel_params(), 480_000)):
        table = cuda_mel.mel_table(params)
        n_tiles = table.shape[0] // cuda_mel.FREQ_TILE
        frame_tiles = -(-cuda_mel._frame_range(params, n_samples, params.log_mode != "db")[1] // cuda_mel.TILE_FRAMES)
        splits = {b: cuda_mel.freq_split(b * frame_tiles, n_tiles, 132) for b in (1, 16, 32, 64)}
        if params.log_mode != "db":
            assert splits == {1: 8, 16: 4, 32: 2, 64: 1}
        power = _power(table, params, 5)
        one = _kernel_mel(power, params, 1)
        for split in set(splits.values()):
            np.testing.assert_array_equal(_kernel_mel(power, params, split), one)


@pytest.fixture(scope="module")
def chip_smoke():
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    return chip_smoke


def _probe_diffs(chip_smoke, fn, x: torch.Tensor) -> list:
    ref = chip_smoke.probe_run(lambda: fn(x), None, steps=1)
    return [name for name, _, _ in chip_smoke.probe_run(lambda: fn(x[:3]), ref, steps=1).diffs]


def test_the_op_probe_lists_a_batch_dependent_op_and_nothing_else(chip_smoke):
    """The probe compares every op of a 3-row run with the first rows of a
    7-row run, forcing each op's output to the reference's: an op whose
    rows move with the batch is listed (once, by name), the ops after it see
    equal inputs, and a reduction over the batch is not compared."""
    x = torch.randn(7, 5, generator=torch.Generator().manual_seed(0))

    def invariant(t):
        y = torch.tanh(t @ torch.ones(5, 5)) * 2.0
        if bool((y > -9.0).all()):  # a reduction over the batch steers the host, as `finished.all()` does
            y = y * 3.0
        return y

    def dependent(t):
        y = t * 2.0 + t.shape[0]  # a row's value follows the batch
        return torch.exp(y) - 1.0

    assert _probe_diffs(chip_smoke, invariant, x) == []
    assert _probe_diffs(chip_smoke, dependent, x) == ["- > aten.add.Tensor"]
