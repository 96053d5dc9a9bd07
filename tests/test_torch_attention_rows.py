"""The attention-rows wrapper's logic that runs on the CPU: `valid_keys`
(the decode step's read of its cache's valid rows) against the masked call
it stands for, the plain version bit-equal to it, the decode step passing
it, and the layout the wrapper hands the kernel (strides, alignment, the
mask's broadcast). The kernel itself runs only on the card
(`tests/test_torch_cuda_kernels.py`); the decode's tokens against the JAX
package's are held by `tests/test_torch_decode.py` and `test_torch_beam.py`.
"""

import numpy as np
import pytest
import torch

from adt_str_tpu_torch.models import decode as tdecode
from adt_str_tpu_torch.models import transformer as T
from adt_str_tpu_torch.ops import attention_rows
from test_torch_decode import SERVING_TINY, build


def _qkv(b, tq, tk, hd, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal((b, 3, t, hd)).astype(np.float32)).to(dtype)
                 for t in (tq, tk, tk))


def _step_mask(tk, step):
    """The decode step's mask as the model built it before `valid_keys`."""
    return torch.where(torch.arange(tk) > step, T.NEG_MASK, 0.0)[None, None, None, :]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("tq, tk", [(1, 16), (5, 16), (1, 1), (3, 7)])
def test_valid_keys_equal_the_masked_call(dtype, tq, tk):
    q, k, v = _qkv(2, tq, tk, 8, dtype)
    for valid in sorted({1, 2, tk // 2 or 1, tk - 1 or 1, tk}):
        masked = attention_rows.attention_plain(q, k, v, _step_mask(tk, valid - 1))
        assert torch.equal(attention_rows.attention_plain(q, k, v, None, valid), masked), valid
        assert torch.equal(attention_rows.attention(q, k, v, valid_keys=valid), masked), valid
        assert torch.equal(T.attention_core(q, k, v, None, valid_keys=valid), masked), valid


def test_valid_keys_mask_is_neg_mask_from_the_first_invalid_key():
    mask = attention_rows.keys_mask(None, 3, 6, torch.device("cpu"))
    assert mask.shape == (1, 1, 1, 6) and mask.dtype == torch.float32
    assert mask.flatten().tolist() == [0.0, 0.0, 0.0, T.NEG_MASK, T.NEG_MASK, T.NEG_MASK]
    given = torch.zeros(1, 1, 1, 6)
    assert attention_rows.keys_mask(given, None, 6, torch.device("cpu")) is given
    with pytest.raises(ValueError, match="not both"):
        attention_rows.keys_mask(given, 3, 6, torch.device("cpu"))


def test_dropout_path_takes_valid_keys_as_its_mask():
    """Training's attention (probability dropout) builds the same mask."""
    q, k, v = _qkv(1, 2, 6, 8, torch.float32)
    key = (1, 2)
    a = T.attention_core(q, k, v, None, 0.5, key, True, valid_keys=4)
    b = T.attention_core(q, k, v, _step_mask(6, 3), 0.5, key, True)
    assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["greedy", "beam"])
def test_decode_step_reads_the_valid_keys_of_its_cache(mode, monkeypatch):
    """Every self-attention of a decode step passes valid_keys = step + 1
    and no mask; the cross-attention passes neither."""
    model = build(SERVING_TINY, eos_bias=2.0)[2]
    calls = []
    plain = attention_rows.attention

    def record(q, k, v, mask=None, valid_keys=None):
        calls.append((k.shape[2], mask is None, valid_keys))
        return plain(q, k, v, mask, valid_keys)

    monkeypatch.setattr(attention_rows, "attention", record)
    memory = torch.randn(2, 5, model.config.d_model)
    with torch.inference_mode():
        if mode == "greedy":
            tdecode.greedy_decode_from_memory(model, memory, max_length=6)
        else:
            tdecode.beam_search_decode_from_memory(model, memory, max_length=6, beam_size=2)
    self_calls = [c for c in calls if c[0] == 6]
    cross_calls = [c for c in calls if c[0] == 5]
    layers = len(model.decoder.decoder.layers)
    assert len(self_calls) == len(cross_calls) and len(self_calls) % layers == 0 and self_calls
    assert all(no_mask for _, no_mask, _ in calls)
    assert all(valid is None for _, _, valid in cross_calls)
    steps = [valid - 1 for _, _, valid in self_calls[::layers]]
    assert steps == list(range(len(steps))) and [c[2] for c in self_calls] == [s + 1 for s in steps for _ in
                                                                               range(layers)]


def test_kernel_layout_strides_and_alignment():
    """The strides handed to the kernel are 0 on one-entry dims; a bf16
    operand whose start or row stride is not 16-byte aligned, or whose last
    dim is strided, is copied; an fp32 one too where its head dim is a
    multiple of 4, else only for a strided last dim."""
    base = torch.zeros(2, 3, 40, 16, dtype=torch.bfloat16)
    t, s = attention_rows._kernel_layout(base)
    assert t is base and s == (3 * 40 * 16, 40 * 16, 16)
    q = base[:, :, :1]  # one query row: its row stride is never stepped
    t, s = attention_rows._kernel_layout(q)
    assert t is q and s == (3 * 40 * 16, 40 * 16, 0)
    odd = base[:, :, 1:]  # starts 32 bytes in: aligned
    assert attention_rows._kernel_layout(odd)[0] is odd
    shifted = base.flatten()[4:4 + 2 * 3 * 39 * 16].view(2, 3, 39, 16)  # starts 8 bytes in
    t, s = attention_rows._kernel_layout(shifted)
    assert t is not shifted and t.data_ptr() % 16 == 0 and torch.equal(t, shifted) and s == (3 * 39 * 16, 39 * 16, 16)
    narrow = torch.zeros(2, 3, 40, 20, dtype=torch.bfloat16)[..., :12]  # row stride 20: not a multiple of 8
    t, s = attention_rows._kernel_layout(narrow)
    assert t is not narrow and torch.equal(t, narrow) and s == (3 * 40 * 12, 40 * 12, 12)
    f32 = torch.zeros(2, 3, 40, 20)[..., :12]
    assert attention_rows._kernel_layout(f32)[0] is f32
    # fp32 at a head dim of whole 16-byte vectors takes 16-byte loads: a start 4 bytes in is copied; at a
    # head dim off them (one element a load) it is not
    off = torch.zeros(2 * 3 * 40 * 12 + 1)[1:].view(2, 3, 40, 12)
    t, _ = attention_rows._kernel_layout(off)
    assert t is not off and t.data_ptr() % 16 == 0 and torch.equal(t, off)
    off13 = torch.zeros(2 * 3 * 40 * 13 + 1)[1:].view(2, 3, 40, 13)
    assert attention_rows._kernel_layout(off13)[0] is off13
    strided = torch.zeros(2, 3, 16, 40).transpose(-1, -2)
    t, _ = attention_rows._kernel_layout(strided)
    assert t.stride(-1) == 1 and torch.equal(t, strided)


def test_mask_strides_broadcast_without_a_copy():
    shape = (4, 3, 5, 7)
    assert attention_rows._mask_strides(torch.zeros(1, 1, 1, 7), shape) == (0, 0, 0, 1)
    assert attention_rows._mask_strides(torch.zeros(4, 1, 1, 7), shape) == (7, 0, 0, 1)
    assert attention_rows._mask_strides(torch.zeros(5, 7), shape) == (0, 0, 7, 1)
    assert attention_rows._mask_strides(torch.zeros(4, 3, 5, 7), shape) == (105, 35, 7, 1)
    with pytest.raises(ValueError, match="does not broadcast"):
        attention_rows._mask_strides(torch.zeros(2, 1, 1, 7), shape)
