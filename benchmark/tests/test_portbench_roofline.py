"""The yardstick's counts against shapes worked by hand."""

from __future__ import annotations

import pytest

from benchmark import roofline as r


def test_bound_takes_the_slowest_of_the_pipes_and_the_memory():
    assert r.bound_s([(r.PEAK_BF16, r.PEAK_BF16), (r.PEAK_FP32 / 2, r.PEAK_FP32)], 0.0) == pytest.approx(1.0)
    assert r.bound_s([(1.0, r.PEAK_BF16)], 2 * r.PEAK_BYTES) == pytest.approx(2.0)
    assert r.product_cost(10.0, 4) == (30.0, r.PEAK_TF32) and r.product_cost(10.0, 2) == (10.0, r.PEAK_BF16)


def test_the_mel_bands_use_1024_of_1025_bins_at_the_configs_frontend():
    assert r.used_bins(2048, 128, 24000) == 1024


def test_log_mel_at_one_chunk():
    # bf16 DFT 4 * 246 * 2048 * 1024 ops; bytes: wave, DFT table, bands, output
    n_bytes = 61440 * 4 + 2 * 2048 * 1024 * 2 + 1024 * 128 * 4 + 246 * 128 * 4
    assert n_bytes == 9_284_608
    assert r.log_mel(1, 61440, 246, 2048, 128, 1024) == pytest.approx(n_bytes / r.PEAK_BYTES)
    assert r.log_mel(64, 61440, 246, 2048, 128, 1024) == pytest.approx(4 * 64 * 246 * 2048 * 1024 / r.PEAK_BF16)


def test_attention_layer_norm_and_linear():
    assert r.attention_fwd(1, 128, 128, 128) == pytest.approx((2 * 256 * 128 * 2 + 128 * 4) / r.PEAK_BYTES)
    assert r.layer_norm(16, 768) == pytest.approx((16 * 768 * 2 * 2 + 2 * 768 * 4) / r.PEAK_BYTES)
    assert r.linear(16, 2304, 768) == pytest.approx(3_641_856 / r.PEAK_BYTES)
    assert r.attention_rows(6, 1, 257, 128) == pytest.approx((2 * 6 * (2 + 514) * 128 + 257 * 4) / r.PEAK_BYTES)


def test_placement_counts_each_sounding_note_inside_the_chunk_and_each_row_once():
    macs, rows = r.place_notes_work(__import__("numpy").array([[0, 0, 1]]), __import__("numpy").array([[0, 100, 50]]),
                                    __import__("numpy").array([[True, True, False]]), 200, 250, 2)
    assert (macs, rows) == (350.0, 200.0)
    assert r.gather_blend(27, 40, 100) == pytest.approx(((40 + 27) * 100 * 2 + 27 * 12) / r.PEAK_BYTES)


def test_model_flops_against_a_hand_count():
    # encoder, 1 chunk of 2 frames, d 4, FFN 16, one layer, 3 mels: 48 + 64 + (192 + 64 + 64 + 512)
    assert r.encoder_flops(1, 2, 4, 16, 1, 3) == 944
    # decoder, 2 tokens over 2 frames, vocab 5: self 192 + 48 + 64, cross 64 + 128 + 64 + 64, FFN 512, generator 80
    assert r.decoder_flops(1, 2, 2, 4, 16, 1, 5) == 1216
    assert r.train_step_flops(1, 2, 2, 4, 16, 1, 1, 3, 5) == 3 * (944 + 1216)
    # decode, 1 item, 2 rows, 2 steps over 3 frames: cross K, V 192; a step 992 + 80; self keys 1 + 2
    assert r.decode_flops(1, 2, 2, 3, 4, 16, 1, 5) == 192 + 2 * 1072 + 4 * 2 * 3 * 4


def test_the_training_step_is_about_ten_teraflop():
    flops = r.train_step_flops(64, 246, 511, 768, 3072, 4, 4, 128, 1400)
    assert 1.0e13 < flops < 1.1e13


def test_groups_follow_the_frozen_rule():
    assert r.group("void log_mel_kernel<0>(...)") == "K1 log-mel"
    assert r.group("void at::native::vectorized_elementwise_kernel<4, BinaryFunctor<long, long, long>>") == r.HASH_GROUP
    assert r.group("nvjet_tst_128x64") == "GEMM (cuBLAS)"
    assert r.group("attention_rows_bf16") == "attention_rows"
