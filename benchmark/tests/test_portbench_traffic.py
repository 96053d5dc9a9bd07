"""The traffic generator: the same seed gives the same inputs, another seed
other inputs of the same sizes; and the whole-batch rate arithmetic of
the serving window."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import traffic
from benchmark.drivers.serve_backlog import batches, window_rate

SEEDS = (3_000_000_011, 2**31 + 7)
MIX = traffic.load("synth_notes_b64")
SONGS = traffic.load("backlog_greedy")
SYNTH = {"mixup_range": 0.8, "use_fx_prob": 0.3, "use_reverb_prob": 0.5, "use_compression_prob": 0.5,
         "use_limiter_prob": 0.5}


@pytest.mark.parametrize("seed", SEEDS)
def test_train_batches_follow_the_seed_and_keep_their_sizes(seed):
    a = traffic.train_batch(MIX, seed, 4, 64, 128, 512)
    b = traffic.train_batch(MIX, seed, 4, 64, 128, 512)
    c = traffic.train_batch(MIX, seed + 1, 4, 64, 128, 512)
    for k in a:
        assert np.array_equal(a[k], b[k])
    assert not np.array_equal(a["notes"], c["notes"])
    assert sorted(a["note_mask"].sum(1)) == sorted(c["note_mask"].sum(1)) == sorted(traffic.note_counts(MIX, 64))
    assert not np.array_equal(a["notes"], traffic.train_batch(MIX, seed, 5, 64, 128, 512)["notes"])


def test_token_rows_encode_each_note_as_time_pitch_velocity():
    b = traffic.train_batch(MIX, SEEDS[0], 0, 8, 128, 512)
    for notes, mask, row, n in zip(b["notes"], b["note_mask"], b["tokens"], b["token_lengths"]):
        k = int(mask.sum())
        body = row[1 : 1 + 3 * k].reshape(k, 3)
        assert row[0] == traffic.BOS and row[1 + 3 * k] == traffic.EOS
        assert np.array_equal(body[:, 1], notes[:k, 2].astype(np.int64) + traffic.PITCH_OFFSET)
        assert np.array_equal(body[:, 2], notes[:k, 3].astype(np.int64) + traffic.VELOCITY_OFFSET)
        assert np.all(body[:, 0] < traffic.PITCH_OFFSET)
        assert n in (2 + 3 * k, 1 + 3 * k)  # the longest rows lose one (the reference collate)


@pytest.mark.parametrize("seed", SEEDS)
def test_render_draws_and_keys_follow_the_seed(seed):
    def draw(s):
        return traffic.render_draws(torch.Generator().manual_seed(s), 4, 3, 5, SYNTH)

    a, b, c = draw(seed), draw(seed), draw(seed + 1)
    assert torch.equal(a.main_rows, b.main_rows) and torch.equal(a.lam, b.lam)
    assert all(torch.equal(a.fx[k], b.fx[k]) for k in a.fx)
    assert not torch.equal(a.main_rows, c.main_rows)
    assert int(a.main_rows.max()) < 27 * 3 * 5 and int(a.main_rows.min()) >= 0
    slot = a.main_rows // 15
    assert torch.equal(slot, torch.arange(27).expand(4, 27))  # each slot draws from its own pitch's rows
    assert torch.equal(traffic.site_keys(seed, 3, 43), traffic.site_keys(seed, 3, 43))
    assert int(traffic.site_keys(seed, 3, 43).max()) < 2**32


@pytest.mark.parametrize("seed", SEEDS)
def test_songs_follow_the_seed_and_keep_their_lengths(seed):
    a, c = traffic.song_seconds(SONGS, seed, 64), traffic.song_seconds(SONGS, seed + 1, 64)
    assert np.array_equal(a, traffic.song_seconds(SONGS, seed, 64))
    assert sorted(a) == sorted(c) and a.min() == 30 and a.max() == 300
    x = traffic.song_audio(seed, 2, 3.0, 24000)
    assert np.array_equal(x, traffic.song_audio(seed, 2, 3.0, 24000)) and x.shape == (72000,)
    assert not np.array_equal(x, traffic.song_audio(seed, 3, 3.0, 24000))


def test_batches_group_completions_and_the_rate_counts_whole_batches_after_the_first():
    # three batches of 4 chunks end at 10, 13 and 16 s; one at 19.5 s ends after the window's close
    done = [(t + 0.001 * i, i) for t in (10.0, 13.0, 16.0, 19.5) for i in range(4)] + [(8.0, 99)]
    groups = batches(done, lo=9.0, hi=19.0)
    assert [n for _, n in groups] == [4, 4, 4]
    rate = window_rate(groups, 2.56)
    assert rate == pytest.approx(8 * 2.56 / (16.003 - 10.003))
    assert window_rate(groups[:1], 2.56) is None
