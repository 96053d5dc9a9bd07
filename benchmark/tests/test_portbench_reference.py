"""The reference's own decode, which the serving control runs: its
incremental steps give the logits of the teacher-forced pass, K = 1 is
greedy decoding, and each item's beams come out best first."""

from __future__ import annotations

import math

import torch

from benchmark.reference import true_fp32
from benchmark.reference.beam import beam_search
from benchmark.reference.model import Reference
from benchmark.weights import make_weights

DIMS = {"d_model": 32, "nhead": 2, "enc_layers": 1, "dec_layers": 2, "vocab": 40, "n_mels": 16,
        "sample_rate": 8000, "win_length": 256, "hop": 128, "max_positions": 64}


def _setup(seed: int = 3):
    weights = make_weights(DIMS, seed, torch.device("cpu"), eos_bias=-1e4, eos=3)  # no row ends early
    wave = torch.randn(3, 2048, generator=torch.Generator().manual_seed(seed))
    return Reference(weights, DIMS), wave


def _row_log_prob(ref: Reference, wave: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(ref.causal_logits(wave, rows), dim=-1)
    return torch.gather(logp, -1, rows[:, 1:, None])[..., 0].sum(-1)


def test_k1_is_greedy_decoding_of_the_teacher_forced_logits():
    with true_fp32():
        ref, wave = _setup()
        rows = beam_search(ref, wave, 1, 12, 2, 3, 0.0)[:, 0]
        logits = ref.causal_logits(wave, rows)
    assert rows.shape == (3, 12) and (rows[:, 0] == 2).all()
    assert torch.equal(logits.argmax(-1), rows[:, 1:])


def test_beams_come_out_best_first_by_their_length_penalised_score():
    with true_fp32():
        ref, wave = _setup(5)
        rows = beam_search(ref, wave, 4, 10, 2, 3, 1.0)
        scores = torch.stack([_row_log_prob(ref, wave, rows[:, k]) for k in range(4)], 1) / 10
    assert rows.shape == (3, 4, 10)
    assert (scores[:, :-1] >= scores[:, 1:] - 1e-5).all()
    assert not math.isclose(float(scores[0, 0]), float(scores[0, -1]))
