"""The port's note matcher (`adt_str_tpu_torch/ops/matching.py`) against the
JAX package's `match_notes`, which returns its native extension's pairs when
that builds and its numpy Hopcroft-Karp's otherwise: the pairs must be
equal either way, on a seeded corpus dense around the 50 ms boundary, on
hand-built fp64 boundary cases and on empty inputs."""

import numpy as np
import pytest

from adt_str_tpu.ops import matching as jm
from adt_str_tpu_torch.ops import matching as tm

ONSET_TOL = 0.05
PITCH_TOL_CENTS = 1.0  # the metrics' setting: pitches x1000, 1 cent


def _random_case(rng: np.random.Generator):
    """Onsets on the 10 ms grid (many |dt| exactly 0.05 s) and few pitches,
    so the graph has contention; sometimes an empty side."""
    n_ref, n_est = int(rng.integers(0, 40)), int(rng.integers(0, 40))
    grid = lambda n: np.round(rng.integers(0, 60, n) * 0.01, 10).astype(np.float64)
    pitches = lambda n: rng.choice([35.0, 38.0, 42.0, 48.0], n) * 1000.0
    return grid(n_ref), pitches(n_ref), grid(n_est), pitches(n_est)


def _intervals(onsets):
    return np.stack([onsets, onsets + 0.1], axis=1) if len(onsets) else np.zeros((0, 2))


def _both(ref_on, ref_pi, est_on, est_pi, **kw):
    kw = {"onset_tolerance": ONSET_TOL, "pitch_tolerance": PITCH_TOL_CENTS, "offset_ratio": None, **kw}
    args = (_intervals(ref_on), ref_pi, _intervals(est_on), est_pi)
    return tm.match_notes(*args, **kw), jm.match_notes(*args, **kw)


@pytest.mark.parametrize("seed", range(60))
def test_pairs_equal_jax_on_seeded_corpus(seed):
    got, ref = _both(*_random_case(np.random.default_rng(2000 + seed)))
    assert got == ref
    assert all(isinstance(i, int) and isinstance(j, int) for i, j in got)


@pytest.mark.parametrize(
    "ref_on, est_on, n_pairs",
    [
        ([0.60], [0.65], 1),  # 0.65 - 0.6 = 0.05000000000000004 in fp64: matches after rounding
        ([0.65], [0.60], 1),
        ([0.60], [0.6500000005], 0),  # a genuine 50.0000005 ms distance does not
        ([0.10, 0.05], [0.09, 0.14], 2),  # needs an augmenting path: greedy closest-first finds 1
        ([0.3, 0.3, 0.3], [0.25, 0.35, 0.3], 3),
    ],
)
def test_boundary_cases_equal_jax(ref_on, est_on, n_pairs):
    pi = lambda n: np.full(n, 38000.0)
    got, ref = _both(np.array(ref_on), pi(len(ref_on)), np.array(est_on), pi(len(est_on)))
    assert got == ref and len(got) == n_pairs


def test_pitch_tolerance_and_offset_ratio_equal_jax():
    on = np.array([0.1, 0.2, 0.3])
    # 4.1 cents apart: no pair; 0.02 cents: a pair
    got, ref = _both(on, np.array([38000.0, 42000.0, 48000.0]), on, np.array([38000.0, 42100.0, 48000.5]))
    assert got == ref == [(0, 0), (2, 2)]
    got, ref = _both(on, np.full(3, 38000.0), on + 0.01, np.full(3, 38000.0), offset_ratio=0.2)
    assert got == ref


@pytest.mark.parametrize("n_ref, n_est", [(0, 0), (0, 3), (3, 0)])
def test_empty_sides_equal_jax(n_ref, n_est):
    on = lambda n: np.linspace(0.1, 0.5, n)
    got, ref = _both(on(n_ref), np.full(n_ref, 38000.0), on(n_est), np.full(n_est, 38000.0))
    assert got == ref == []
