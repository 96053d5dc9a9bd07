"""Note matching for the transcription metrics.

Port of `adt_str_tpu/ops/matching.py` (its own copy, pure Python and numpy):
`mir_eval.transcription.match_notes` semantics as the reference uses them.
An estimate may match a reference note when their onsets lie within the
onset tolerance, after mir_eval's rounding of |dt| to 12 decimals (so
0.65 - 0.6 = 0.05000000000000004 matches at 0.05), and their pitches within
`pitch_tolerance` cents; the matching is a maximum-cardinality bipartite
matching (Hopcroft-Karp). The port never builds the JAX package's native
matcher: the pure path returns the same pairs, since both walk the
candidates in the same order.
"""

from __future__ import annotations

from collections import deque

import numpy as np

# mir_eval.transcription rounds the distance matrices to this many decimals
N_DECIMALS = 12


def hopcroft_karp(adjacency: list[list[int]], n_right: int) -> dict[int, int]:
    """Maximum bipartite matching. adjacency[i] = candidate right nodes for
    left node i. Returns {left: right}."""
    INF = float("inf")
    n_left = len(adjacency)
    match_l = [-1] * n_left
    match_r = [-1] * n_right
    dist = [0.0] * n_left

    def bfs() -> bool:
        queue = deque()
        for u in range(n_left):
            if match_l[u] == -1:
                dist[u] = 0
                queue.append(u)
            else:
                dist[u] = INF
        found = False
        while queue:
            u = queue.popleft()
            for v in adjacency[u]:
                w = match_r[v]
                if w == -1:
                    found = True
                elif dist[w] == INF:
                    dist[w] = dist[u] + 1
                    queue.append(w)
        return found

    def dfs(u: int) -> bool:
        for v in adjacency[u]:
            w = match_r[v]
            if w == -1 or (dist[w] == dist[u] + 1 and dfs(w)):
                match_l[u] = v
                match_r[v] = u
                return True
        dist[u] = INF
        return False

    while bfs():
        for u in range(n_left):
            if match_l[u] == -1:
                dfs(u)
    return {u: match_l[u] for u in range(n_left) if match_l[u] != -1}


def match_notes(
    ref_intervals: np.ndarray,
    ref_pitches: np.ndarray,
    est_intervals: np.ndarray,
    est_pitches: np.ndarray,
    onset_tolerance: float = 0.05,
    pitch_tolerance: float = 50.0,
    offset_ratio: float | None = None,
) -> list[tuple[int, int]]:
    """-> sorted list of (ref_index, est_index) matched pairs."""
    ref_intervals = np.atleast_2d(np.asarray(ref_intervals, dtype=np.float64))
    est_intervals = np.atleast_2d(np.asarray(est_intervals, dtype=np.float64))
    ref_pitches = np.asarray(ref_pitches, dtype=np.float64).reshape(-1)
    est_pitches = np.asarray(est_pitches, dtype=np.float64).reshape(-1)
    if len(ref_pitches) == 0 or len(est_pitches) == 0:
        return []

    onset_ok = (
        np.around(np.abs(ref_intervals[:, 0][:, None] - est_intervals[:, 0][None, :]), decimals=N_DECIMALS)
        <= onset_tolerance
    )
    with np.errstate(divide="ignore", invalid="ignore"):
        cents = 1200.0 * np.abs(np.log2(est_pitches[None, :] / ref_pitches[:, None]))
    feasible = onset_ok & (cents <= pitch_tolerance)

    if offset_ratio is not None:
        ref_durations = ref_intervals[:, 1] - ref_intervals[:, 0]
        offset_tol = np.maximum(offset_ratio * ref_durations, 0.05)
        offset_ok = (
            np.around(np.abs(ref_intervals[:, 1][:, None] - est_intervals[:, 1][None, :]), decimals=N_DECIMALS)
            <= offset_tol[:, None]
        )
        feasible &= offset_ok

    adjacency = [np.where(row)[0].tolist() for row in feasible]
    return sorted(hopcroft_karp(adjacency, len(est_pitches)).items())
