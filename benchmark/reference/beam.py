"""Beam search over the plain reference, as the serving configuration
states it: K beams an item, only the first live at the start; at each
step every live beam's children score their cumulative log-probability
over the length (BOS included) raised to the length penalty, a finished
beam keeps its own score, and the K best of all go on; an item's beams
stop at EOS or at `max_length` tokens. An item's answer is its best
final beam. With K = 1 it is greedy decoding."""

from __future__ import annotations

import torch

from benchmark.reference.model import Reference


def _score(log_prob: torch.Tensor, length: torch.Tensor, length_penalty: float) -> torch.Tensor:
    return log_prob if length_penalty == 0.0 else log_prob / length.float() ** length_penalty


@torch.no_grad()
def beam_search(ref: Reference, wave: torch.Tensor, K: int, max_length: int, bos: int, eos: int,
                length_penalty: float) -> torch.Tensor:
    """(B, samples) chunks -> (B, K, max_length) rows, EOS after the end,
    each item's beams best first."""
    memory = ref.encode(wave)
    B, dev = memory.shape[0], memory.device
    R = B * K
    state = ref.start_decode(memory, K, max_length)
    rows = torch.full((R, max_length), eos, dtype=torch.long, device=dev)
    rows[:, 0] = bos
    log_prob = torch.full((B, K), float("-inf"), device=dev)
    log_prob[:, 0] = 0.0
    log_prob = log_prob.reshape(R)
    length = torch.ones(R, dtype=torch.long, device=dev)
    done = torch.zeros(R, dtype=torch.bool, device=dev)
    base = (torch.arange(B, device=dev) * K)[:, None]
    for pos in range(max_length - 1):
        if bool(done.all()):
            break
        logits = ref.decode_step(rows[:, pos], pos, state)
        child = log_prob[:, None] + torch.log_softmax(logits, dim=-1)  # (R, V)
        V = child.shape[1]
        live = torch.where(done[:, None], float("-inf"), _score(child, length[:, None] + 1, length_penalty))
        kept = torch.where(done, _score(log_prob, length, length_penalty), float("-inf"))
        pool = torch.cat([live.reshape(B, K * V), kept.reshape(B, K)], dim=1)
        pick = torch.topk(pool, K, dim=1).indices  # (B, K)
        carried = pick >= K * V
        parent = torch.where(carried, pick - K * V, pick // V)
        token = torch.where(carried, eos, pick % V)
        src = (base + parent).reshape(R)
        new_lp = torch.gather(child.reshape(B, K * V), 1, torch.clamp(pick, max=K * V - 1))
        log_prob = torch.where(carried, log_prob.reshape(B, K).gather(1, parent), new_lp).reshape(R)
        length = length[src] + (~carried).reshape(R).long()
        done = done[src] | (token.reshape(R) == eos)
        rows = rows[src]
        rows[:, pos + 1] = token.reshape(R)
        ref.reorder(state, src, pos + 1)
    final = _score(log_prob, length, length_penalty).reshape(B, K)
    order = torch.argsort(final, dim=1, descending=True)
    return rows.reshape(B, K, max_length).gather(1, order[..., None].expand(B, K, max_length))
