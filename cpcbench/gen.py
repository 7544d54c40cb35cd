"""The one traffic generator: a mix file's parameters and a seed give the
rounds of a closed loop.

A mix lists its prompt lengths (``prompt_lengths``), the greedy tokens a
request is served (``output_tokens``) and the replicas of the fleet.  Each
round serves one batch a replica, each batch of one prompt length.  The
lengths are paired shortest with longest (a middle one with itself), and
a round serves one pair, a length to each replica, which length to which
replica drawn from the seed.  A cycle serves every pair once, so it serves
every length once, in an order the seed draws anew each cycle.  So every
seed sends the same lengths in another order, to either replica, and
every round of an evenly spaced mix the same number of prompt tokens.
"""

from __future__ import annotations

import random

import torch

_MIX = 1_000_003     # spreads (seed, round, replica) over generator seeds


def pairs(lengths: list) -> list:
    """The mix's lengths paired shortest with longest."""
    xs = sorted(int(s) for s in lengths)
    return [(xs[i], xs[-1 - i]) for i in range((len(xs) + 1) // 2)]


def round_lengths(mix: dict, seed: int, r: int) -> tuple:
    """The prompt length of each replica's batch in round ``r``."""
    if mix["replicas"] != 2:
        raise ValueError("a round serves one pair of lengths to two "
                         f"replicas, not {mix['replicas']}")
    ps = pairs(mix["prompt_lengths"])
    cycle, pos = divmod(r, len(ps))
    rng = random.Random(seed * _MIX + cycle)
    order = rng.sample(range(len(ps)), len(ps))
    swap = [rng.random() < 0.5 for _ in ps]
    short, long = ps[order[pos]]
    return (short, long) if swap[pos] else (long, short)


def prompts(seed: int, r: int, replica: int, n: int, length: int,
            vocab: int, device) -> torch.Tensor:
    """The ``(n, length)`` prompt tokens of replica ``replica``'s batch in
    round ``r`` (round ``-1``: the warm-up), drawn on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed(((seed * _MIX + r + 1) * _MIX + replica) % (1 << 63))
    return torch.randint(0, vocab, (n, length), generator=g, device=device)
