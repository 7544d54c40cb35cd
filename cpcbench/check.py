"""What decides ``correct``: the window's own outputs against the plain
reference, once the window has closed and the program's state is freed.

- **The served tokens.**  Two batches of the window, drawn from the seed
  (:class:`Sample`): one among those at the longest prompt it served, and
  one drawn uniformly among all the others, whatever their length and
  replica; of each, the cell's ``check_rows`` requests (all where the
  cell names none).  They run through :func:`cpcbench.reference.model
  .logits`, float32 with TF32 off, over each prompt and the tokens it was
  served (teacher forced), on weights drawn again from the seed; a
  batch of a model with experts runs whole, since its capacity and drops
  depend on every request in it.  :func:`served_numbers` are its
  readings; a cell's file names those it compares, with their limits.
- **The fleet.**  Every round's routing against :func:`cpcbench.reference
  .fleet.route` over the capacities of that round's caps
  (``routing_mismatch``, rounds); the cap event's caps: their sum against
  the sum before the invocation (``cap_sum_err_w``), the imbalance of the
  hosts' normalized entitlements (``cap_imbalance``, the balancer's stated
  threshold), caps outside the hosts' range (``cap_range_violations``).
- ``failed_requests``: requests whose tokens or logits were malformed.

Each compared number passes where it is at most its limit.

The control (``control=True``) puts the reference computed in float8 in
the program's place: its tokens are its own argmax at each position of
the same prompts and served tokens.
"""

from __future__ import annotations

import random
from typing import Optional

import torch

from cpcbench import gen
from cpcbench.reference import fleet as ref_fleet
from cpcbench.reference import model as ref_model
from cpcbench.weights import make_weights

_ROWS = 7919         # spreads (seed, round, replica) over the rows' draws


class Sample:
    """The batches whose logits the window keeps for the check, chosen as
    it runs: each at the longest prompt served so far, and one among the
    others, a reservoir of one, so that it is drawn uniformly from all
    that the window served.  :meth:`offer` gives the rows of a batch to
    keep, or ``None``; a batch that drops out of the sample has its
    logits set to ``None``."""

    def __init__(self, cell, seed: int):
        self.seed = seed
        self.rows = cell.cell.get("check_rows")
        self.longest: list = []
        self.other = None
        self._others = 0
        self._rng = random.Random(seed)

    def _rows(self, b) -> list:
        if self.rows is None or self.rows >= b.n:
            return list(range(b.n))
        rng = random.Random((self.seed * _ROWS + b.round) * _ROWS + b.replica)
        return sorted(rng.sample(range(b.n), self.rows))

    def _drop(self, batches) -> None:
        for b in batches:
            b.logits = None

    def offer(self, b) -> Optional[list]:
        top = self.longest[0].length if self.longest else 0
        if b.length > top:
            self.offer_other(self.longest)
            self.longest = [b]
            return self._rows(b)
        if b.length == top:
            self.longest.append(b)
            return self._rows(b)
        return self._rows(b) if self.offer_other([b]) else None

    def offer_other(self, batches: list) -> bool:
        """Offers each of ``batches`` to the reservoir; True where the last
        stays in it."""
        stays = False
        for b in batches:
            self._others += 1
            stays = self._rng.random() * self._others < 1.0
            if stays:
                if self.other is not None:
                    self._drop([self.other])
                self.other = b
            elif b.logits is not None:
                self._drop([b])
        return stays

    def batches(self) -> list:
        """The batches checked: one at the longest prompt, drawn by the
        seed, and the reservoir's."""
        out = [random.Random(self.seed).choice(self.longest)]
        return out + ([self.other] if self.other is not None else [])


def served_numbers(ref: list, logits: list, tokens: list) -> dict:
    """The numbers of served ``tokens`` (r, steps) and their ``logits``
    (r, steps, V) against the reference's ``ref``, each a list over the
    batches checked:

    - ``gap_max``: the widest gap of a served token below the reference's
      best;
    - ``gap_mean``: the mean of that gap over the served tokens;
    - ``logit_rel_l2``: the largest relative L2 distance of a request's
      logits;
    - ``logit_rel_l2_p50``: the median over positions of a position's
      relative L2 distance;
    - ``request_rel_l2_p50_max``: the largest, over requests, of the
      median over the request's positions of that distance.

    Medians take the mean of the two middle values of an even count."""
    gaps, pos, req = [], [], []
    for r, x, t in zip(ref, logits, tokens):
        gaps.append((r.amax(-1) - r.gather(-1, t[..., None])[..., 0]).cpu())
        pos.append(((x - r).norm(dim=-1) / r.norm(dim=-1)).cpu())
        req.append(((x - r).flatten(1).norm(dim=1)
                    / r.flatten(1).norm(dim=1)).cpu())
    gap, pos, req = torch.cat(gaps), torch.cat(pos), torch.cat(req)
    return {"gap_max": float(gap.amax()), "gap_mean": float(gap.mean()),
            "logit_rel_l2": float(req.amax()),
            "logit_rel_l2_p50": float(pos.flatten().quantile(0.5)),
            "request_rel_l2_p50_max": float(pos.quantile(0.5, dim=1).amax())}


def model_numbers(port, cell, win, seed: int, device,
                  control: bool = False) -> dict:
    """The served-token numbers of the sampled batches (the control's with
    ``control``).  Call with the program's weights and state freed."""
    steps = cell.mix["output_tokens"]
    m = cell.config["run_as"]
    weights = make_weights(port.specs, seed, port.dtype, device)
    refs, outs, toks = [], [], []
    for b in win.sample.batches():
        prompt = gen.prompts(seed, b.round, b.replica, b.n, b.length,
                             m["vocab_size"], device)
        served = b.tokens.to(device)
        rows = torch.tensor(b.rows, device=device)
        whole = m["family"] == "moe"
        if not whole:
            prompt, served = prompt[rows], served[rows]
        seq = torch.cat([prompt, served[:, :-1]], 1)
        ref = ref_model.logits(weights, m, seq, b.length, steps)
        if whole:
            ref, served = ref[rows], served[rows]
        refs.append(ref)
        if not control:
            outs.append(b.logits.to(device))
            toks.append(served)
            continue
        low = ref_model.logits(weights, m, seq, b.length, steps, fp8=True)
        low = low[rows] if whole else low
        outs.append(low)
        toks.append(low.argmax(-1))
    return served_numbers(refs, outs, toks)


def fleet_numbers(cell, win) -> dict:
    mix = cell.mix
    host = mix["host"]
    n_round = cell.cell["requests_per_replica"] * mix["replicas"]
    mismatched = 0
    for rnd in win.rounds:
        capacity = [ref_fleet.managed_capacity(c, host) for c in rnd["caps"]]
        mismatched += ref_fleet.route(capacity, n_round) != rnd["counts"]
    event = mix["cap_event"]
    before = [c * (event["cap_factor"] if f"h{i}" == event["host"] else 1.0)
              for i, c in enumerate(win.caps_start)]
    after = win.caps_after
    out_of_range = sum(not host["power_idle_w"] <= c <= host["power_peak_w"]
                       for c in after)
    return {"routing_mismatch": mismatched,
            "cap_sum_err_w": abs(sum(after) - sum(before)),
            "cap_imbalance": ref_fleet.imbalance(after, host),
            "cap_range_violations": out_of_range}


def limits(cell) -> dict:
    return {**cell.cell["limits"], **cell.mix["limits"],
            "failed_requests": 0}


def judge(numbers: dict, bounds: dict) -> tuple:
    """``(correct, {name: {"value", "limit"}})`` over the numbers that have
    a limit: correct when each is at most its limit."""
    checks = {k: {"value": numbers[k], "limit": v} for k, v in bounds.items()}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
