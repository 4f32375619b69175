"""Whether the timed path's answers are right: the plain reference follows
the system under test step by step from its own states.

While the window runs, :class:`Sampler` draws fleet-steps from the seed,
with the step of the most work among them and fleets from every part of
the batch, and keeps a copy of each one's state before and after (and no
other state). Once the window has closed, :func:`compare` runs the
float64 reference once over all of them, as one batch of independent
fleets, from the system's state before each, and measures the widest gaps
between the system's state after and the reference's, each part of the
state as the family file (``benchmark/families/<family>.py``) names it:

- ``x0_gap``: the executed states (``executed``: for the fleets the
  plant update after the exchange and the safety filter), in the states'
  own units (m, m/s, rad);
- ``plan_gap``: the new plans (``plans``: the QP's assembly and its ADMM
  solve, or the SQP's builds and solves);
- ``price_gap``: the coupling prices (``prices``; NL-OCD only: the OCD
  loop's duals), where the family has them;
- ``start_gap``: every episode's start (the system's fleet initialisation
  and batching) against the reference's own from the configuration, in
  the configuration's dtype on the system's device (no matrix product
  and no kernel is on that path, so it is an exact comparison: limit 0).

A number that is not finite fails. Each number has its limit in the
workload file (``check.limits``).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from benchmark.traffic import SAMPLE, stream


class Sampler:
    """The fleet-steps the check compares, drawn from the seed while the
    window runs, so that the window keeps only these and no other state:

    - slot 0: the fleet-step of the most work (the first of them), tracked
      on the device with no host read;
    - slots 1 to ``n - 1``: slot ``i`` draws one fleet from the ``i``-th of
      ``n`` equal parts of the batch (all fleet 0 for one fleet) and a step
      uniformly from the window's steps, by reservoir sampling (step ``t``
      replaces the slot with probability ``1 / (t + 1)``).

    Each kept fleet-step is a copy, on the device, of that fleet's state
    before and after the step."""

    def __init__(self, n: int, fleets: int, seed: int):
        self.n, self.fleets = n, fleets
        self.rng = stream(seed, SAMPLE)
        self.slots = [None] * n            # (step, fleet, pre, post)
        self.best = None                   # (effort, step, pre, post)
        self.steps = 0

    def observe(self, pre, post, effort) -> None:
        """Step ``self.steps`` of the window: states ``pre`` and ``post``
        of the whole batch and its ``(B,)`` work."""
        t = self.steps
        for i in range(1, self.n):
            lo = (i * self.fleets) // self.n
            hi = max(((i + 1) * self.fleets) // self.n, lo + 1)
            b = int(self.rng.integers(lo, hi))
            if self.rng.random() * (t + 1) < 1.0:
                self.slots[i] = (t, b, _take(pre, b), _take(post, b))
        b = torch.argmax(effort).reshape(1)
        e = effort.index_select(0, b)[0]
        pre_b = tuple(x.index_select(0, b) for x in pre)
        post_b = tuple(x.index_select(0, b) for x in post)
        step = torch.full((), t, dtype=torch.long, device=effort.device)
        if self.best is None:
            self.best = (e, step, b, pre_b, post_b)
        else:
            more = e > self.best[0]
            self.best = (torch.where(more, e, self.best[0]),
                         torch.where(more, step, self.best[1]),
                         torch.where(more, b, self.best[2]),
                         tuple(torch.where(more, x, y) for x, y in
                               zip(pre_b, self.best[3])),
                         tuple(torch.where(more, x, y) for x, y in
                               zip(post_b, self.best[4])))
        self.steps += 1

    def picks(self) -> list:
        """``[(step, fleet), ...]`` of the kept fleet-steps, slot 0 first."""
        out = [] if self.best is None else [
            (int(self.best[1]), int(self.best[2]))]
        return out + [(k, b) for k, b, _, _ in self.slots[1:]
                      if k is not None]

    def pull(self) -> List[tuple]:
        """The kept fleet-steps' states before and after, on the CPU."""
        if self.best is None:
            return []
        kept = [(self.best[3], self.best[4])] + [
            (pre, post) for _, _, pre, post in self.slots[1:]]
        return [(_cpu(pre), _cpu(post)) for pre, post in kept]


def _take(state, b: int) -> tuple:
    """A copy of fleet ``b`` of a batched state, with its batch axis."""
    return tuple(t[b:b + 1].clone() for t in state)


def _cpu(fleet: tuple) -> tuple:
    return tuple(t.detach().cpu() for t in fleet)


def _stack(fleets: List[tuple], like, device, dtype):
    """One batched state of the reference's type from per-fleet pieces."""
    fields = []
    for parts in zip(*fleets):
        t = torch.cat(parts, 0)
        fields.append(t.to(device=device, dtype=dtype)
                      if t.is_floating_point() else t.to(device))
    return type(like)(*fields)


def _gap(a: torch.Tensor, b: torch.Tensor) -> float:
    d = (a.double().cpu() - b.double().cpu()).abs()
    return float(d.max()) if d.numel() else 0.0


def compare(ref, pulled: List[tuple], start_ref, starts: List[tuple],
            start_perts: List[np.ndarray]) -> dict:
    """The gaps of the pulled fleet-steps against the reference system
    ``ref``, and of the episode starts against ``start_ref`` (both
    ``systems.FleetSystem``)."""
    pre = _stack([p for p, _ in pulled], ref.base, ref.device, ref.dtype)
    post, _ = ref.step(pre)
    got = [q for _, q in pulled]
    gaps = {"x0_gap": 0.0, "plan_gap": 0.0}
    if ref.prices(post) is not None:
        gaps["price_gap"] = 0.0
    for i, q in enumerate(got):
        want = type(post)(*(t[i:i + 1] for t in post))
        qs = type(post)(*q)
        gaps["x0_gap"] = max(gaps["x0_gap"], _gap(ref.executed(qs),
                                                  ref.executed(want)))
        gaps["plan_gap"] = max(gaps["plan_gap"], *map(
            _gap, ref.plans(qs), ref.plans(want)))
        if "price_gap" in gaps:
            gaps["price_gap"] = max(gaps["price_gap"], *map(
                _gap, ref.prices(qs), ref.prices(want)))
        for k in gaps:
            if not np.isfinite(gaps[k]):
                gaps[k] = float("inf")
    start_gap = 0.0
    for got_start, pert in zip(starts, start_perts):
        want = start_ref.start(pert.shape[0], pert)
        for a, b in zip(got_start, want):
            if a.is_floating_point():
                g = _gap(a, b)
                start_gap = max(start_gap, g if np.isfinite(g) else np.inf)
    gaps["start_gap"] = start_gap
    return gaps


def verdict(gaps: dict, limits: dict) -> dict:
    """``name -> {"value", "limit"}`` for every number with a limit, and
    whether all hold (a number with no reading fails)."""
    out = {k: {"value": gaps.get(k, float("inf")), "limit": v}
           for k, v in limits.items()}
    ok = all(np.isfinite(r["value"]) and r["value"] <= r["limit"]
             for r in out.values())
    return out, ok
