"""The one traffic generator: seeded perturbed starts of fleets.

A traffic file (``benchmark/traffic/<name>.json``) holds the parameters:

- ``kind``: ``sweep`` (a Monte-Carlo batch of ``fleets`` in lock-step,
  episodes of ``episode_steps`` control steps back to back, each episode a
  fresh perturbed batch) or ``course`` (one fleet driving its course, every
  step synchronised and timed, up to the configuration's ``max_it`` steps
  or the end of its lap, then the next course);
- ``fleets``; ``episode_steps`` (sweeps);
- ``noise``: the scale of the x0 perturbation of (vx, vy, wz);
- ``pool`` (optional): a fixed seed of the starts. Every run then draws
  episode ``e``'s batch of starts from ``pool``, whatever its own seed,
  and its seed only orders the fleets of that batch: every seed gives the
  same work, in another order, and the check samples other fleet-steps.
  Without it the run's seed draws the starts.

Every random draw of a run comes from ``stream(seed, ...)`` (and
``stream(pool, ...)``), so one seed gives the same starts whatever the
speed of the system under test.
"""

from __future__ import annotations

import numpy as np

WARM, EPISODE, SAMPLE = 0, 1, 2   # the streams of one seed


def stream(seed: int, *keys: int) -> np.random.Generator:
    """The generator of one purpose (``keys``) of run ``seed``; any
    non-negative whole seed, past 32 bits included."""
    return np.random.default_rng([int(seed), *keys])


def perturb_x0(shape, noise, rng) -> np.ndarray:
    """x0 perturbation of (vx, vy, wz) only: the pose states (ey, epsi,
    theta, s, X, Y) are redundant Frenet/Cartesian pairs that must stay
    consistent. Draws ``rng.normal(size=shape)``. A frozen copy of the
    port's ``scripts/monte_carlo.py perturb_x0``."""
    pert = rng.normal(size=shape) * noise
    pert[..., 3:] = 0.0
    return pert


def _draw(traffic: dict, n_agents: int, seed: int, *keys: int):
    shape = (traffic["fleets"], n_agents, 9)
    pool = traffic.get("pool")
    if pool is None:
        return perturb_x0(shape, traffic["noise"], stream(seed, *keys))
    pert = perturb_x0(shape, traffic["noise"], stream(pool, *keys))
    return pert[stream(seed, *keys).permutation(shape[0])]


def start_perturbation(traffic: dict, n_agents: int, seed: int,
                       episode: int) -> np.ndarray:
    """``(fleets, n_agents, 9)`` perturbation of episode (or course)
    ``episode`` of run ``seed``."""
    return _draw(traffic, n_agents, seed, EPISODE, episode)


def warm_perturbation(traffic: dict, n_agents: int,
                      seed: int) -> np.ndarray:
    """The perturbation of the set-up's warm steps, a stream of its own so
    the window's episodes do not depend on the warm-up."""
    return _draw(traffic, n_agents, seed, WARM)
