"""Experiment IO: metrics accumulation, console progress, on-disk schema
(PyTorch port; numpy only).

Counterpart of ``colaborativempc_tpu/runtime/io.py``, writing the same
schema as the JAX package and the reference, so the same post-processing
reads both:

- per-agent tables under ``<path>/csv/<agent_id>/``: ``states.dat``,
  ``u.dat``, ``plan_dist.dat``, ``time.dat``, ``OCD_it.dat`` and
  ``time_OCD.dat`` (measured per-iteration rows) or ``time_OCD_mean.dat``
  (reference ``config/base_class.py:64-99``);
- per-agent pickles under ``<path>/pck/<agent_id>/`` (``states.pkl``,
  ``u.pkl``) and the dual warm start ``pck/ini_lambdas.pkl``
  (``base_class.py:102-141``, ``NL_EU_N_main.py:174-175``);
- a ``settings.csv`` snapshot of the configuration
  (``utilities/misc.py:264-275``).

The experiment runners call ``update`` with one fleet's state and metrics
as numpy arrays. ``live_plot_every=k`` refreshes ``<path>/live.png`` every
k control steps (the reference's online plot, headless).
"""

from __future__ import annotations

import csv
import dataclasses
import os
import pickle
import time
from typing import Optional

import numpy as np


class ExperimentIO:
    """Accumulates per-step fleet data and writes the reference schema.
    Plugs into ``run_lpv_experiment`` / ``run_nl_experiment`` through their
    ``io`` argument: ``update(it, state, metrics, step_time)`` once per
    control step."""

    def __init__(self, cfg, path: Optional[str] = None,
                 live_plot_every: int = 0):
        self.cfg = cfg
        self.path = path if path is not None else cfg.path
        self.verb = cfg.verb
        self.n_agents = cfg.n_agents
        self.live_plot_every = live_plot_every
        self._track = None
        self.states = [[] for _ in range(cfg.n_agents)]
        self.inputs = [[] for _ in range(cfg.n_agents)]
        self.look_ahead = [[] for _ in range(cfg.n_agents)]
        self.s_pred_hist = [[] for _ in range(cfg.n_agents)]
        self.u_pred_hist = [[] for _ in range(cfg.n_agents)]
        self.step_times = []
        self.ocd_iters = []
        # measured per-iteration OCD times (runs with cfg.verb_ocd)
        self.ocd_iter_times = []
        self._t0 = time.time()

    def tic(self):
        self._tic = time.time()

    def toc(self):
        self.step_times.append(time.time() - self._tic)

    def update(self, it, state, metrics, step_time):
        x0 = np.asarray(state.x0)
        u_old = np.asarray(state.u_old)
        x_pred = np.asarray(state.x_pred)      # (n_ag, N+1, 9)
        u_pred = np.asarray(state.u_pred)
        for a in range(self.n_agents):
            self.states[a].append(x0[a])
            self.inputs[a].append(u_old[a])
            # look-ahead distance = s horizon span (base_class.py:51)
            self.look_ahead[a].append(x_pred[a, -1, 6] - x_pred[a, 0, 6])
            self.s_pred_hist[a].append(x_pred[a])
            self.u_pred_hist[a].append(u_pred[a])
        self.step_times.append(step_time)
        if hasattr(metrics, "ocd_iterations"):
            self.ocd_iters.append(int(metrics.ocd_iterations))
        if self.verb >= 1:
            print(f"[step {it}] t={time.time() - self._t0:6.1f}s "
                  f"s={np.array2string(x0[:, 6], precision=2)} "
                  f"step_time={step_time * 1e3:.1f}ms")
        if self.verb >= 2 and hasattr(metrics, "min_dist_exec"):
            print(f"         min_dist_exec={float(metrics.min_dist_exec):.3f}"
                  f" feasible={np.asarray(metrics.feasible)}")
        if self.live_plot_every and (it + 1) % self.live_plot_every == 0:
            self._render_live()

    def _render_live(self):
        """Plotting is host work: the track is built once on the CPU."""
        from colaborativempc_tpu_torch.geometry import make_track
        from colaborativempc_tpu_torch.runtime.plotting import plot_experiment
        if self._track is None:
            self._track = make_track(self.cfg.map_type, device="cpu")
        states = np.stack([np.asarray(s) for s in zip(*self.states)], axis=0)
        plot_experiment(self._track, states, path=self.path, name="live.png")

    def save_to_csv(self):
        def put(d, name, rows):
            np.savetxt(os.path.join(d, name), np.asarray(rows), fmt="%.5e",
                       delimiter=" ")

        for a in range(self.n_agents):
            d = os.path.join(self.path, "csv", str(a))
            os.makedirs(d, exist_ok=True)
            put(d, "states.dat", self.states[a])
            put(d, "u.dat", self.inputs[a])
            put(d, "plan_dist.dat", self.look_ahead[a])
            put(d, "time.dat", self.step_times)
            if not self.ocd_iters:
                continue
            put(d, "OCD_it.dat", self.ocd_iters)
            if self.ocd_iter_times:
                # measured per-iteration rows, zero-padded
                lim = max(len(r) for r in self.ocd_iter_times)
                tab = np.zeros((len(self.ocd_iter_times), lim))
                for i, row in enumerate(self.ocd_iter_times):
                    tab[i, :len(row)] = row
                put(d, "time_OCD.dat", tab)
            else:
                # no per-iteration times were measured: the derived mean gets
                # its own name rather than posing as time_OCD.dat rows
                its = np.asarray(self.ocd_iters, dtype=float)
                times = np.asarray(self.step_times)[: len(its)]
                put(d, "time_OCD_mean.dat", times / np.maximum(its, 1.0))

    def save_exp(self):
        """Full prediction histories for replay (base_class.py:125-141)."""
        for a in range(self.n_agents):
            d = os.path.join(self.path, "pck", str(a))
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, "states.pkl"), "wb") as f:
                pickle.dump(self.s_pred_hist[a], f)
            with open(os.path.join(d, "u.pkl"), "wb") as f:
                pickle.dump(self.u_pred_hist[a], f)

    def save_lambdas(self, lambdas, name="ini_lambdas"):
        d = os.path.join(self.path, "pck")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, f"{name}.pkl"), "wb") as f:
            pickle.dump(np.asarray(lambdas), f)

    def save_config(self, name="settings"):
        os.makedirs(self.path, exist_ok=True)
        with open(os.path.join(self.path, f"{name}.csv"), "w",
                  newline="") as f:
            w = csv.writer(f)
            for field in dataclasses.fields(self.cfg):
                w.writerow([field.name, getattr(self.cfg, field.name)])

    def save_all(self, lambdas=None):
        self.save_config()
        self.save_to_csv()
        self.save_exp()
        if lambdas is not None:
            self.save_lambdas(lambdas)


def load_lambdas(path, n_agents, N):
    """Dual warm-start loader: a missing or unreadable file degrades to
    zeros with a warning (reference misc.py:218-231)."""
    try:
        with open(path, "rb") as f:
            return np.asarray(pickle.load(f))
    except Exception as e:  # noqa: BLE001 - the reference's behaviour
        import warnings
        warnings.warn(f"unable to load lambdas ({e}), defaulting to 0s")
        return np.zeros((n_agents, n_agents, N))


def load_experiment(path, agent_id):
    """Replay loader (reference eval_exp.py): the agent's prediction and
    input histories."""
    d = os.path.join(path, "pck", str(agent_id))
    with open(os.path.join(d, "states.pkl"), "rb") as f:
        states = pickle.load(f)
    with open(os.path.join(d, "u.pkl"), "rb") as f:
        u = pickle.load(f)
    return states, u
