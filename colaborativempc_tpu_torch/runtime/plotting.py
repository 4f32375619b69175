"""Track and trajectory plotting (PyTorch port of
``colaborativempc_tpu/runtime/plotting.py``; reference
``plan_lib/plotter/plot_tools.py``).

Track rendering with half-width and shrink bands (:128-155), per-agent
trajectory overlays with waypoint markers (:30-47), car polygons (:107-122)
and step-by-step animation frames (:49-87), headless (Agg), so experiments
can always save figures (the reference's ``plot: -1`` mode).

Plotting is host work: a track is copied to host memory once and its
outlines computed there, and states arrive as numpy arrays or tensors on
any device. ``matplotlib`` is imported inside the functions that draw, so
the runtime and the scripts import on a machine without it; a script that
is asked to plot calls :func:`require_matplotlib` before its run.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from colaborativempc_tpu_torch.geometry.frenet import frenet_to_cartesian
from colaborativempc_tpu_torch.geometry.tracks import Track

_COLORS = ["tab:blue", "tab:orange", "tab:green", "tab:red", "tab:purple",
           "tab:brown", "tab:pink", "tab:gray", "tab:olive", "tab:cyan"]


def pyplot():
    """``matplotlib.pyplot`` on the headless Agg backend."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def require_matplotlib(hint: str) -> None:
    """Raise ``RuntimeError`` ending in ``hint`` (how the caller runs
    without plots) when matplotlib cannot be imported."""
    try:
        pyplot()
    except ImportError as e:
        raise RuntimeError(f"plotting needs matplotlib, which cannot be "
                           f"imported ({e}); {hint}") from e


def _numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _host(track: Track) -> Track:
    return Track(*(t.detach().cpu() for t in track))


def track_outline(track: Track, lane: int = 0, n: int = 600, sm: float = 0.9):
    """Centerline, boundary and shrink-band polylines as numpy ``(x, y)``
    pairs: ``(center, left, right, shrunk left, shrunk right)``."""
    track = _host(track)
    L = float(track.track_length[lane])
    s = np.linspace(0.0, L - 1e-4, n)
    hw = track.halfwidth[lane].numpy()[
        np.clip(np.searchsorted(track.s0[lane].numpy(), s, side="right") - 1,
                0, track.n_segments - 1)]
    s = torch.as_tensor(s, dtype=track.s0.dtype)
    hw = torch.as_tensor(hw, dtype=track.s0.dtype)
    out = []
    for ey in (torch.zeros_like(s), hw, -hw, hw * sm, -hw * sm):
        x, y, _ = frenet_to_cartesian(track, s, ey, lane)
        out.append((x.numpy(), y.numpy()))
    return tuple(out)


def plot_track(track: Track, ax=None, sm: float = 0.9, lanes=None):
    """Render the track (reference _initializeFigure_xy, plot_tools.py:128)."""
    plt = pyplot()
    if ax is None:
        _, ax = plt.subplots(figsize=(10, 7))
    track = _host(track)
    lanes = range(track.n_lanes) if lanes is None else lanes
    for lane in lanes:
        c, l, r, sl, sr = track_outline(track, lane, sm=sm)
        ax.plot(*c, "k--", lw=0.6, alpha=0.6)
        ax.plot(*l, "k-", lw=1.2)
        ax.plot(*r, "k-", lw=1.2)
        ax.plot(*sl, "r:", lw=0.7, alpha=0.6)
        ax.plot(*sr, "r:", lw=0.7, alpha=0.6)
    ax.set_aspect("equal")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    return ax


def car_polygon(x, y, psi, w=0.1, l=0.2):
    """Car rectangle corners (reference getCarPosition, plot_tools.py:107)."""
    c, s = np.cos(psi), np.sin(psi)
    dx = [l * c - w * s, l * c + w * s, -l * c + w * s, -l * c - w * s]
    dy = [l * s + w * c, l * s - w * c, -l * s - w * c, -l * s + w * c]
    return np.asarray(x) + np.asarray(dx), np.asarray(y) + np.asarray(dy)


def save_figure(fig, path, name, dpi: int = 130):
    """Write ``fig`` to ``path/name`` (the directory made if missing), close
    it and return the file."""
    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, name)
    fig.savefig(out, dpi=dpi, bbox_inches="tight")
    pyplot().close(fig)
    return out


def plot_experiment(track: Track, states, path=None, name="track.png",
                    sm: float = 0.9, show_cars_every: int = 0):
    """Offline trajectory overlay of all agents (reference
    plotter_offline); ``states``: ``(T, n_agents, 9)`` executed states.
    Returns the written file, or the axes when ``path`` is None."""
    states = _numpy(states)
    ax = plot_track(track, sm=sm)
    for a in range(states.shape[1]):
        col = _COLORS[a % len(_COLORS)]
        ax.plot(states[:, a, 7], states[:, a, 8], "-", color=col, lw=1.5,
                label=f"agent {a}")
        ax.plot(states[::10, a, 7], states[::10, a, 8], "o", color=col,
                ms=2.5)
        if show_cars_every:
            for t in range(0, states.shape[0], show_cars_every):
                cx, cy = car_polygon(states[t, a, 7], states[t, a, 8],
                                     states[t, a, 5])
                ax.fill(cx, cy, color=col, alpha=0.3)
    ax.legend(loc="best", fontsize=8)
    return ax if path is None else save_figure(ax.figure, path, name)


def plot_performance(states, dt, path=None, name="perf.png"):
    """Velocity and inter-agent distance plots (reference
    plot_tools.py:178-196)."""
    plt = pyplot()
    states = _numpy(states)
    T, n_ag = states.shape[0], states.shape[1]
    t = np.arange(T) * dt
    fig, axes = plt.subplots(2, 1, figsize=(9, 6), sharex=True)
    for a in range(n_ag):
        axes[0].plot(t, states[:, a, 0], color=_COLORS[a % len(_COLORS)],
                     label=f"agent {a}")
    axes[0].set_ylabel("vx [m/s]")
    axes[0].legend(fontsize=8)
    for i in range(n_ag):
        for j in range(i + 1, n_ag):
            d = np.hypot(states[:, i, 7] - states[:, j, 7],
                         states[:, i, 8] - states[:, j, 8])
            axes[1].plot(t, d, label=f"{i}-{j}")
    axes[1].set_ylabel("pair distance [m]")
    axes[1].set_xlabel("t [s]")
    axes[1].legend(fontsize=8)
    return axes if path is None else save_figure(fig, path, name)


def animate_experiment(track: Track, states, path=None, name="run.gif",
                       preds=None, fps: int = 12, every: int = 1,
                       sm: float = 0.9, trail: int = 200):
    """Step-by-step animation of a run, rendered headless to a GIF: car
    polygons, incremental trails and the current predicted trajectory (the
    reference's live mode, ``plotter.animate_step``, plot_tools.py:89-103).

    ``states``: ``(T, n_agents, 9)`` executed states; ``preds``: optional
    ``(T, n_agents, N+1, 9)`` per-step predictions (``ExperimentIO``'s
    ``s_pred_hist``, the pickled states.pkl replay data). Returns the
    written file, or the ``FuncAnimation`` when ``path`` is None.
    """
    plt = pyplot()
    from matplotlib.animation import FuncAnimation, PillowWriter

    states = _numpy(states)
    preds = None if preds is None else _numpy(preds)
    T, n_ag = states.shape[0], states.shape[1]
    frames = range(0, T, max(int(every), 1))

    fig, ax = plt.subplots(figsize=(9, 6))
    plot_track(track, ax=ax, sm=sm)
    trails, cars, plans = [], [], []
    for a in range(n_ag):
        col = _COLORS[a % len(_COLORS)]
        (tr,) = ax.plot([], [], "-", color=col, lw=1.2, label=f"agent {a}")
        trails.append(tr)
        cars.append(ax.fill([], [], color=col, alpha=0.6)[0])
        (pl,) = ax.plot([], [], ":", color=col, lw=1.0, alpha=0.8)
        plans.append(pl)
    ax.legend(loc="best", fontsize=8)

    def update(t):
        lo = max(0, t - trail)
        for a in range(n_ag):
            trails[a].set_data(states[lo:t + 1, a, 7],
                               states[lo:t + 1, a, 8])
            cx, cy = car_polygon(states[t, a, 7], states[t, a, 8],
                                 states[t, a, 5])
            cars[a].set_xy(np.stack([cx, cy], axis=-1))
            if preds is not None:
                plans[a].set_data(preds[t, a, :, 7], preds[t, a, :, 8])
        return trails + cars + plans

    anim = FuncAnimation(fig, update, frames=frames, blit=True)
    if path is None:
        return anim
    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, name)
    anim.save(out, writer=PillowWriter(fps=fps))
    plt.close(fig)
    return out
