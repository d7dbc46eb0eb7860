"""One-Euro temporal filtering, vectorized over whole tracks (port of
`poco_tpu.utils.one_euro`, numpy).

Adaptive low-pass filter (Casiez et al., CHI 2012): the cutoff frequency
rises with the signal's speed, so slow drift is smoothed hard while fast
motion passes through with low lag. Role in the pipeline matches the
reference's demo smoothing (pocolib/utils/one_euro_filter.py via
smooth_pose.py:25-71), but the design is track-first: the primary API
filters an entire (T, ...) sequence with every channel (e.g. all 24x3x3
rotation entries) updated at once per frame — the recurrence is over T
only. A functional step (state in, state out) backs both the track scan
and the thin streaming wrapper.
"""

from __future__ import annotations

import numpy as np

_TWO_PI = 2.0 * np.pi


def _alpha(dt, cutoff):
    """EMA weight for a first-order low-pass at `cutoff` Hz sampled
    `dt` apart: alpha = dt / (dt + tau), tau = 1/(2*pi*cutoff)."""
    dt = np.asarray(dt, np.float64)
    tau = 1.0 / (_TWO_PI * np.asarray(cutoff, np.float64))
    return dt / (dt + tau)


def one_euro_step(state, t, x, min_cutoff=1.0, beta=0.0, d_cutoff=1.0):
    """One filter update, pure function of (state, sample).

    state: (t_prev, x_hat_prev, dx_hat_prev) — arrays of the signal's
    shape (or scalars). Returns (new_state, x_hat). All channels update
    simultaneously; shapes broadcast numpy-style.
    """
    t_prev, x_prev, dx_prev = state
    dt = np.asarray(t, np.float64) - t_prev
    # Smoothed derivative, filtered at the (fixed) derivative cutoff.
    dx = (np.asarray(x, np.float64) - x_prev) / dt
    dx_hat = dx_prev + _alpha(dt, d_cutoff) * (dx - dx_prev)
    # Speed-adaptive cutoff, then the signal low-pass itself.
    cutoff = min_cutoff + beta * np.abs(dx_hat)
    x_hat = x_prev + _alpha(dt, cutoff) * (np.asarray(x, np.float64) - x_prev)
    return (np.asarray(t, np.float64), x_hat, dx_hat), x_hat


def one_euro_track(
    xs,
    ts=None,
    min_cutoff: float = 1.0,
    beta: float = 0.0,
    d_cutoff: float = 1.0,
) -> np.ndarray:
    """Filter a whole (T, ...) track in one call.

    Args:
        xs: (T, ...) signal — e.g. a (T, 24, 3, 3) rotation-matrix track;
            all trailing dims are independent channels.
        ts: optional (T,) timestamps; defaults to frame index.
    Returns:
        (T, ...) filtered track, same dtype as `xs`, first frame passed
        through unchanged.
    """
    xs = np.asarray(xs)
    if xs.ndim < 1 or len(xs) == 0:
        raise ValueError("xs must be a non-empty (T, ...) track")
    ts = np.arange(len(xs), dtype=np.float64) if ts is None else np.asarray(
        ts, np.float64
    )
    out = np.empty(xs.shape, np.float64)
    out[0] = xs[0]
    state = (ts[0], np.asarray(xs[0], np.float64), np.zeros(xs.shape[1:]))
    for i in range(1, len(xs)):
        state, out[i] = one_euro_step(
            state, ts[i], xs[i],
            min_cutoff=min_cutoff, beta=beta, d_cutoff=d_cutoff,
        )
    return out.astype(xs.dtype, copy=False)


class OneEuroFilter:
    """Streaming wrapper over `one_euro_step` for online use (webcam /
    incremental tracks). Prefer `one_euro_track` when the whole sequence
    is already in memory."""

    def __init__(
        self, t0, x0, dx0=0.0, min_cutoff=1.0, beta=0.0, d_cutoff=1.0
    ):
        x0 = np.asarray(x0, np.float64)
        self._state = (
            np.asarray(t0, np.float64),
            x0,
            np.broadcast_to(np.asarray(dx0, np.float64), x0.shape).copy()
            if x0.shape else np.asarray(dx0, np.float64),
        )
        self._knobs = dict(
            min_cutoff=float(min_cutoff),
            beta=float(beta),
            d_cutoff=float(d_cutoff),
        )

    def __call__(self, t, x):
        self._state, x_hat = one_euro_step(self._state, t, x, **self._knobs)
        return x_hat
