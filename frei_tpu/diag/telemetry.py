"""Observability: convergence telemetry, profiling, NaN debugging.

The reference's only observability is a tqdm progress bar with a
``max|dT|`` / converged-layer-count description
(`/root/reference/frei/core.py:269-271,312-315`).  frei_tpu keeps that
signal — streamed out of the jitted while-loop with
``jax.debug.callback`` — and adds structured per-solve metrics, a
``jax.profiler`` trace context, a NaN-debugging toggle, and the
persistent compilation cache setting of the run scripts.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass
from pathlib import Path

import jax
import numpy as np

__all__ = ["SolveMetrics", "flux_balance", "progress_printer",
           "profile_trace", "enable_nan_debugging", "use_compile_cache"]


@dataclass
class SolveMetrics:
    """Structured summary of one radiative-convective solve."""

    n_iterations: int
    converged_layers: int       # layers converged (in every column, if batched)
    n_layers: int
    max_dT_history: np.ndarray
    wall_seconds: float
    columns: int = 1
    bins: int = 0
    converged_columns: int | None = None  # batched solves only

    @property
    def converged(self) -> bool:
        if self.converged_columns is not None:
            return self.converged_columns == self.columns
        return self.converged_layers == self.n_layers

    @property
    def columns_bins_per_second(self) -> float:
        if self.wall_seconds <= 0:
            return float("nan")
        return self.columns * self.bins / self.wall_seconds

    def summary(self) -> str:
        tail = (self.max_dT_history[self.n_iterations - 1]
                if self.n_iterations > 0 else float("nan"))
        conv = (f"conv={self.converged_columns}/{self.columns} cols"
                if self.converged_columns is not None
                else f"conv={self.converged_layers}/{self.n_layers}")
        return (f"iters={self.n_iterations} {conv} "
                f"max|dT|={tail:.2f} K wall={self.wall_seconds:.3f}s")

    @classmethod
    def from_result(cls, result, wall_seconds: float,
                    columns: int = 1) -> "SolveMetrics":
        conv = np.asarray(result.converged)
        hist = np.asarray(result.max_dT_history)
        if hist.ndim == 2:   # batched result: worst column per iter
            hist = hist.max(axis=0)
        batched = conv.ndim > 1
        return cls(
            n_iterations=int(np.max(np.asarray(result.n_iterations))),
            # batched: a layer counts as converged when it converged in
            # every column (conv.all over the column axis)
            converged_layers=int(conv.sum()) if not batched
            else int(conv.all(axis=0).sum()),
            n_layers=conv.shape[-1],
            max_dT_history=hist,
            wall_seconds=wall_seconds,
            columns=columns,
            bins=int(np.asarray(result.flux).shape[-1]),
            converged_columns=int(conv.all(axis=-1).sum()) if batched
            else None,
        )


def flux_balance(result, trapz_w) -> np.ndarray:
    """Relative bolometric net-flux spread across the interior layers
    (layer 0 is excluded: the reference driver initializes F_up[0] to
    zero and never updates it, `core.py:265-266` with
    `twostream.py:356` — faithfully reproduced here).

    Equilibration telemetry, not a convergence gate: at perfect
    radiative equilibrium the net flux is height-constant, but the
    scheme's dT criterion (`core.py:301-311`) stops at |dT| < 3 K,
    where the adaptive timestep (Malik Eqs 27-28) still tolerates an
    O(1) residual net-flux gradient — the metric decreases
    monotonically with further iteration without reaching zero.
    Works on single and batched results; returns per-column values."""
    tw = np.asarray(trapz_w, np.float64)
    net = (np.asarray(result.F_up, np.float64)
           - np.asarray(result.F_down, np.float64)) @ tw   # (..., L)
    net = net[..., 1:]
    emergent = np.asarray(result.flux, np.float64) @ tw
    spread = net.max(axis=-1) - net.min(axis=-1)
    return spread / np.abs(emergent)


def progress_printer(it, max_dT, n_conv, n_layers):
    """Default progress callback: the reference's tqdm description line
    (`core.py:312-315`), printed per outer iteration."""
    print(f"RC iter {int(it):4d}: max|dT| = {float(max_dT):8.2f} K; "
          f"conv = {int(n_conv)}/{int(n_layers)}", flush=True)


@contextlib.contextmanager
def profile_trace(log_dir: str = "/tmp/frei_tpu_trace"):
    """Capture a jax.profiler trace around a block (view with
    TensorBoard or xprof)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def enable_nan_debugging(enable: bool = True):
    """Toggle jax_debug_nans: the solver is functional, so the
    reference's race-condition surface does not exist (SURVEY.md
    section 5); NaN provenance is the useful debug axis instead."""
    jax.config.update("jax_debug_nans", enable)


def use_compile_cache(default_dir) -> str:
    """Keep JAX's persistent compilation cache in one fixed directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself
    and this sets nothing.  Otherwise the cache goes to
    ``default_dir``, which callers fix (never a temporary, per-process
    or timed name: a cache whose path moves between runs never hits).
    Call before the first compilation; importing the package does not.
    Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = str(Path(default_dir).resolve())
    jax.config.update("jax_compilation_cache_dir", path)
    return path
