#!/usr/bin/env python
"""Capture a jax.profiler trace of the headline solve and summarize it.

Runs the bench.py workload (8192 columns x 500 bins x 30 layers x 20 RC
iterations, float32, XLA sweep engine) under ``jax.profiler.trace`` and
aggregates the event durations from the emitted Chrome-trace JSON: how
the wall clock splits across the compiled kernels.

Run: python tools/profile_solve.py
"""

from __future__ import annotations

import glob
import gzip
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

N_COLUMNS, N_BINS, N_LAYERS, N_ITERS = 8192, 500, 30, 20


def run_traced(log_dir="/tmp/frei_tpu_trace"):
    import jax
    import jax.numpy as jnp

    from frei_tpu import Grid, Planet, load_example_opacity
    from frei_tpu.rt.solver import SolverConfig, solve_rc_batched

    planet = Planet.from_hot_jupiter()
    grid = Grid(planet, n_wl_bins=N_BINS, n_layers=N_LAYERS,
                T_ref=2400.0, dtype=jnp.float32)
    grid.load_opacities(opacities=load_example_opacity(
        grid, scale_factor=1.0, dtype=jnp.float32))
    rng = np.random.RandomState(0)
    base = np.asarray(grid.rt_grid.init_temperatures)
    T0 = jnp.asarray(base[None, :] * rng.uniform(0.95, 1.05,
                                                 (N_COLUMNS, 1)),
                     jnp.float32)
    cfg = SolverConfig(n_timesteps=N_ITERS, n_zero_crossings=10 ** 6,
                       convergence_dT=0.0)
    args = (grid._consts, planet.physics_params(), grid._kappa_fn)
    r = solve_rc_batched(T0, *args, cfg)           # compile + warm
    jax.block_until_ready(r.flux)
    jax.profiler.start_trace(log_dir)
    t0 = time.perf_counter()
    r = solve_rc_batched(T0, *args, cfg)
    jax.block_until_ready(r.flux)
    wall = time.perf_counter() - t0
    jax.profiler.stop_trace()
    return log_dir, wall


def summarize(log_dir, wall):
    paths = sorted(glob.glob(
        f"{log_dir}/**/*.trace.json.gz", recursive=True))
    if not paths:
        print(f"wall={wall:.4f}s; no trace.json.gz under {log_dir} — "
              "inspect the .xplane.pb with xprof/TensorBoard instead")
        return
    with gzip.open(paths[-1], "rt") as f:
        trace = json.load(f)
    durs = defaultdict(float)
    counts = defaultdict(int)
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        name = ev.get("name", "?")
        durs[name] += ev["dur"] / 1e6       # us -> s
        counts[name] += 1
    top = sorted(durs.items(), key=lambda kv: -kv[1])[:20]
    print(f"wall = {wall:.4f} s "
          f"({N_COLUMNS * N_BINS / wall / 1e6:.2f} M cols*bins/s); "
          f"top trace events:")
    for name, t in top:
        print(f"  {t:8.4f} s  x{counts[name]:5d}  {name[:90]}")


if __name__ == "__main__":
    summarize(*run_traced())
