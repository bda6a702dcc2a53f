#!/usr/bin/env python
"""Scaling sweep: throughput vs batch size on one device.

Complements the headline bench.py (single JSON line) with the curve
behind it: columns*bins/s as a function of batch size, on the XLA
sweep engine.  Every line names the device it ran on; a run on a CPU
shows the shape of the curve, not a device number.

    python tools/bench_scaling.py
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

N_BINS = 500
N_LAYERS = 30
N_ITERS = 20


def main():
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

    dev = jax.devices()[0]
    print(f"device={dev.platform} kind={dev.device_kind!r} "
          f"count={len(jax.devices())}")
    print(f"{'columns':>8s} {'wall_s':>8s} {'cols*bins/s':>14s}")

    cfg = SolverConfig(n_timesteps=N_ITERS, n_zero_crossings=10 ** 6,
                       convergence_dT=0.0)
    for n_cols in (256, 512, 1024, 2048, 4096, 8192):
        T0 = jnp.asarray(
            base[None, :] * rng.uniform(0.95, 1.05, (n_cols, 1)),
            jnp.float32)
        fn = lambda x: solve_rc_batched(  # noqa: E731
            x, grid._consts, planet.physics_params(),
            grid._kappa_fn, cfg)
        out = fn(T0)
        jax.block_until_ready(out.flux)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = fn(T0)
            jax.block_until_ready(out.flux)
            times.append(time.perf_counter() - t0)
        wall = min(times)
        print(f"{n_cols:8d} {wall:8.3f} {n_cols * N_BINS / wall:14.0f}")


if __name__ == "__main__":
    main()
