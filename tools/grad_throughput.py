"""Differentiable-path cost measurement on one device.

The production forward (``lax.while_loop``) vs the differentiable
fixed-horizon forward vs a full ``value_and_grad``, at the headline
spectral shape (500 bins x 30 layers x 20 fixed iterations, float32),
all on the XLA sweep engine.  It also asserts gradient finiteness at
production shape and dtype, which the float64 small-shape tests never
reach (this is how the round-5 float32 NaN-gradient bug was found).

Usage::

    python tools/grad_throughput.py [--columns 8192] [--grad-columns 8192]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

N_BINS, N_LAYERS, N_ITERS = 500, 30, 20


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--columns", type=int, default=8192)
    ap.add_argument("--grad-columns", type=int, default=8192)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from frei_tpu import Grid, Planet, load_example_opacity
    from frei_tpu.rt.solver import SolverConfig, solve_rc_batched

    planet = Planet.from_hot_jupiter()
    grid = Grid(planet, n_wl_bins=N_BINS, n_layers=N_LAYERS,
                T_ref=2400.0, dtype=jnp.float32)
    grid.load_opacities(opacities=load_example_opacity(
        grid, scale_factor=1.0, dtype=jnp.float32))
    p = planet.physics_params()
    kw = dict(n_timesteps=N_ITERS, n_zero_crossings=10 ** 6,
              convergence_dT=0.0)
    rng = np.random.RandomState(0)
    base = np.asarray(grid.rt_grid.init_temperatures)

    def T0_of(B):
        return jnp.asarray(
            base[None, :] * rng.uniform(0.95, 1.05, (B, 1)),
            jnp.float32)

    def timed(fn, *a):
        out = fn(*a)
        jax.block_until_ready(jax.tree.leaves(out)[0])
        walls = []
        for _ in range(4):
            t0 = time.perf_counter()
            out = fn(*a)
            jax.block_until_ready(jax.tree.leaves(out)[0])
            walls.append(time.perf_counter() - t0)
        return min(walls), out

    def flux_fn(differentiable):
        cfg = SolverConfig(differentiable=differentiable, **kw)
        return jax.jit(lambda T: solve_rc_batched(
            T, grid._consts, p, grid._kappa_fn, cfg).flux)

    dev = jax.devices()[0]
    print(f"device={dev.platform} kind={dev.device_kind!r}")
    B = args.columns
    w_fwd, _ = timed(flux_fn(False), T0_of(B))
    print(f"forward while-loop    B={B}: {w_fwd:.4f} s  "
          f"{B * N_BINS / w_fwd / 1e6:.2f}M cols*bins/s")
    w_dif, _ = timed(flux_fn(True), T0_of(B))
    print(f"forward differentiable B={B}: {w_dif:.4f} s  "
          f"{B * N_BINS / w_dif / 1e6:.2f}M  "
          f"({w_dif / w_fwd:.2f}x the while-loop forward)")

    Bg = args.grad_columns
    f = flux_fn(True)
    loss = lambda T: jnp.sum((f(T) / 1e13) ** 2)        # noqa: E731
    g = jax.jit(jax.value_and_grad(loss))
    w_g, (v, grads) = timed(g, T0_of(Bg))
    finite = bool(np.all(np.isfinite(np.asarray(grads))))
    print(f"value_and_grad (T0)   B={Bg}: {w_g:.4f} s  "
          f"{Bg * N_BINS / w_g / 1e6:.2f}M  grad_finite={finite}")
    assert finite, ("non-finite retrieval gradients at production "
                    "shape/dtype (the round-5 NaN-grad bug class)")

    # per-column retrieval leg: gradients w.r.t. per-column gravity
    # with per-column irradiation — the path that found BOTH round-5
    # float32 gradient bugs (the f_pre where-trap and the m_bar*g
    # quotient-rule overflow)
    from frei_tpu.rt.physics import PhysicsParams
    ftoa = jnp.broadcast_to(grid._consts.F_toa, (Bg, N_BINS)) \
        * jnp.asarray(rng.uniform(0.8, 1.2, Bg), jnp.float32)[:, None]
    cfg_d = SolverConfig(differentiable=True, **kw)

    def loss_g(g_cols):
        par = PhysicsParams(g=g_cols, m_bar=p.m_bar, alpha=p.alpha,
                            n_dof=p.n_dof)
        return jnp.sum((solve_rc_batched(
            T0_of(Bg), grid._consts._replace(F_toa=ftoa), par,
            grid._kappa_fn, cfg_d).flux / 1e13) ** 2)

    gp = jax.jit(jax.value_and_grad(loss_g))
    w_p, (_, gcols) = timed(gp, jnp.full(Bg, p.g, jnp.float32))
    finite_p = bool(np.all(np.isfinite(np.asarray(gcols))))
    print(f"value_and_grad (g/col) B={Bg}: {w_p:.4f} s  "
          f"grad_finite={finite_p}")
    assert finite_p, "non-finite per-column gravity gradients"


if __name__ == "__main__":
    main()
