"""Reverse-mode differentiable solves (``SolverConfig.differentiable``).

The reference cannot offer gradients at all (host-Python driver loop,
`/root/reference/frei/core.py:233-338`, per-layer C++ FastChem calls);
here the fixed-horizon rematerialized solver makes the whole
radiative-convective spectrum differentiable end-to-end, enabling
gradient-based retrieval.  Pinned here:

* the differentiable path is bit-identical to the production
  ``lax.while_loop`` solver, INCLUDING early per-column convergence
  freezing (the scan keeps running frozen);
* gradients w.r.t. gravity / mixing-length / initial temperatures /
  per-column irradiation match central finite differences in float64;
* removed engine names are rejected loudly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from frei_tpu import Grid, Planet, load_example_opacity
from frei_tpu.rt.physics import PhysicsParams
from frei_tpu.rt.solver import SolverConfig, solve_rc, solve_rc_batched

W, L, B = 16, 5, 3


@pytest.fixture(scope="module")
def setup():
    planet = Planet.from_hot_jupiter()
    grid = Grid(planet, n_wl_bins=W, n_layers=L, T_ref=2400.0,
                dtype=jnp.float64)
    grid.load_opacities(opacities=load_example_opacity(
        grid, scale_factor=1.0, dtype=jnp.float64))
    rng = np.random.RandomState(3)
    T0 = jnp.asarray(np.asarray(grid.init_temperatures)[None, :]
                     * rng.uniform(0.9, 1.1, (B, 1)))
    return planet, grid, T0


def _fixed_cfg(**kw):
    # convergence exits disabled: finite differences must not cross
    # the discrete stopping rule
    return SolverConfig(n_timesteps=3, n_zero_crossings=10 ** 6,
                        convergence_dT=0.0, engine="xla", **kw)


def test_differentiable_forward_bit_identical(setup):
    """Fixed-horizon scan == while_loop, WITH live convergence (a
    huge dT threshold converges columns at different iterations, so
    the frozen-body equivalence is actually exercised).  Checked for
    the auto remat chunk (2 at T=4, divides evenly), an explicit
    chunk with a REMAINDER leg (3 at T=4 -> one full chunk + rem 1),
    and chunk=1 (per-iteration checkpointing)."""
    planet, grid, T0 = setup
    args = (grid._consts, planet.physics_params(), grid._kappa_fn)
    cfg = dict(n_timesteps=4, convergence_dT=60.0)
    ref = solve_rc_batched(T0, *args, SolverConfig(engine="xla", **cfg))
    assert int(np.max(np.asarray(ref.n_iterations))) < 4, \
        "test needs early convergence to exercise the frozen body"
    for chunk in (0, 3, 1):
        dif = solve_rc_batched(
            T0, *args, SolverConfig(engine="xla", differentiable=True,
                                    remat_chunk=chunk, **cfg))
        for f in ref._fields:
            np.testing.assert_array_equal(
                np.asarray(getattr(ref, f)),
                np.asarray(getattr(dif, f)),
                err_msg=f"{f} (remat_chunk={chunk})")
    # a negative chunk would run a ZERO-length scan and return the
    # initial state as the solution — must refuse loudly
    with pytest.raises(ValueError, match="remat_chunk"):
        solve_rc_batched(
            T0, *args, SolverConfig(engine="xla", differentiable=True,
                                    remat_chunk=-1, **cfg))


@pytest.mark.slow   # two more solver compiles; the batched test above
                    # already pins the frozen-body equivalence
def test_differentiable_forward_bit_identical_single_column(setup):
    planet, grid, T0 = setup
    args = (grid._consts, planet.physics_params(), grid._kappa_fn)
    cfg = dict(n_timesteps=4, convergence_dT=60.0)
    r1 = solve_rc(T0[0], *args, SolverConfig(**cfg))
    d1 = solve_rc(T0[0], *args,
                  SolverConfig(differentiable=True, **cfg))
    for f in ("flux", "final_temps", "n_iterations", "temp_history"):
        np.testing.assert_array_equal(
            np.asarray(getattr(r1, f)), np.asarray(getattr(d1, f)),
            err_msg=f)


@pytest.mark.slow   # grad-of-remat-scan compiles + 6 FD solves
def test_grad_matches_finite_differences(setup):
    """d(loss)/d(g), d/d(alpha), d/d(T0) against central differences."""
    planet, grid, T0 = setup
    consts = grid._consts
    p0 = planet.physics_params()
    cfg = _fixed_cfg(differentiable=True)
    w = jnp.linspace(0.5, 1.5, W)   # asymmetric weights: no accidental
                                    # cancellation across bins

    def loss(g, alpha, T):
        par = PhysicsParams(g=g, m_bar=p0.m_bar, alpha=alpha,
                            n_dof=p0.n_dof)
        res = solve_rc_batched(T, consts, par, grid._kappa_fn, cfg)
        return jnp.sum(res.flux * w) / 1e12

    g0, a0 = jnp.float64(p0.g), jnp.float64(p0.alpha)
    got = jax.grad(loss, argnums=(0, 1, 2))(g0, a0, T0)

    def fd(f, x, h):
        return (f(x + h) - f(x - h)) / (2.0 * h)

    hg = float(g0) * 1e-6
    np.testing.assert_allclose(
        float(got[0]), float(fd(lambda g: loss(g, a0, T0), g0, hg)),
        rtol=1e-5)
    np.testing.assert_allclose(
        float(got[1]), float(fd(lambda a: loss(g0, a, T0), a0, 1e-6)),
        rtol=1e-5)
    # T0 gradient: one entry by FD, full array finite
    e = jnp.zeros_like(T0).at[1, 2].set(1.0)
    np.testing.assert_allclose(
        float(got[2][1, 2]),
        float(fd(lambda t: loss(g0, a0, T0 + t * e), jnp.float64(0.0),
                 1e-3)),
        rtol=1e-5)
    assert np.all(np.isfinite(np.asarray(got[2])))


@pytest.mark.slow   # grad compile + per-column FD cross-check
def test_grid_spectrum_fn_grad_per_column_irradiation(setup):
    """Grid.spectrum_fn: gradients reach a per-column F_toa (the
    retrieval knob for T_star / a_rstar) and per-column params."""
    planet, grid, T0 = setup
    fn = grid.spectrum_fn(n_timesteps=2, n_zero_crossings=10 ** 6,
                          convergence_dT=0.0)
    p0 = planet.physics_params()
    ftoa = jnp.broadcast_to(grid._consts.F_toa, (B, W)) * jnp.asarray(
        [0.8, 1.0, 1.2])[:, None]
    par = PhysicsParams(g=jnp.full(B, p0.g), m_bar=p0.m_bar,
                        alpha=p0.alpha, n_dof=p0.n_dof)

    def loss(ft, g_cols):
        p = PhysicsParams(g=g_cols, m_bar=p0.m_bar, alpha=p0.alpha,
                          n_dof=p0.n_dof)
        return jnp.sum(fn(T0, p, F_toa=ft) ** 2) / 1e26

    gf, gg = jax.grad(loss, argnums=(0, 1))(ftoa, par.g)
    assert gf.shape == (B, W) and np.all(np.isfinite(np.asarray(gf)))
    assert gg.shape == (B,) and np.all(np.isfinite(np.asarray(gg)))
    # column independence: column c's flux must not feel column d's g
    h = float(p0.g) * 1e-6
    dg = (loss(ftoa, par.g.at[0].add(h))
          - loss(ftoa, par.g.at[0].add(-h))) / (2 * h)
    np.testing.assert_allclose(float(gg[0]), float(dg), rtol=1e-5)


@pytest.mark.slow   # two differentiable-scan compiles (~23 s)
def test_differentiable_ensemble_bins_sharded(setup):
    """``solve_ensemble`` with ``differentiable=True`` on a bins-sharded
    mesh runs under GSPMD, which psums the bolometric quadrature across
    bins shards: it must equal the unsharded solve (a missing psum is
    silently wrong physics, flux off ~1e-2)."""
    planet, grid, T0 = setup
    from frei_tpu.parallel import make_mesh, solve_ensemble
    kw = dict(n_timesteps=2, n_zero_crossings=10 ** 6,
              convergence_dT=0.0, differentiable=True)
    res = solve_ensemble(
        T0, grid._consts, planet.physics_params(), grid.opacities,
        grid.chemistry, SolverConfig(engine="auto", **kw),
        mesh=make_mesh(1, 4, devices=jax.devices()[:4]))
    ref = solve_rc_batched(T0, grid._consts, planet.physics_params(),
                           grid._kappa_fn,
                           SolverConfig(engine="xla", **kw))
    np.testing.assert_allclose(np.asarray(res.flux),
                               np.asarray(ref.flux), rtol=1e-9)
    np.testing.assert_allclose(np.asarray(res.final_temps),
                               np.asarray(ref.final_temps), rtol=1e-9)


def test_differentiable_rejects_pallas_engines(setup):
    """The Pallas engine names were removed: a differentiable solve
    that names one raises instead of running something else."""
    planet, grid, T0 = setup
    for engine in ["pallas", "pallas-interpret", "pallas-loop"]:
        with pytest.raises(ValueError, match="removed"):
            solve_rc_batched(
                T0, grid._consts, planet.physics_params(),
                grid._kappa_fn,
                SolverConfig(engine=engine, differentiable=True,
                             n_timesteps=1))


def test_radiative_timestep_grad_finite_at_zero_divergence(setup):
    """Round-5 float32 regression: at ``div == 0`` the untaken branch
    of the timestep prefactor evaluates ``1e5 / 0**0.9 = inf``, whose
    reverse-mode cotangent is NaN through ``jnp.where`` (inf * 0) —
    unreachable in float64 test shapes, but a near-converged float32
    layer lands on exactly zero and poisoned every retrieval gradient
    upstream.  Pinned at the exact trap input."""
    from frei_tpu.rt import physics

    planet, *_ = setup
    p = planet.physics_params()

    def f(div):
        return jnp.sum(physics.radiative_timestep(
            jnp.float64(1800.0), jnp.float64(1750.0),
            jnp.float64(2.0e6), jnp.float64(1.0e6),
            div, jnp.float64(1.0e7), p))

    for v in (0.0, 1e-3):
        g = jax.grad(f)(jnp.float64(v))
        assert np.isfinite(float(g)), (v, float(g))
    # float32 too (the dtype that actually hit it)
    g32 = jax.grad(lambda d: jnp.sum(physics.radiative_timestep(
        jnp.float32(1800.0), jnp.float32(1750.0), jnp.float32(2.0e6),
        jnp.float32(1.0e6), d, jnp.float32(1.0e7), p).astype(jnp.float32)))(
        jnp.float32(0.0))
    assert np.isfinite(float(g32))


def test_physics_g_gradients_finite_at_float32(setup):
    """Round-5 float32 regression #2: ``delta_z`` / ``mixing_length``
    formed the ~1e-20 CGS product ``m_bar * g``, whose reverse-mode
    quotient rule squares it to ~1e-40 — the reciprocal overflows
    float32 and EVERY gradient w.r.t. gravity came back inf at
    production dtype (fine at float64, where all the other grad tests
    live).  Pinned at the function level in float32."""
    from frei_tpu.rt import physics

    planet, grid, _ = setup
    p0 = planet.physics_params()
    press = jnp.asarray(np.asarray(grid._consts.pressures), jnp.float32)
    T1 = jnp.full(press.shape[0] - 1, 1800.0, jnp.float32)
    p1, p2 = press[:-1], press[1:]

    def par(g):
        return PhysicsParams(g=g, m_bar=jnp.float32(p0.m_bar),
                             alpha=jnp.float32(p0.alpha),
                             n_dof=p0.n_dof)

    for name, fn in [
        ("delta_z", lambda g: jnp.sum(
            physics.delta_z(T1, p1, p2, par(g)))),
        ("mixing_length", lambda g: jnp.sum(
            physics.mixing_length(T1, par(g)))),
        ("rho_p", lambda g: jnp.sum(
            physics.rho_p(T1, p1, p2, par(g)))),
        ("convective_flux", lambda g: jnp.sum(
            physics.convective_flux(
                T1, T1 * jnp.float32(0.9), p1, p2, par(g)))),
    ]:
        grad = jax.grad(fn)(jnp.float32(p0.g))
        assert np.isfinite(float(grad)), (name, float(grad))
