"""The batched solver on the XLA sweep engine: parity with per-column
solves, engine policy, and the float32 precision pins.

``solve_rc_batched`` runs one engine, the vmapped XLA sweeps, on every
backend; these tests pin that it equals ``vmap(solve_rc)``, that every
removed engine name raises instead of running something else, and that
every matrix product of the solve states its precision (a float32 dot
left at the default precision may run in TF32 on a GPU).
"""

import subprocess
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax

from frei_tpu import Grid, Planet, load_example_opacity
from frei_tpu.opacity.tables import (kappa_from_layer_tables,
                                     kappa_from_stack, make_layer_tables)
from frei_tpu.rt.physics import PhysicsParams
from frei_tpu.rt.solver import (SolverConfig, _check_engine, solve_rc,
                                solve_rc_batched)
from frei_tpu.rt.sweeps import bolometric_flux

B, L, W = 3, 7, 24
REMOVED_ENGINES = ["pallas", "pallas-interpret", "pallas-iteration",
                   "pallas-loop-interpret"]


@pytest.fixture(scope="module")
def setup():
    planet = Planet.from_hot_jupiter()
    grid = Grid(planet, n_wl_bins=W, n_layers=L, T_ref=2400.0,
                dtype=jnp.float64)
    grid.load_opacities(opacities=load_example_opacity(
        grid, scale_factor=1.0, dtype=jnp.float64))
    rng = np.random.RandomState(0)
    T = jnp.asarray(np.asarray(grid.init_temperatures)[None, :]
                    * rng.uniform(0.9, 1.1, (B, 1)))
    return planet, grid, T


def _small_grid(n_wl_bins=16, n_layers=5, dtype=jnp.float64):
    planet = Planet.from_hot_jupiter()
    grid = Grid(planet, n_wl_bins=n_wl_bins, n_layers=n_layers,
                T_ref=2400.0, dtype=dtype)
    grid.load_opacities(opacities=load_example_opacity(
        grid, scale_factor=1.0, dtype=dtype))
    return planet, grid


def _dot_precisions(closed_jaxpr):
    """The ``precision`` of every dot_general in a jaxpr, nested
    sub-jaxprs (jit, while, scan, cond, checkpoint) included."""
    found = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                found.append(eqn.params["precision"])
            for v in eqn.params.values():
                for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                    if hasattr(sub, "eqns"):
                        walk(sub)
                    elif hasattr(getattr(sub, "jaxpr", None), "eqns"):
                        walk(sub.jaxpr)
    walk(closed_jaxpr.jaxpr)
    return found


def _not_highest(precisions):
    highest = (lax.Precision.HIGHEST, lax.Precision.HIGHEST)
    return [p for p in precisions if p != highest]


def test_batched_solver_xla_engine_equals_vmap(setup):
    planet, grid, T = setup
    consts = grid._consts
    cfg = SolverConfig(n_timesteps=6)
    ref = jax.vmap(partial(solve_rc, consts=consts,
                           params=planet.physics_params(),
                           kappa_all=grid._kappa_fn, cfg=cfg))(T)
    bat = solve_rc_batched(T, consts, planet.physics_params(),
                           grid._kappa_fn,
                           SolverConfig(n_timesteps=6, engine="xla"))
    for f in ["flux", "final_temps", "temp_history", "dtaus", "F_up",
              "F_down", "max_dT_history"]:
        np.testing.assert_allclose(
            np.asarray(getattr(ref, f)), np.asarray(getattr(bat, f)),
            rtol=1e-12, err_msg=f)
    for f in ["n_iterations", "n_history", "converged"]:
        np.testing.assert_array_equal(np.asarray(getattr(ref, f)),
                                      np.asarray(getattr(bat, f)))


def test_size1_per_column_params_rejected_lengths():
    """Wrong per-column lengths must fail loudly (no solve happens —
    the normalization raises before tracing)."""
    planet, grid = _small_grid(n_wl_bins=8, n_layers=4)
    T = jnp.asarray(np.asarray(grid.init_temperatures)[None, :]
                    .repeat(2, 0))
    p0 = planet.physics_params()
    bad = PhysicsParams(g=jnp.full(3, p0.g), m_bar=p0.m_bar,
                        alpha=p0.alpha, n_dof=p0.n_dof)
    with pytest.raises(ValueError, match="per-column params.g"):
        solve_rc_batched(T, grid._consts, bad, grid._kappa_fn,
                         SolverConfig(n_timesteps=1))


def test_size1_per_column_params_engine_agnostic():
    """Size-1 per-column arrays (a (1,) g, a (1, W) F_toa) with B > 1
    columns broadcast to all columns: the per-column path equals the
    shared-scalar path."""
    planet, grid = _small_grid()
    rng = np.random.RandomState(0)
    T = jnp.asarray(np.asarray(grid.init_temperatures)[None, :]
                    * rng.uniform(0.9, 1.1, (3, 1)))
    consts = grid._consts
    p0 = planet.physics_params()
    par1 = PhysicsParams(g=jnp.asarray([p0.g]), m_bar=p0.m_bar,
                         alpha=jnp.asarray([p0.alpha]), n_dof=p0.n_dof)
    consts1 = consts._replace(F_toa=consts.F_toa[None, :])
    cfg = SolverConfig(n_timesteps=2)
    per_col = solve_rc_batched(T, consts1, par1, grid._kappa_fn, cfg)
    ref = solve_rc_batched(T, consts, p0, grid._kappa_fn, cfg)
    np.testing.assert_allclose(np.asarray(ref.flux),
                               np.asarray(per_col.flux), rtol=1e-12)


def test_layer_tables_match_bilinear(setup):
    """P-interp hoisting reproduces the 4-corner bilinear kappa,
    including out-of-hull zeros."""
    planet, grid, T = setup
    stack = grid.opacities
    consts = grid._consts
    chem = grid.chemistry
    lt = make_layer_tables(stack, consts.pressures)
    # push some temperatures outside the tabulated range
    T2 = T.at[:, 0].set(50.0).at[:, -1].set(99000.0)
    mmr = chem.mmr(T2, consts.pressures)
    a, _ = kappa_from_stack(stack, mmr, T2, consts.pressures,
                            consts.sigma_scat)
    b, _ = kappa_from_layer_tables(lt, mmr, T2, consts.sigma_scat)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-10)


def test_grid_emission_spectra_matches_per_column(setup):
    """The Grid-level batched API reproduces per-column solve_rc."""
    planet, grid, T = setup
    spec, temps, hist, dtaus = grid.emission_spectra(
        T, n_timesteps=4, engine="xla")
    assert spec.flux_cgs.shape == (B, W)
    assert temps.shape == (B, L)
    assert dtaus.shape == (B, L, W)
    cfg = SolverConfig(n_timesteps=4)
    for c in [0, B - 1]:
        one = solve_rc(T[c], grid._consts, planet.physics_params(),
                       grid._kappa_fn, cfg)
        # batched vs single-column compilations reduce the bolometric
        # quadrature in different orders -> ~1e-10 relative
        np.testing.assert_allclose(spec.flux_cgs[c], np.asarray(one.flux),
                                   rtol=1e-9)
        np.testing.assert_allclose(temps[c], np.asarray(one.final_temps),
                                   rtol=1e-9)
    assert grid.last_metrics.columns == B


@pytest.mark.slow
def test_multispecies_pipeline_batched_matches_per_column(tmp_path):
    """Full multi-species path: three synthetic stores -> resort-rebin
    -> stacked tables -> equilibrium chemistry -> batched solve (S > 1
    exercises the K = S*nT weight-row contraction) vs per-column
    solves."""
    from frei_tpu.opacity import binned_opacity_stack, make_synthetic_store

    for iso, seed in [("1H2-16O", 7), ("23Na", 8), ("48Ti-16O", 9)]:
        make_synthetic_store(tmp_path / f"{iso}__syn.ftop",
                             isotopologue=iso, n_hr=40_000, seed=seed)
    planet = Planet.from_hot_jupiter()
    grid = Grid(planet, n_wl_bins=40, n_layers=8, T_ref=2400.0,
                dtype=jnp.float64)
    stack = binned_opacity_stack(grid.rt_grid,
                                 path=str(tmp_path / "*.ftop"),
                                 cache=False, dtype=jnp.float64)
    assert stack.values.shape[0] == 3
    grid.load_opacities(opacities=stack, chemistry="equilibrium")

    rng = np.random.RandomState(2)
    T0 = jnp.asarray(np.asarray(grid.init_temperatures)[None, :]
                     * rng.uniform(0.95, 1.05, (4, 1)))
    cfg = SolverConfig(n_timesteps=3)
    rx = solve_rc_batched(T0, grid._consts, planet.physics_params(),
                          grid._kappa_fn, cfg)
    assert np.all(np.isfinite(np.asarray(rx.flux)))
    for c in (0, 3):
        one = solve_rc(T0[c], grid._consts, planet.physics_params(),
                       grid._kappa_fn, cfg)
        np.testing.assert_allclose(np.asarray(rx.flux)[c],
                                   np.asarray(one.flux), rtol=1e-9)


# -- engine policy ----------------------------------------------------------

@pytest.mark.parametrize("backend", ["gpu", "cpu"])
@pytest.mark.parametrize("engine", ["auto", "xla"])
def test_auto_engine_is_xla_on_every_backend(monkeypatch, backend, engine):
    """Engine choice does not depend on the backend: "auto" and "xla"
    are accepted and trace the same program as the plain XLA sweeps,
    whatever ``default_backend`` reads."""
    planet, grid = _small_grid()
    T = jnp.asarray(np.asarray(grid.init_temperatures)[None, :])

    def program(engine):
        return str(jax.make_jaxpr(lambda t: solve_rc_batched(
            t, grid._consts, planet.physics_params(), grid._kappa_fn,
            SolverConfig(n_timesteps=1, engine=engine)).flux)(T))

    reference = program("xla")
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert _check_engine(engine) is None
    assert program(engine) == reference


@pytest.mark.parametrize("engine", REMOVED_ENGINES)
def test_removed_engines_raise(setup, engine):
    """A removed Pallas engine name raises a ValueError that says so,
    from every entry point that takes an engine, instead of falling
    back to another engine."""
    from frei_tpu.parallel import make_mesh, solve_ensemble

    planet, grid, T = setup
    cfg = SolverConfig(n_timesteps=1, engine=engine)
    with pytest.raises(ValueError, match="removed"):
        solve_rc_batched(T, grid._consts, planet.physics_params(),
                         grid._kappa_fn, cfg)
    with pytest.raises(ValueError, match="removed"):
        grid.emission_spectra(T, n_timesteps=1, engine=engine)
    with pytest.raises(ValueError, match="removed"):
        solve_ensemble(T, grid._consts, planet.physics_params(),
                       grid.opacities, grid.chemistry, cfg,
                       mesh=make_mesh(1, 1, devices=jax.devices()[:1]))


def test_unknown_engine_raises(setup):
    planet, grid, T = setup
    with pytest.raises(ValueError, match="unknown sweep engine"):
        solve_rc_batched(T, grid._consts, planet.physics_params(),
                         grid._kappa_fn,
                         SolverConfig(n_timesteps=1, engine="cuda"))


# -- precision pins -----------------------------------------------------------

def test_bolometric_flux_pins_precision():
    flux = jnp.ones((4, 9), jnp.float32)
    w = jnp.ones((9,), jnp.float32)
    precisions = _dot_precisions(jax.make_jaxpr(bolometric_flux)(flux, w))
    assert precisions and not _not_highest(precisions), precisions


def test_batched_solve_dots_pin_precision():
    """Every matrix product of the float32 batched solve (kappa
    contraction, bolometric quadratures) states HIGHEST precision."""
    planet, grid = _small_grid(dtype=jnp.float32)
    T = jnp.asarray(np.asarray(grid.init_temperatures)[None, :]
                    .repeat(2, 0), jnp.float32)

    def solve(T):
        return solve_rc_batched(T, grid._consts, planet.physics_params(),
                                grid._kappa_fn,
                                SolverConfig(n_timesteps=1)).flux

    precisions = _dot_precisions(jax.make_jaxpr(solve)(T))
    assert len(precisions) >= 5, precisions
    assert not _not_highest(precisions), precisions


def test_fastchem_newton_dots_pin_precision():
    """The float32 Gauss-Seidel / Newton steps of the FastChem solver
    state HIGHEST precision on every matrix product."""
    from frei_tpu.chemistry.fastchem import (equilibrium_log_pressures,
                                             load_chem_table)

    table = load_chem_table()
    T = jnp.full((3,), 2000.0, jnp.float32)
    P = jnp.full((3,), 0.1, jnp.float32)
    jaxpr = jax.make_jaxpr(lambda t, p: equilibrium_log_pressures(
        table, t, p, n_sweeps=1)[0])(T, P)
    precisions = _dot_precisions(jaxpr)
    assert len(precisions) >= 4, precisions
    assert not _not_highest(precisions), precisions


def test_import_does_not_load_pallas():
    """Importing the package and its solver, ensemble and ETL modules
    pulls in no Pallas module (the Pallas kernels were removed, and the
    GPU runs the XLA path)."""
    code = ("import sys, frei_tpu, frei_tpu.parallel, frei_tpu.ops, "
            "frei_tpu.opacity.etl, frei_tpu.rt.solver; "
            "bad = [m for m in sys.modules "
            "if m.startswith('jax.experimental.pallas')]; "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
