"""Sharded ensemble solves on a virtual 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from frei_tpu import Grid, Planet, load_example_opacity
from frei_tpu.parallel import make_mesh, solve_ensemble
from frei_tpu.rt.solver import SolverConfig


@pytest.fixture(scope="module")
def setup():
    planet = Planet.from_hot_jupiter()
    grid = Grid(planet, n_wl_bins=64, n_layers=10, T_ref=2400.0,
                dtype=jnp.float64)
    grid.load_opacities(
        opacities=load_example_opacity(grid, scale_factor=1.0,
                                       dtype=jnp.float64))
    return planet, grid


def _ensemble_inputs(grid, n_cols):
    rng = np.random.RandomState(11)
    base = np.asarray(grid.rt_grid.init_temperatures)
    return base[None, :] * rng.uniform(0.9, 1.1, (n_cols, 1))


def test_mesh_shapes():
    assert len(jax.devices()) == 8
    m = make_mesh()
    assert m.shape == {"columns": 8, "bins": 1}
    m2 = make_mesh(n_columns=4, n_bins=2)
    assert m2.shape == {"columns": 4, "bins": 2}
    with pytest.raises(ValueError):
        make_mesh(n_columns=3, n_bins=2)


@pytest.mark.parametrize(
    "mesh_shape",
    [(8, 1), (4, 2),
     # a second bins-sharded factorization adds a full ensemble
     # recompile for the same code path — slow lane (the driver's
     # dryrun sweep also covers 2x4)
     pytest.param((2, 4), marks=pytest.mark.slow)])
def test_ensemble_matches_per_column(setup, mesh_shape):
    """Sharded batch solve == independent single-column solves, for
    every mesh factorization (columns-only and bins-sharded)."""
    planet, grid = setup
    T0 = _ensemble_inputs(grid, 16)
    cfg = SolverConfig(n_timesteps=3)
    mesh = make_mesh(*mesh_shape)
    res = solve_ensemble(jnp.asarray(T0), grid._consts,
                         planet.physics_params(), grid.opacities,
                         grid.chemistry, cfg, mesh=mesh)
    assert res.flux.shape == (16, 64)
    # single-column references through the unsharded path
    from frei_tpu.rt.solver import solve_rc
    for c in [0, 7, 15]:
        one = solve_rc(jnp.asarray(T0[c]), grid._consts,
                       planet.physics_params(), grid._kappa_fn, cfg)
        np.testing.assert_allclose(res.flux[c], one.flux, rtol=1e-10)
        np.testing.assert_allclose(res.final_temps[c], one.final_temps,
                                   rtol=1e-10)


def test_early_convergence_freezing(setup):
    """A column that converges early must be bitwise-stable while other
    columns keep iterating (per-column trajectory independence)."""
    planet, grid = setup
    base = np.asarray(grid.rt_grid.init_temperatures)
    # one ordinary column + one with a huge convergence margin via
    # many timesteps: compare against its single-column trajectory
    T0 = np.stack([base, base * 1.08])
    cfg = SolverConfig(n_timesteps=30)
    mesh = make_mesh(2, 1, devices=jax.devices()[:2])
    res = solve_ensemble(jnp.asarray(T0), grid._consts,
                         planet.physics_params(), grid.opacities,
                         grid.chemistry, cfg, mesh=mesh)
    from frei_tpu.rt.solver import solve_rc
    for c in range(2):
        one = solve_rc(jnp.asarray(T0[c]), grid._consts,
                       planet.physics_params(), grid._kappa_fn, cfg)
        np.testing.assert_allclose(res.final_temps[c], one.final_temps,
                                   rtol=1e-10)
        assert int(res.n_iterations[c]) == int(one.n_iterations)


def test_ensemble_solver_reuse(setup, monkeypatch):
    """Repeat calls with the SAME input objects must reuse the placed
    tables and compiled sharded solver instead of rebuilding per call
    (round-4 review: a retrieval loop paid the full shard placement +
    kappa build + XLA compile per likelihood evaluation)."""
    from frei_tpu.parallel import solve as psolve

    planet, grid = setup
    T0 = jnp.asarray(_ensemble_inputs(grid, 8))
    params = planet.physics_params()     # ONE object: identity key
    cfg = SolverConfig(n_timesteps=2)
    mesh = make_mesh(2, 1, devices=jax.devices()[:2])
    builds = []
    real = psolve._build_ensemble_solver

    def counting(*a):
        builds.append(1)
        return real(*a)

    monkeypatch.setattr(psolve, "_build_ensemble_solver", counting)
    args = (grid._consts, params, grid.opacities, grid.chemistry, cfg)
    r1 = psolve.solve_ensemble(T0, *args, mesh=mesh)
    r2 = psolve.solve_ensemble(T0, *args, mesh=mesh)
    assert len(builds) == 1              # second call: cache hit
    np.testing.assert_array_equal(np.asarray(r1.flux),
                                  np.asarray(r2.flux))
    # an equal-but-distinct cfg object still hits (hashable value
    # key); a differing cfg would miss via the same comparison
    r3 = psolve.solve_ensemble(T0, *args[:-1],
                               SolverConfig(n_timesteps=2), mesh=mesh)
    assert len(builds) == 1
    np.testing.assert_array_equal(np.asarray(r1.flux),
                                  np.asarray(r3.flux))
    assert not psolve._ReuseCache._match(
        (cfg,), (SolverConfig(n_timesteps=1),))
    # instrumentation: the three calls above were 1 miss + 2 hits on
    # the ensemble cache, and the stats surface is queryable
    stats = psolve.reuse_cache_stats()["solve_ensemble"]
    assert stats["hits"] >= 2 and stats["misses"] >= 1
    assert stats["entries"] >= 1


def test_reuse_cache_warns_on_repeat_miss(caplog):
    """The identity-key failure mode (rebuilding inputs per step ->
    recompile per likelihood evaluation) must be LOUD — but only for
    the true footgun: a rebuilt key with the SAME cfg/mesh AND the
    same array shapes.  Different problem sizes, and keys whose shape
    signature carries no information, stay silent (round-5 review:
    the first heuristic false-positived on both)."""
    import logging

    from frei_tpu.parallel.solve import _ReuseCache

    cache = _ReuseCache("unit-test")
    k1 = (np.zeros(3),)                      # distinct-but-equal-shape
    k2 = (np.zeros(3),)                      # rebuilt inputs: WARN
    k3 = (np.zeros(5),)                      # different problem: silent
    k4, k5 = (object(),), (object(),)        # shapeless: silent
    with caplog.at_level(logging.WARNING, logger="frei_tpu.parallel"):
        assert cache.get(k1) is None          # first build: silent
        assert not caplog.records
        cache.put(k1, "solver-1")
        assert cache.get(k1) == "solver-1"    # hit: silent
        assert not caplog.records
        assert cache.get(k3) is None          # new size: silent miss
        assert not caplog.records
        assert cache.get(k2) is None          # rebuild-per-step miss
    assert any("reuse-cache MISS" in r.message for r in caplog.records)
    assert any("docs/retrieval.md" in r.getMessage()
               for r in caplog.records)
    assert cache.stats() == {"hits": 1, "misses": 3, "entries": 1}
    # uninformative keys never warn (the heuristic cannot distinguish
    # rebuilt-equal from genuinely-different there)
    caplog.clear()
    shapeless = _ReuseCache("unit-test-2")
    with caplog.at_level(logging.WARNING, logger="frei_tpu.parallel"):
        shapeless.get(k4)
        shapeless.put(k4, "s")
        shapeless.get(k5)
    assert not caplog.records


def test_population_matches_individual_planets(setup):
    """Per-planet irradiation/gravity/alpha population solve equals
    independent single-planet solves (the retrieval/phase-curve
    grid workflow)."""
    from frei_tpu import Planet
    from frei_tpu.parallel import solve_population

    planet, grid = setup
    planets = [
        Planet(a_rstar=5.0, m_bar=2.4, g=24.79, T_star=5800.0, alpha=1.0),
        Planet(a_rstar=9.0, m_bar=2.4, g=10.0, T_star=4500.0, alpha=1.5),
    ]
    T0 = _ensemble_inputs(grid, 2)
    cfg = SolverConfig(n_timesteps=4)
    res = solve_population(jnp.asarray(T0), grid, planets, cfg)
    assert res.flux.shape == (2, 64)

    from frei_tpu import Grid, load_example_opacity

    # one independent-solve cross-check in the fast lane (the planet
    # most different from the shared default — per-planet F_toa, g and
    # alpha all diverge); the dryrun's population leg and the slow
    # lane cover every column
    for c, p in [(1, planets[1])]:
        g1 = Grid(p, n_wl_bins=64, n_layers=10, T_ref=2400.0,
                  dtype=jnp.float64)
        g1.load_opacities(opacities=load_example_opacity(
            g1, scale_factor=1.0, dtype=jnp.float64))
        from frei_tpu.rt.solver import solve_rc
        one = solve_rc(jnp.asarray(T0[c]), g1._consts,
                       p.physics_params(), g1._kappa_fn, cfg)
        np.testing.assert_allclose(res.flux[c], np.asarray(one.flux),
                                   rtol=1e-9)
        np.testing.assert_allclose(res.final_temps[c],
                                   np.asarray(one.final_temps),
                                   rtol=1e-9)


def _population(n=3):
    return [
        Planet(a_rstar=5.0, m_bar=2.4, g=24.79, T_star=5800.0, alpha=1.0),
        Planet(a_rstar=9.0, m_bar=2.4, g=10.0, T_star=4500.0, alpha=1.5),
        Planet(a_rstar=6.4, m_bar=2.4, g=50.0, T_star=6300.0, alpha=1.0),
        Planet(a_rstar=4.0, m_bar=2.4, g=15.0, T_star=5000.0, alpha=0.8),
        Planet(a_rstar=7.5, m_bar=2.4, g=35.0, T_star=6000.0, alpha=1.2),
        Planet(a_rstar=5.5, m_bar=2.4, g=20.0, T_star=5500.0, alpha=1.0),
        Planet(a_rstar=8.2, m_bar=2.4, g=12.0, T_star=4800.0, alpha=1.4),
        Planet(a_rstar=6.0, m_bar=2.4, g=28.0, T_star=5900.0, alpha=0.9),
    ][:n]


def _population_reference(grid_kw, planets, T0, cfg):
    """Independent single-planet solve_rc solutions (fresh grids so the
    per-planet F_toa lives in the constants, like a reference user
    would run them)."""
    from frei_tpu.rt.solver import solve_rc
    out = []
    for c, p in enumerate(planets):
        g1 = Grid(p, **grid_kw)
        g1.load_opacities(opacities=load_example_opacity(
            g1, scale_factor=1.0, dtype=jnp.float64))
        out.append(solve_rc(jnp.asarray(T0[c]), g1._consts,
                            p.physics_params(), g1._kappa_fn, cfg))
    return out


@pytest.mark.slow
def test_population_sharded_mesh(setup):
    """Population solve sharded over the 'columns' mesh axis equals
    independent per-planet solves; bins-sharded meshes are rejected."""
    from frei_tpu.parallel import solve_population

    planet, grid = setup
    planets = _population(8)
    T0 = _ensemble_inputs(grid, 8)
    cfg = SolverConfig(n_timesteps=3)
    mesh = make_mesh(8, 1)
    res = solve_population(jnp.asarray(T0), grid, planets, cfg,
                           mesh=mesh)
    grid_kw = dict(n_wl_bins=64, n_layers=10, T_ref=2400.0,
                   dtype=jnp.float64)
    ones = _population_reference(grid_kw, planets, T0, cfg)
    for c, one in enumerate(ones):
        np.testing.assert_allclose(res.flux[c], np.asarray(one.flux),
                                   rtol=1e-9)
        np.testing.assert_allclose(res.final_temps[c],
                                   np.asarray(one.final_temps),
                                   rtol=1e-9)
    with pytest.raises(ValueError, match="columns"):
        solve_population(jnp.asarray(T0), grid, planets, cfg,
                         mesh=make_mesh(4, 2))


def test_population_rejects_mixed_composition(setup):
    from frei_tpu import Planet
    from frei_tpu.parallel import solve_population

    planet, grid = setup
    planets = [Planet(5.0, 2.4, 24.79, 5800.0),
               Planet(5.0, 2.8, 24.79, 5800.0)]
    T0 = _ensemble_inputs(grid, 2)
    with pytest.raises(ValueError, match="m_bar"):
        solve_population(jnp.asarray(T0), grid, planets)


@pytest.mark.slow   # chem table build; fast-lane dispatch coverage
# lives in tests/test_hotpath.py
def test_ensemble_table_chemistry_uses_factored_path(setup):
    """solve_ensemble with table-mode equilibrium chemistry must (a)
    match independent single-column solves and (b) actually route
    through the layer-factored evaluator — chem.mmr is replaced with a
    bomb, so any per-iteration 2-D table gather in the ensemble plane
    would explode (the hot-loop dispatch regression found in round-3
    review: api.Grid was factored but solve_ensemble still gathered)."""
    from frei_tpu.chemistry.fastchem import FastChemJAX
    from frei_tpu.rt.solver import solve_rc

    planet, grid = setup
    chem = FastChemJAX(grid.opacities.species, planet.m_bar,
                       mode="table", grid_shape=(12, 8))
    T0 = _ensemble_inputs(grid, 8)
    cfg = SolverConfig(n_timesteps=2)

    # reference: grid-path per-column solves with the same chemistry
    from frei_tpu.opacity.tables import (kappa_from_layer_tables,
                                         make_layer_tables)
    lt = make_layer_tables(grid.opacities, grid._consts.pressures)
    mmr_fn = chem.layer_mmr_interp(grid._consts.pressures)

    def kappa_all(temps, pressures):
        del pressures
        k, _ = kappa_from_layer_tables(lt, mmr_fn(temps), temps,
                                       grid._consts.sigma_scat)
        return k

    refs = [solve_rc(jnp.asarray(T0[c]), grid._consts,
                     planet.physics_params(), kappa_all, cfg)
            for c in (0, 5)]

    def bomb(*a, **k):
        raise AssertionError("generic chem.mmr called in the ensemble "
                             "hot loop — layer factoring not used")
    chem.mmr = bomb

    res = solve_ensemble(jnp.asarray(T0), grid._consts,
                         planet.physics_params(), grid.opacities,
                         chem, cfg, mesh=make_mesh(8, 1))
    for c, one in zip((0, 5), refs):
        np.testing.assert_allclose(res.flux[c], one.flux, rtol=1e-6)
        np.testing.assert_allclose(res.final_temps[c], one.final_temps,
                                   rtol=1e-6)
