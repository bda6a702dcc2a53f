"""The hot-loop kappa model is wired in one place.

The hot-loop kappa/chemistry wiring used to exist in three hand-rolled
copies, and a copy that missed the layer-factored chemistry silently
fell back to the per-iteration 2-D table gather (the 1.93x
chemistry-in-loop regression class fixed in round 3).  The wiring now
lives in one builder (frei_tpu/opacity/hotpath.py); these tests pin
(a) that the factored model computes the same opacity as the generic
bilinear lookup, (b) that table-mode chemistry reaches it through the
factored evaluator and (c) that the entry points route through the
shared builder.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from frei_tpu import Grid, Planet, load_example_opacity
from frei_tpu.chemistry.fastchem import FastChemJAX
from frei_tpu.opacity import hotpath
from frei_tpu.opacity.tables import kappa_from_stack
from frei_tpu.parallel import make_mesh, solve_ensemble
from frei_tpu.rt.solver import SolverConfig


_SMALL_CHEM = {}


def _grid(chemistry=None):
    planet = Planet.from_hot_jupiter()
    grid = Grid(planet, n_wl_bins=24, n_layers=5, T_ref=2400.0,
                dtype=jnp.float64)
    stack = load_example_opacity(grid, scale_factor=1.0,
                                 dtype=jnp.float64)
    if chemistry == "equilibrium":
        # small table, built once per test module: the full default
        # (64, 32) build is a slow-lane cost and the wiring does not
        # depend on table resolution
        if "chem" not in _SMALL_CHEM:
            _SMALL_CHEM["chem"] = FastChemJAX(
                stack.species, planet.m_bar, mode="table",
                grid_shape=(4, 3))
        chemistry = _SMALL_CHEM["chem"]
    grid.load_opacities(opacities=stack, chemistry=chemistry)
    return planet, grid


@pytest.mark.parametrize("chemistry", [None, "equilibrium"])
def test_grid_kappa_model_matches_generic_lookup(chemistry):
    """The layer-factored model equals the generic bilinear lookup with
    the chemistry's own ``mmr`` (float32 rounding of the table-mode
    chemistry evaluator sets the tolerance)."""
    _, grid = _grid(chemistry)
    press = grid._consts.pressures
    T = jnp.asarray(np.asarray(grid.rt_grid.init_temperatures) * 0.97)
    got = grid._kappa_fn(T, press)
    want, _ = kappa_from_stack(grid.opacities,
                               grid.chemistry.mmr(T, press), T, press,
                               grid._consts.sigma_scat)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5)


def test_equilibrium_grid_uses_layer_factored_chemistry():
    """Table-mode FastChem must reach the hot loop through the
    gather-free layer-factored evaluator, not the generic mmr():
    chem.mmr is replaced with a bomb after the model is built."""
    _, grid = _grid("equilibrium")
    chem = grid.chemistry
    assert isinstance(chem, FastChemJAX) and chem.supports_layer_factoring()
    press = grid._consts.pressures
    kappa = hotpath.build_kappa_model(grid.opacities, chem, press,
                                      grid._consts.sigma_scat)

    def bomb(*a, **k):
        raise AssertionError("generic chem.mmr called in the hot loop")

    real_mmr = chem.mmr
    chem.mmr = bomb
    try:
        k = kappa(jnp.full(press.shape, 2100.0), press)
    finally:
        chem.mmr = real_mmr
    assert np.all(np.isfinite(np.asarray(k)))


def _recording_hotpath(monkeypatch):
    calls = []
    real_build = hotpath.build_kappa_model

    def rec_build(*a, **kw):
        calls.append("build")
        return real_build(*a, **kw)

    monkeypatch.setattr(hotpath, "build_kappa_model", rec_build)
    return calls


def test_grid_routes_through_shared_builder(monkeypatch):
    """api.Grid must construct its kappa model via opacity.hotpath —
    a hand-rolled copy would dodge this recorder and fail."""
    calls = _recording_hotpath(monkeypatch)
    _grid()
    assert "build" in calls


def test_ensemble_routes_through_shared_builder(monkeypatch):
    """parallel.solve_ensemble must route through opacity.hotpath too."""
    calls = _recording_hotpath(monkeypatch)
    planet, grid = _grid()
    calls.clear()

    base = np.asarray(grid.rt_grid.init_temperatures)
    T0 = jnp.asarray(np.stack([base, base * 1.02]))
    solve_ensemble(T0, grid._consts, planet.physics_params(),
                   grid.opacities, grid.chemistry,
                   SolverConfig(n_timesteps=1),
                   mesh=make_mesh(2, 1, devices=jax.devices()[:2]))
    assert "build" in calls


def test_single_T_point_stack_falls_back():
    """A stack with one temperature sample has nothing to factor: the
    builder must return the generic path."""

    _, grid = _grid()
    stack = grid.opacities
    one_t = stack._replace(values=stack.values[:, :1],
                           temps=stack.temps[:1])
    press = grid._consts.pressures
    k = hotpath.build_kappa_model(one_t, grid.chemistry, press,
                                  grid._consts.sigma_scat)
    T = jnp.full(press.shape, 2000.0)
    want, _ = kappa_from_stack(one_t, grid.chemistry.mmr(T, press), T,
                               press, grid._consts.sigma_scat)
    np.testing.assert_array_equal(np.asarray(k(T, press)),
                                  np.asarray(want))
