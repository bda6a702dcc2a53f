import jax.numpy as jnp
import numpy as np

from frei_tpu.api import Grid, Planet
from frei_tpu.chemistry.mocks import MOCK_VMR, MockChemistry
from frei_tpu.constants import m_p, u_amu
from frei_tpu.grids import make_rt_grid
from frei_tpu.opacity.rayleigh import rayleigh_total
from frei_tpu.opacity.tables import (interp_tp, kappa_from_stack,
                                     load_example_opacity,
                                     make_opacity_stack)


def small_grid():
    return make_rt_grid(n_wl_bins=50, n_layers=8, T_ref=2400.0)


def test_example_opacity_deterministic():
    g = small_grid()
    a = load_example_opacity(g, dtype=jnp.float64)
    b = load_example_opacity(g, dtype=jnp.float64)
    assert a.species == ("1H2-16O",)
    np.testing.assert_array_equal(np.asarray(a.values), np.asarray(b.values))
    # constant over (T, P)
    v = np.asarray(a.values)
    assert np.all(v == v[:, :1, :1, :])
    # scale_factor linearity
    c = load_example_opacity(g, scale_factor=1.0, dtype=jnp.float64)
    np.testing.assert_allclose(np.asarray(a.values),
                               20.0 * np.asarray(c.values), rtol=1e-12)


def test_stack_axes_canonicalized():
    g = small_grid()
    st = load_example_opacity(g, dtype=jnp.float64)
    assert np.all(np.diff(np.asarray(st.temps)) > 0)
    assert np.all(np.diff(np.asarray(st.press_cgs)) > 0)
    assert st.masses_g[0] == 18.0 * u_amu


def test_interp_fill_zero_outside():
    g = small_grid()
    st = load_example_opacity(g, dtype=jnp.float64)
    tmin, tmax = float(st.temps[0]), float(st.temps[-1])
    pmid = float(st.press_cgs[2])
    inside = interp_tp(st, jnp.asarray([0.5 * (tmin + tmax)]),
                       jnp.asarray([pmid]))
    below = interp_tp(st, jnp.asarray([tmin - 1.0]), jnp.asarray([pmid]))
    above = interp_tp(st, jnp.asarray([tmax + 1.0]), jnp.asarray([pmid]))
    assert np.all(np.asarray(inside) > 0)
    assert np.all(np.asarray(below) == 0)
    assert np.all(np.asarray(above) == 0)
    # exactly at the boundary is inside
    at_edge = interp_tp(st, jnp.asarray([tmax]), jnp.asarray([pmid]))
    assert np.all(np.asarray(at_edge) > 0)


def test_interp_linear_between_grid_points():
    vals = np.arange(2 * 3 * 4, dtype=np.float64).reshape(1, 2, 3, 4)
    st = make_opacity_stack(
        {"K": (vals[0], np.array([1000.0, 2000.0]),
               np.array([0.1, 1.0, 10.0]))}, dtype=jnp.float64)
    got = interp_tp(st, jnp.asarray(1500.0), jnp.asarray(0.55e6))
    v = vals[0]
    expect = 0.25 * (v[0, 0] + v[0, 1] + v[1, 0] + v[1, 1])
    np.testing.assert_allclose(np.asarray(got)[0], expect, rtol=1e-12)


def test_single_pressure_stack_axis_constant():
    """A 1-point pressure axis must behave as axis-constant (round-4
    review: ``_axis_weights`` divided by x1 - x0 == 0, NaN even at the
    tabulated pressure).  Same convention as the 1-point-T axis skip
    and the ETL's single-P mirroring."""
    vals = np.arange(2 * 1 * 4, dtype=np.float64).reshape(1, 2, 1, 4)
    st = make_opacity_stack(
        {"K": (vals[0], np.array([1000.0, 2000.0]), np.array([1.0]))},
        dtype=jnp.float64)
    # at, off, and far from the tabulated pressure: finite, P-constant
    got = interp_tp(st, jnp.asarray([1500.0] * 3),
                    jnp.asarray([1.0e6, 0.2e6, 50.0e6]))
    g = np.asarray(got)
    assert np.all(np.isfinite(g))
    expect = 0.5 * (vals[0, 0, 0] + vals[0, 1, 0])
    for col in range(3):
        np.testing.assert_allclose(g[0, col], expect, rtol=1e-12)
    # T hull still applies
    out = interp_tp(st, jnp.asarray([100.0]), jnp.asarray([1.0e6]))
    assert np.all(np.asarray(out) == 0)
    # degenerate BOTH axes: the single tabulated spectrum, everywhere
    st1 = make_opacity_stack(
        {"K": (vals[0][:1], np.array([1000.0]), np.array([1.0]))},
        dtype=jnp.float64)
    got1 = interp_tp(st1, jnp.asarray([777.0]), jnp.asarray([3.3e6]))
    np.testing.assert_allclose(np.asarray(got1)[0, 0], vals[0, 0, 0],
                               rtol=1e-12)


def test_rayleigh_decreasing_and_positive():
    g = small_grid()
    sig = rayleigh_total(g.lam_cm, 2.4 * m_p)
    assert np.all(sig > 0)
    assert sig[0] > sig[-1]  # lambda^-4 falloff


def test_kappa_matches_reference_structure():
    """kappa = sum_s mmr_s * op_s + sigma, and k > sigma everywhere for
    the synthetic fixture (reference `test_core.py:42-44`)."""
    planet = Planet.from_hot_jupiter()
    grid = Grid(planet, n_wl_bins=50, n_layers=8, T_ref=2400.0,
                dtype=jnp.float64)
    st = load_example_opacity(grid, scale_factor=1.0, dtype=jnp.float64)
    grid.load_opacities(opacities=st)

    sigma = rayleigh_total(grid.rt_grid.lam_cm, planet.m_bar)
    chem = MockChemistry(st.masses_g, planet.m_bar)
    T = jnp.asarray(grid.init_temperatures[:1])
    P = jnp.asarray(grid.rt_grid.pressures_cgs[:1])
    mmr = chem.mmr(T, P)
    np.testing.assert_allclose(
        np.asarray(mmr)[0, 0], MOCK_VMR * 18.0 * u_amu / (2.4 * m_p),
        rtol=1e-12)
    k, sig = kappa_from_stack(st, mmr, T, P, jnp.asarray(sigma))
    k = np.asarray(k)[0]
    assert np.all(k > np.asarray(sig))
    # manual recomputation
    expect = (np.asarray(mmr)[0, 0] * np.asarray(st.values)[0, 0, 0]
              + np.asarray(sigma))
    np.testing.assert_allclose(k, expect, rtol=1e-12)


def test_interp_onehot_matches_gather():
    """The one-hot interpolation engine equals the gather engine
    to float32 roundoff, including out-of-range zero fill and vmap
    batching (the solver's call pattern)."""
    import jax

    from frei_tpu.opacity import tables as T

    rng = np.random.RandomState(3)
    nT, nP, W, S = 7, 5, 33, 2
    tgrid = np.sort(rng.uniform(500, 3000, nT))
    pgrid = np.sort(rng.uniform(1e-3, 1e2, nP))
    tabs = {
        name: (rng.rand(nT, nP, W), tgrid, pgrid)
        for name in ("1H2-16O", "48Ti-16O")
    }
    stack = make_opacity_stack(tabs, dtype=jnp.float32)
    # include points outside the hull on both axes
    temps = jnp.asarray(rng.uniform(300, 3500, (4, 6)), jnp.float32)
    press = jnp.asarray(
        rng.uniform(5e2, 2e8, (4, 6)), jnp.float32)  # barye
    try:
        T.set_interp_mode("gather")
        a = jax.vmap(lambda t, p: interp_tp(stack, t, p))(temps, press)
        T.set_interp_mode("onehot")
        b = jax.vmap(lambda t, p: interp_tp(stack, t, p))(temps, press)
    finally:
        T.set_interp_mode(None)
    assert a.shape == b.shape == (4, S, 6, W)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                               rtol=2e-6, atol=1e-7)
    # zero fill preserved outside the hull
    out = np.asarray(temps) > tgrid.max()
    assert np.all(np.asarray(b)[np.broadcast_to(
        out[:, None, :], (4, S, 6))] == 0.0)
