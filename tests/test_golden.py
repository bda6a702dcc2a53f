"""End-to-end golden integration tests.

These reproduce the reference's de-facto correctness baseline
(`/root/reference/frei/tests/test_core.py:19-71`): build a hot-Jupiter
grid with T_ref = 2400 K, inject the deterministic synthetic opacity
fixture at scale_factor = 1, run a 1-timestep emission spectrum
(emit + absorb + final emit), and check the published golden numbers:

* wavelength at peak flux = 1.1518 um +- 0.02 um
* peak flux              = 1.296e13 +- 0.1e13 erg / s / cm^3
* effective temperature  ~ T_ref within 200 K

Run in float64 (full parity with the reference's numpy pipeline) and in
float32 (the device compute dtype) to demonstrate the goldens survive
reduced precision.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from frei_tpu import (Grid, Planet, effective_temperature,
                      load_example_opacity)


@pytest.fixture(scope="module", params=["float64", "float32"])
def golden_run(request):
    dtype = jnp.float64 if request.param == "float64" else jnp.float32
    planet = Planet.from_hot_jupiter()
    grid = Grid(planet, T_ref=2400.0, dtype=dtype)
    grid.load_opacities(
        opacities=load_example_opacity(grid, scale_factor=1.0, dtype=dtype)
    )
    spec, temps, temp_hist, dtaus = grid.emission_spectrum(n_timesteps=1)
    return grid, spec, temps, temp_hist, dtaus


def test_grid_init():
    planet = Planet.from_hot_jupiter()
    grid = Grid(planet=planet)
    for attr in ["lam", "init_temperatures", "pressures"]:
        assert hasattr(grid, attr)
    assert grid.lam.shape == (500,)
    assert grid.pressures.shape == (30,)


def test_spectrum_attributes(golden_run):
    _, spec, *_ = golden_run
    for attr in ["wavelength", "flux"]:
        assert hasattr(spec, attr)


def test_golden_peak_wavelength(golden_run):
    _, spec, *_ = golden_run
    lam_peak = spec.wavelength_um[np.argmax(spec.flux_cgs)]
    assert abs(lam_peak - 1.1518) < 0.02, lam_peak


def test_golden_peak_flux(golden_run):
    _, spec, *_ = golden_run
    peak = float(np.max(spec.flux_cgs))
    assert abs(peak - 1.296e13) < 0.1e13, peak


def test_golden_effective_temperature(golden_run):
    grid, spec, temps, _, dtaus = golden_run
    T_eff = effective_temperature(grid, spec, dtaus, temps)
    assert abs(T_eff - 2400.0) < 200.0, T_eff


def test_reference_source_scale_factor_five():
    """Both fixture calibrations stay reachable: scale_factor=5 on the
    frei_tpu fixture reproduces the reference SOURCE's behavior (its
    hard-coded x5 prefactor, `/root/reference/frei/opacity.py:326`, at
    its golden test's scale_factor=1) — measured end-to-end values
    pinned here; the published goldens above use the without-x5
    calibration.  Adjudication: docs/fixture-calibration.md,
    tools/fixture_calibration.py."""
    grid = Grid(Planet.from_hot_jupiter(), T_ref=2400.0,
                dtype=jnp.float64)
    grid.load_opacities(opacities=load_example_opacity(
        grid, scale_factor=5.0, dtype=jnp.float64))
    spec, temps, _, dtaus = grid.emission_spectrum(n_timesteps=1)
    lam_peak = spec.wavelength_um[np.argmax(spec.flux_cgs)]
    assert abs(lam_peak - 1.6414) < 0.02, lam_peak      # not 1.1518
    peak = float(np.max(spec.flux_cgs))
    assert abs(peak - 6.740e12) < 0.1e12, peak          # not 1.296e13
    T_eff = effective_temperature(grid, spec, dtaus, temps)
    assert abs(T_eff - 2189.0) < 20.0, T_eff            # not ~2400


def test_history_shape(golden_run):
    _, _, _, temp_hist, _ = golden_run
    # one outer iteration records [post-emit, post-absorb] columns
    assert temp_hist.shape == (30, 2)
