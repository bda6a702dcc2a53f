#!/usr/bin/env python
"""Side-by-side parity report: frei_tpu vs the reference pipeline.

Runs the hot-Jupiter golden configuration through frei_tpu (any
backend) and through the independent float64 numpy re-implementation
of the reference algorithm (tests/reference_impl.py, verified
line-by-line against /root/reference/frei), then prints relative
errors for the emergent spectrum, the temperature profile, and the
golden quantities, at several iteration horizons.

    PYTHONPATH=. python tools/compare_reference.py
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

repo = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(repo))
sys.path.insert(0, str(repo / "tests"))


def main():
    import jax
    # float64 parity is a CPU exercise: the reference is a float64
    # host computation
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from frei_tpu import (Grid, Planet, effective_temperature,
                          load_example_opacity)
    from frei_tpu.constants import u_amu
    from frei_tpu.opacity.rayleigh import rayleigh_total
    from frei_tpu.stellar.irradiation import f_toa_np
    from reference_impl import MiniFrei

    planet = Planet.from_hot_jupiter()
    grid = Grid(planet, T_ref=2400.0, dtype=jnp.float64)
    grid.load_opacities(opacities=load_example_opacity(
        grid, scale_factor=1.0, dtype=jnp.float64))
    stack = grid.opacities
    lam_cm = grid.rt_grid.lam_cm
    mini = MiniFrei(
        lam_cm=lam_cm, pressures_cgs=grid.rt_grid.pressures_cgs,
        k_table=np.asarray(stack.values)[0],
        temps_axis=np.asarray(stack.temps),
        press_axis_cgs=np.asarray(stack.press_cgs),
        mmr=1.5e-3 * 18.0 * u_amu / planet.m_bar,
        sigma_scat=rayleigh_total(lam_cm, planet.m_bar),
        F_toa=f_toa_np(lam_cm, planet.T_star, planet.a_rstar),
        g=planet.g, m_bar=planet.m_bar, alpha=planet.alpha)
    T0 = np.asarray(grid.rt_grid.init_temperatures)

    print(f"config: 500 bins x 30 layers, hot Jupiter, T_ref=2400 K, "
          f"float64 vs float64 oracle")
    print(f"{'iters':>6s} {'flux max rel':>14s} {'T max rel':>12s} "
          f"{'dtau max rel':>14s}")
    for n in (1, 5, 25, 100):
        want_flux, want_T, _, want_dtaus, *_ = mini.emission_spectrum(
            T0, n_timesteps=n)
        spec, temps, _, dtaus = grid.emission_spectrum(n_timesteps=n)
        fr = np.abs(spec.flux_cgs - want_flux) / (np.abs(want_flux) + 1e-300)
        tr = np.abs(temps - want_T) / np.abs(want_T)
        dr = np.abs(dtaus - want_dtaus) / (np.abs(want_dtaus) + 1e-300)
        print(f"{n:6d} {fr.max():14.2e} {tr.max():12.2e} "
              f"{dr.max():14.2e}")

    spec, temps, _, dtaus = grid.emission_spectrum(n_timesteps=1)
    i = int(np.argmax(spec.flux_cgs))
    teff = effective_temperature(grid, spec, dtaus, temps)
    print("\ngolden quantities (reference test_core.py:52-71):")
    print(f"  peak wavelength {spec.wavelength_um[i]:.4f} um "
          f"(golden 1.1518 +- 0.02)")
    print(f"  peak flux       {spec.flux_cgs[i]:.4e} erg/s/cm^3 "
          f"(golden 1.296e13 +- 0.1e13)")
    print(f"  T_eff           {teff:.1f} K (golden 2400 +- 200)")


if __name__ == "__main__":
    main()
