"""frei_tpu: accelerator-native radiative transfer for exoplanet inference.

A from-scratch JAX/XLA framework with the capabilities of the
reference package ``bmorris3/frei`` (two-stream emission spectra of
exoplanet atmospheres iterated to radiative-convective equilibrium),
redesigned for batched accelerators: unitless CGS arrays on device, layer sweeps as
associative scans under jit, hoisted batched chemistry/opacity lookups,
and column/spectral-bin sharding over device meshes.

Quickstart (mirrors the reference five-liner, `docs/index.rst:10-41`)::

    from frei_tpu import Planet, Grid, load_example_opacity

    planet = Planet.from_hot_jupiter()
    grid = Grid(planet, n_wl_bins=300, n_layers=15, T_ref=2400.0)
    grid.load_opacities(opacities=load_example_opacity(grid))
    spec, temps, temp_hist, dtaus = grid.emission_spectrum(n_timesteps=1)
"""

from .api import (Grid, Planet, Spectrum, effective_temperature,
                  effective_temperature_milne, effective_temperature_planck)
from .grids import (RTGrid, make_rt_grid, pressure_grid, temperature_grid,
                    wavelength_grid)
from .opacity.tables import (OpacityStack, kappa_from_stack,
                             load_example_opacity, make_opacity_stack)
from .rt.physics import PhysicsParams
from .rt.solver import RTConstants, RTResult, SolverConfig, solve_rc
from .rt.standalone import StandaloneResult, absorb, emit
from .rt.sweeps import absorb_sweep, emit_sweep
from .stellar.irradiation import b_star, f_toa

__all__ = [
    "Planet", "Grid", "Spectrum",
    "effective_temperature", "effective_temperature_milne",
    "effective_temperature_planck",
    "wavelength_grid", "pressure_grid", "temperature_grid",
    "RTGrid", "make_rt_grid",
    "OpacityStack", "make_opacity_stack", "load_example_opacity",
    "kappa_from_stack",
    "PhysicsParams", "SolverConfig", "RTConstants", "RTResult",
    "solve_rc", "emit_sweep", "absorb_sweep",
    "emit", "absorb", "StandaloneResult",
    "f_toa", "b_star",
]

__version__ = "0.1.0"
