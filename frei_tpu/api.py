"""User-facing API: Planet, Grid, Spectrum, effective temperature.

Mirrors the reference driver objects (`/root/reference/frei/core.py`)
with a units-at-the-boundary design: constructors accept plain floats
in documented units (or astropy Quantities when astropy is installed —
see ``frei_tpu.units``), convert once to canonical CGS, and everything
past this module is unitless jittable CGS arrays.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import constants as const
from . import units
from .chemistry.mocks import MockChemistry
from .grids import RTGrid, make_rt_grid
from .opacity.rayleigh import rayleigh_total
from .opacity.tables import OpacityStack, make_opacity_stack
from .rt.physics import PhysicsParams
from .rt.solver import RTConstants, RTResult, SolverConfig, solve_rc
from .stellar.irradiation import f_toa_np
from .stellar.phoenix import _trapezoid

__all__ = ["Planet", "Grid", "Spectrum", "effective_temperature",
           "effective_temperature_milne", "effective_temperature_planck"]


@dataclass
class Planet:
    """Planetary-system parameters (reference `core.py:65-106`).

    Parameters
    ----------
    a_rstar : float
        Semimajor axis over stellar radius.
    m_bar : float or Quantity
        Mean molecular weight; plain floats are in proton masses
        (``2.4`` means 2.4 m_p).
    g : float or Quantity
        Surface gravity; plain floats in m / s^2.
    T_star : float or Quantity
        Stellar effective temperature [K].
    alpha : float
        Scale heights per mixing length.
    """

    a_rstar: float
    m_bar: float
    g: float
    T_star: float
    alpha: float = 1.0

    def __post_init__(self):
        self.a_rstar = float(self.a_rstar)
        self.m_bar = units.to_gram(self.m_bar)       # [g]
        self.g = units.to_cgs_gravity(self.g)        # [cm / s^2]
        self.T_star = units.to_kelvin(self.T_star)   # [K]
        self.alpha = float(self.alpha)

    @classmethod
    def from_hot_jupiter(cls) -> "Planet":
        """Standard hot Jupiter: a/R* for 0.03 AU around a Sun,
        m_bar = 2.4 m_p, g = g_Jup, T* = 5800 K (`core.py:92-106`)."""
        return cls(
            a_rstar=0.03 * const.au / const.R_sun,
            m_bar=2.4,
            g=const.g_jup / 100.0,  # to_cgs_gravity expects m/s^2
            T_star=5800.0,
            alpha=1.0,
        )

    def physics_params(self, n_dof: int = 5) -> PhysicsParams:
        return PhysicsParams(g=self.g, m_bar=self.m_bar,
                             alpha=self.alpha, n_dof=n_dof)


@dataclass(frozen=True)
class Spectrum:
    """Emission spectrum, duck-typing ``specutils.Spectrum1D``
    (reference `core.py:335-336` returns a Spectrum1D).

    The raw fields (``wavelength_um``, ``flux_cgs``) are always bare
    numpy arrays in the documented canonical units; the
    ``spectral_axis`` / ``wavelength`` / ``flux`` properties attach
    astropy units when astropy is installed (and fall back to the bare
    arrays otherwise), so reference users' downstream ``.to(...)``
    code ports unchanged.
    """

    wavelength_um: np.ndarray   # (W,) [micron]
    flux_cgs: np.ndarray        # (W,) [erg / s / cm^3]

    @property
    def wavelength(self):
        return units.as_quantity(self.wavelength_um, "um")

    @property
    def spectral_axis(self):
        """Spectrum1D-compatible spectral axis (Quantity [um] when
        astropy is installed)."""
        return units.as_quantity(self.wavelength_um, "um")

    @property
    def flux(self):
        """Emergent flux (Quantity [erg / s / cm^3] when astropy is
        installed — the reference's ``flux_unit``,
        `frei/twostream.py:13`)."""
        return units.as_quantity(self.flux_cgs, "erg / (s cm3)")

    def to_spectrum1d(self):
        """An actual ``specutils.Spectrum1D`` (requires the optional
        specutils + astropy packages)."""
        from specutils import Spectrum1D
        return Spectrum1D(flux=self.flux,
                          spectral_axis=self.spectral_axis)


class Grid:
    """Temperature / pressure / wavelength grid and solve driver
    (reference `core.py:109-338`).

    Parameters mirror the reference constructor defaults
    (`core.py:117-126`): 500 wavelength bins in 0.5-10 um, 30 pressure
    layers in 1e-6-200 bar, initial T(P) power law around
    T_ref = 2300 K at 0.1 bar.
    """

    def __init__(
        self, planet: Planet,
        lam=None, pressures=None, init_temperatures=None,
        lam_min=0.5, lam_max=10.0, n_wl_bins=500,
        P_toa=1e-6, P_boa=200.0, n_layers=30,
        T_ref=2300.0, P_ref=0.1, alpha=0.1,
        dtype=jnp.float32,
    ):
        self.planet = planet
        self.dtype = dtype
        self.rt_grid: RTGrid = make_rt_grid(
            lam_min_micron=units.to_micron(lam_min),
            lam_max_micron=units.to_micron(lam_max),
            n_wl_bins=n_wl_bins,
            P_toa_bar=units.to_bar(P_toa), P_boa_bar=units.to_bar(P_boa),
            n_layers=n_layers,
            T_ref=units.to_kelvin(T_ref), P_ref_bar=units.to_bar(P_ref),
            alpha=alpha,
            lam_micron=None if lam is None else units.to_micron(lam),
            pressures_bar=None if pressures is None
            else units.to_bar(pressures),
            init_temperatures=None if init_temperatures is None
            else units.to_kelvin(init_temperatures),
        )
        self.opacities: Optional[OpacityStack] = None
        self.chemistry = None
        self._kappa_fn = None
        self._consts = None

    # -- convenience views ------------------------------------------------
    @property
    def lam(self):
        """Wavelength bin centers [micron]."""
        return self.rt_grid.lam_micron

    @property
    def wl_bins(self):
        """Wavelength bin edges [micron]."""
        return self.rt_grid.wl_edges_cm / const.MICRON_TO_CM

    @property
    def R(self):
        return self.rt_grid.R

    @property
    def pressures(self):
        """Layer pressures, BOA first [bar]."""
        return self.rt_grid.pressures_bar

    @property
    def init_temperatures(self):
        return self.rt_grid.init_temperatures

    # Fixture passthroughs used by tests / docs
    @property
    def lam_micron(self):
        return self.rt_grid.lam_micron

    @property
    def pressures_bar(self):
        return self.rt_grid.pressures_bar

    def __repr__(self):
        t = self.init_temperatures
        p = self.pressures
        lam = self.lam
        return (f"<Grid in T=[{t[0]:.0f}...{t[-1]:.0f}] K, "
                f"p=[{p[0]:.2g}...{p[-1]:.2g}] bar, "
                f"lam=[{lam[0]:.3g}...{lam[-1]:.3g}] um>")

    # -- opacity / chemistry loading --------------------------------------
    def load_opacities(self, species=None, path=None, opacities=None,
                       chemistry=None, force_reload=False,
                       groupies=True, engine="auto"):
        """Attach binned opacities (reference `core.py:198-231`).

        ``opacities`` may be an :class:`OpacityStack` or a dict of
        ``{isotopologue: (values, temps_K, press_bar)}`` arrays; when
        None, tables are binned from the on-disk opacity store under
        ``path`` (see ``frei_tpu.opacity.etl``).

        ``groupies`` selects the rebin semantics, as in the reference
        (`core.py:199` -> `opacity.py:66-170`): True for the grouped
        trapezoid-integral path (the semantics the published goldens
        are calibrated against — frei_tpu's default), False for the
        exact per-bin average path (the reference's own default).

        ``chemistry`` selects the mixing-ratio model: None or "mock"
        for the constant-VMR mock (the reference's no-pyfastchem
        fallback, `chemistry.py:143-153`), "equilibrium" for the JAX
        FastChem-equivalent solver in table mode, "equilibrium-exact"
        for the per-call exact solver, or any object with an
        ``mmr(temps, pressures_cgs)`` method.

        ``engine`` selects the rebin kernel for the ETL path ("auto" =
        threaded C++ on every backend — the ETL is host-streaming and
        transfers dominate on accelerators; measured rationale in
        ``opacity.etl.resolve_rebin_engine`` / docs/opacities.md).
        """
        if (self.opacities is None and opacities is None) or force_reload:
            from .opacity.etl import binned_opacity_stack
            self.opacities = binned_opacity_stack(
                self.rt_grid, species=species, path=path,
                dtype=self.dtype, groupies=groupies, engine=engine
            )
        elif opacities is not None:
            if isinstance(opacities, OpacityStack):
                self.opacities = opacities
            else:
                self.opacities = make_opacity_stack(opacities,
                                                    dtype=self.dtype)
        if chemistry is not None or self.chemistry is None:
            # chemistry=None on a grid that already has a model keeps
            # it: a reload (e.g. re-binning with a different engine)
            # must not silently downgrade equilibrium chemistry to the
            # constant-VMR mock.  Pass chemistry="mock" to reset.
            self.chemistry = chemistry
        self._build_solver_inputs()
        return self.opacities

    def _build_solver_inputs(self):
        stack = self.opacities
        if self.chemistry is None or self.chemistry == "mock":
            self.chemistry = MockChemistry(stack.masses_g, self.planet.m_bar)
        elif isinstance(self.chemistry, str):
            from .chemistry.fastchem import FastChemJAX
            if self.chemistry == "equilibrium":
                self.chemistry = FastChemJAX(stack.species,
                                             self.planet.m_bar)
            elif self.chemistry == "equilibrium-exact":
                self.chemistry = FastChemJAX(stack.species,
                                             self.planet.m_bar,
                                             mode="exact")
            else:
                raise ValueError(
                    f"unknown chemistry model {self.chemistry!r}")
        g = self.rt_grid
        sigma = rayleigh_total(g.lam_cm, self.planet.m_bar)
        self._consts = RTConstants(
            lam_cm=jnp.asarray(g.lam_cm, self.dtype),
            trapz_w=jnp.asarray(g.trapz_w_cm, self.dtype),
            pressures=jnp.asarray(g.pressures_cgs, self.dtype),
            sigma_scat=jnp.asarray(sigma, self.dtype),
            F_toa=jnp.asarray(
                f_toa_np(g.lam_cm, self.planet.T_star,
                         self.planet.a_rstar),
                self.dtype),
        )
        # Single shared wiring of the hot-loop kappa/chemistry model
        # (layer-factored tables) — see opacity/hotpath.py for why this
        # must not be hand-rolled.
        from .opacity.hotpath import build_kappa_model
        self._kappa_fn = build_kappa_model(
            stack, self.chemistry, self._consts.pressures,
            self._consts.sigma_scat)

    # -- the solve ---------------------------------------------------------
    def emission_spectrum(self, n_timesteps=1, n_zero_crossings=2,
                          convergence_dT=3.0, associative=False,
                          progress=False):
        """Compute the emission spectrum (reference `core.py:233-338`).

        Returns
        -------
        spec : Spectrum
        final_temps : ndarray (L,) [K]
        temperature_history : ndarray (L, n_recorded)
        dtaus : ndarray (L, W) from the final emit sweep
        """
        if self.opacities is None:
            raise ValueError(
                "Must load opacities before computing emission spectrum."
            )
        cfg = SolverConfig(
            n_timesteps=int(n_timesteps),
            n_zero_crossings=int(n_zero_crossings),
            convergence_dT=units.to_kelvin(convergence_dT),
            associative=associative,
            progress=bool(progress),
        )
        import time

        from .diag.telemetry import SolveMetrics
        t0 = time.perf_counter()
        result: RTResult = solve_rc(
            jnp.asarray(self.rt_grid.init_temperatures, self.dtype),
            self._consts,
            self.planet.physics_params(),
            self._kappa_fn,
            cfg,
        )
        jax.block_until_ready(result.flux)
        self.last_result = result
        self.last_metrics = SolveMetrics.from_result(
            result, time.perf_counter() - t0)
        n_hist = int(result.n_history)
        spec = Spectrum(
            wavelength_um=np.asarray(self.lam),
            flux_cgs=np.asarray(result.flux),
        )
        temp_hist = np.asarray(result.temp_history)[:n_hist].T  # (L, cols)
        return (spec, np.asarray(result.final_temps), temp_hist,
                np.asarray(result.dtaus))

    def emission_spectra(self, init_temps, n_timesteps=1,
                         n_zero_crossings=2, convergence_dT=3.0,
                         associative=False, engine="auto",
                         init_fluxes=None):
        """Batched emission spectra for an ensemble of columns on this
        grid (retrieval grids / phase curves — the scaling story the
        reference's vestigial dask path never delivered,
        `core.py:22-31`).

        Parameters
        ----------
        init_temps : (C, L) array-like
            Initial temperature profile per column [K].
        engine : "auto" | "xla"
            Sweep engine (see ``SolverConfig.engine``); both run the
            XLA sweeps.
        init_fluxes : optional ((C, L, W), (C, L, W)) pair
            Warm-start flux state for resuming a checkpointed solve
            (``frei_tpu.io.checkpoint.resume_state``).

        Returns
        -------
        spec : Spectrum with ``flux`` of shape (C, W)
        final_temps : (C, L)
        temperature_history : (C, L, n_recorded)
        dtaus : (C, L, W)

        Per-column results are identical to running
        :meth:`emission_spectrum` column by column (cross-checked in
        tests); columns that converge early freeze while the rest
        iterate.  For multi-device ensembles use
        ``frei_tpu.parallel.solve_ensemble`` with a mesh.
        """
        from .rt.solver import solve_rc_batched

        if self.opacities is None:
            raise ValueError(
                "Must load opacities before computing emission spectra."
            )
        cfg = SolverConfig(
            n_timesteps=int(n_timesteps),
            n_zero_crossings=int(n_zero_crossings),
            convergence_dT=units.to_kelvin(convergence_dT),
            associative=associative,
            engine=engine,
        )
        import time

        from .diag.telemetry import SolveMetrics
        init_temps = jnp.asarray(units.to_kelvin(init_temps), self.dtype)
        t0 = time.perf_counter()
        result: RTResult = solve_rc_batched(
            init_temps, self._consts, self.planet.physics_params(),
            self._kappa_fn, cfg, init_fluxes=init_fluxes)
        jax.block_until_ready(result.flux)
        self.last_result = result
        self.last_metrics = SolveMetrics.from_result(
            result, time.perf_counter() - t0,
            columns=init_temps.shape[0])
        n_hist = int(np.max(np.asarray(result.n_history)))
        spec = Spectrum(
            wavelength_um=np.asarray(self.lam),
            flux_cgs=np.asarray(result.flux),
        )
        temp_hist = np.swapaxes(
            np.asarray(result.temp_history)[:, :n_hist, :], 1, 2)
        return (spec, np.asarray(result.final_temps), temp_hist,
                np.asarray(result.dtaus))

    def spectrum_fn(self, n_timesteps=1, n_zero_crossings=2,
                    convergence_dT=3.0):
        """A pure, reverse-differentiable spectrum function for
        gradient-based retrieval — a capability the reference's
        numpy + C++-FastChem pipeline cannot offer (its driver loop,
        `core.py:233-338`, is host-side Python).

        Returns ``fn(init_temps, params, F_toa=None) -> flux`` where
        ``init_temps`` is (C, L) [K], ``params`` a
        :class:`~frei_tpu.rt.physics.PhysicsParams` (scalars or (C,)
        per-column arrays), ``F_toa`` an optional (C, W) per-column
        irradiation override, and ``flux`` the (C, W) emergent
        spectra as a traced jax array.  The function is jittable and
        composes with ``jax.grad`` / ``jax.jacobian`` / ``optax`` —
        gradients flow to ``init_temps``, every ``params`` field, and
        ``F_toa``.  It runs the fixed-horizon rematerialized solver
        (``SolverConfig.differentiable``; XLA engine), so per-call
        cost matches an unconverged ``n_timesteps`` solve.
        """
        from .rt.solver import solve_rc_batched

        if self.opacities is None:
            raise ValueError(
                "Must load opacities before building a spectrum fn.")
        cfg = SolverConfig(
            n_timesteps=int(n_timesteps),
            n_zero_crossings=int(n_zero_crossings),
            convergence_dT=units.to_kelvin(convergence_dT),
            engine="xla", differentiable=True)
        consts = self._consts
        kappa_fn = self._kappa_fn

        def fn(init_temps, params, F_toa=None):
            c = consts if F_toa is None else consts._replace(F_toa=F_toa)
            return solve_rc_batched(init_temps, c, params, kappa_fn,
                                    cfg).flux

        return fn

    def emission_dashboard(self, spec, final_temps, temperature_history,
                           dtaus, T_eff=None, plot_phoenix=True,
                           cache=False):
        """Dashboard figure (reference `core.py:340-383`)."""
        from .diag.plot import dashboard
        from .stellar.phoenix import get_binned_phoenix_spectrum

        if plot_phoenix:
            if T_eff is None:
                T_eff = effective_temperature(self, spec, dtaus, final_temps)
            phoenix = get_binned_phoenix_spectrum(
                T_eff, self.planet.g, self.wl_bins, self.lam, cache=cache
            )
        else:
            phoenix = np.zeros(len(self.lam))
        return dashboard(self, spec, phoenix, dtaus, final_temps,
                         temperature_history)


def effective_temperature_milne(grid: Grid, spec, dtaus, final_temps):
    """Photospheric temperature from the Milne tau=2/3 condition
    (reference `core.py:386-405`), per-wavelength pressure interpolation
    weighted by the lambda*F_lambda flux."""
    dtaus = np.asarray(dtaus, dtype=np.float64)
    pressures = np.asarray(grid.pressures, dtype=np.float64)  # [bar]
    lam_cm = np.asarray(grid.rt_grid.lam_cm)
    flux = np.asarray(spec.flux_cgs, dtype=np.float64)

    pressure_milne = np.ones(dtaus.shape[1])
    for i in range(dtaus.shape[1]):
        pressure_milne[i] = np.interp(
            2.0 / 3.0, np.exp(-dtaus[:, i]), pressures
        )
    # Weights: flux converted to erg/s/cm^2 via lambda * F_lambda
    # (`core.py:398-401` with u.spectral_density).
    weights = flux * lam_cm
    avg_p = np.average(pressure_milne, weights=weights)
    final_temps = np.asarray(final_temps, dtype=np.float64)
    return np.interp(avg_p, pressures[::-1], final_temps[::-1])


def effective_temperature_planck(grid: Grid, spec):
    """Stefan-Boltzmann inversion of the bolometric emitted flux
    (reference `core.py:408-414`)."""
    lam_cm = np.asarray(grid.rt_grid.lam_cm)
    bol = _trapezoid(np.asarray(spec.flux_cgs, dtype=np.float64), lam_cm)
    return float((bol / const.sigma_sb) ** 0.25)


def effective_temperature(grid: Grid, spec, dtaus, final_temps):
    """Mean of the Milne and Planck estimates (reference
    `core.py:417-439`)."""
    return 0.5 * (
        effective_temperature_milne(grid, spec, dtaus, final_temps)
        + effective_temperature_planck(grid, spec)
    )
