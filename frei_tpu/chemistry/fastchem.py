"""Batched equilibrium chemistry: a FastChem-equivalent solver in JAX.

The reference reaches equilibrium abundances through the external C++
FastChem solver via pybind (`/root/reference/frei/chemistry.py:143-173`)
— and re-instantiates and re-runs it for every layer of every sweep
(`opacity.py:246-248` inside the layer loop), the dominant known
inefficiency of its hot path.  frei_tpu replaces it with a pure-JAX
law-of-mass-action solver over the same shipped thermochemical data
(JANAF logK fits + Asplund 2009 solar abundances, repackaged by
``tools/build_chem_tables.py``), batched over (columns x layers)
points and jit/vmap compatible.

Formulation (p0 = 1 bar):

* unknowns per point: ``lam_j = ln(p_j / p0)`` for each element j
  (including the free electron) plus ``m = ln M``, the log of the
  total-nuclei normalization;
* gas species i has ``ln p_i = ln K_i(T) + sum_j nu_ij lam_j`` with
  ``ln K = a1/T + a2 ln T + a3 + a4 T + a5 T^2`` (the shipped fits);
* element conservation ``p_j + sum_i nu_ij p_i = eps_j M``, charge
  balance for the electron, and total pressure ``sum p = P``.

Algorithm — nested Gauss-Seidel with exact scalar solves (the same
strategy FastChem itself uses, Stock et al. 2018): sweep the elements
in descending-abundance order, solving each element's conservation
equation *exactly* in 1-D (the log-space residual is an increasing,
convex logsumexp in ``lam_j``, so safeguarded scalar Newton converges
globally); eliminate the electron analytically after each sweep (gas
charges in the tables are only +-1, making charge balance a quadratic
in ``p_e``); close total pressure with an outer secant on ``m``.
Everything is evaluated with max-subtracted logsumexp, so no
intermediate overflows even where ln K ~ 800 (T = 500 K) — a regime
where simultaneous multi-dimensional Newton fails on this system no
matter how it is scaled or globalized (tried: analytic-Jacobian
log-residual Newton, convex-dual damped Newton with row scaling;
both stall on ultra-stable multi-trace-element species like Na3AlF6).

The solver is exact but iterative (~30-60 sweeps cold, ~5 warm); for
the solver hot loop :class:`FastChemJAX` defaults to ``mode='table'``,
which precomputes log-VMRs on a dense (log T, log P) grid at load time
with the float64 exact solver and does a cheap fused bilinear lookup
on device — the same "chemistry leaves the critical path" design as
the binned opacity plane.
"""

from __future__ import annotations

from functools import partial
from pathlib import Path
from typing import NamedTuple, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants as const
from .names import (iso_to_mass_g, iso_to_species,
                    species_name_to_fastchem_name)

__all__ = ["ChemTable", "load_chem_table", "equilibrium_log_pressures",
           "FastChemJAX", "UNKNOWN_SPECIES"]

_DATA = Path(__file__).parent / "data" / "chem_tables.npz"

#: sentinel index for species absent from the tables (mirrors
#: FASTCHEM_UNKNOWN_SPECIES, `chemistry.py:153`)
UNKNOWN_SPECIES = -1


class ChemTable(NamedTuple):
    """Thermochemical tables (host metadata + arrays)."""

    elements: tuple          # (E,) symbols, 'e-' last
    abundances: np.ndarray   # (E,) eps_j relative to H, e- = 0
    species: tuple           # (S,) Hill-notation gas species
    stoich: np.ndarray       # (S, E) signed element counts
    coeffs: np.ndarray       # (S, 5) ln K fit coefficients
    species_mass_amu: np.ndarray  # (S,)

    @property
    def n_elements(self) -> int:
        return len(self.elements)

    @property
    def n_species(self) -> int:
        return len(self.species)

    def species_index(self, hill_name: str) -> int:
        """Index into the combined [elements..., gas species...] output
        vector, or UNKNOWN_SPECIES.  Matches the reference's use of
        ``fastchem.getSpeciesIndex`` (`chemistry.py:186`)."""
        if hill_name in self.elements:
            return self.elements.index(hill_name)
        if hill_name in self.species:
            return self.n_elements + self.species.index(hill_name)
        return UNKNOWN_SPECIES


def load_chem_table(path=_DATA) -> ChemTable:
    d = np.load(path, allow_pickle=False)
    return ChemTable(
        elements=tuple(str(e) for e in d["elements"]),
        abundances=d["abundances"],
        species=tuple(str(s) for s in d["species"]),
        stoich=d["stoich"].astype(np.float64),
        coeffs=d["logk_coeffs"],
        species_mass_amu=d["species_mass"],
    )


def _ln_k(coeffs, T):
    """ln K(T) from the 5-term fit; coeffs (S, 5), T (...,1) -> (...,S)."""
    a1, a2, a3, a4, a5 = (coeffs[:, i] for i in range(5))
    return a1 / T + a2 * jnp.log(T) + a3 + a4 * T + a5 * T * T


_NEG = -1e30  # stand-in for -inf that survives arithmetic


def _masked_lse(terms, mask, axis=-1):
    """Max-subtracted logsumexp over masked terms; all-masked rows
    return a very negative finite number."""
    t = jnp.where(mask, terms, _NEG)
    m = jnp.maximum(jnp.max(t, axis=axis, keepdims=True), _NEG)
    s = jnp.sum(jnp.where(mask, jnp.exp(t - m), 0.0), axis=axis)
    return m.squeeze(axis) + jnp.log(jnp.maximum(s, 1e-300))


def equilibrium_log_pressures(table: ChemTable, T, P_bar, x0=None,
                              n_sweeps: int = 60, n_inner: int = 16,
                              return_residuals: bool = False):
    """Solve equilibrium for a batch of (T, P) points.

    Parameters
    ----------
    T, P_bar : arrays (broadcast together)
        Temperature [K] and total pressure [bar].
    x0 : optional warm start, shape (..., E+1): element log pressures
        plus ``m`` from a previous solve.
    n_sweeps : Gauss-Seidel sweeps (static).
    n_inner : scalar-Newton iterations per 1-D element solve (static).
    return_residuals : also return the per-sweep convergence history.

    Returns
    -------
    ln_p : (..., E + S) log partial pressures (elements then species).
    z : (..., E + 1) warm-start state for subsequent calls.
    r_hist : (n_sweeps,) max-over-batch |log pressure-closure residual|
        per Gauss-Seidel sweep (only when ``return_residuals``) —
        ``r_hist[-1]`` is the solve's convergence metric.
    """
    T = jnp.asarray(T)
    P_bar = jnp.asarray(P_bar)
    dtype = jnp.result_type(T, P_bar)
    shape = jnp.broadcast_shapes(T.shape, P_bar.shape)
    Tf = jnp.broadcast_to(T, shape).reshape(-1).astype(dtype)
    Pf = jnp.broadcast_to(P_bar, shape).reshape(-1).astype(dtype)
    E, S = table.n_elements, table.n_species
    if x0 is not None:
        x0 = jnp.asarray(x0, dtype).reshape(-1, E + 1)
    static = _prepare_static(table)
    ln_p, z, r_hist = _solve_batch(static, Tf, Pf, x0,
                                   n_sweeps=n_sweeps, n_inner=n_inner)
    out = (ln_p.reshape(shape + (E + S,)),
           z.reshape(shape + (E + 1,)))
    return out + (r_hist,) if return_residuals else out


def _clip_interp_axis(coord, x):
    """Clamped 1-D linear-interpolation weights on ascending ``coord``:
    clip ``x`` into the axis range, lower index ``i``, fraction ``f``.

    ONE definition on purpose: :meth:`FastChemJAX.layer_mmr_interp`'s
    exactness claim against :meth:`FastChemJAX._vmr_from_table` (the
    bilinear interpolation factoring axis-by-axis) holds only while
    every table lookup uses the identical clip/searchsorted/fraction
    formula."""
    n = coord.shape[0]
    x = jnp.clip(x, coord[0], coord[-1])
    i = jnp.clip(jnp.searchsorted(coord, x, side="right") - 1, 0, n - 2)
    f = (x - coord[i]) / (coord[i + 1] - coord[i])
    return i, f


def _dot(a, b):
    """Matrix product at full float32 precision: without the pin a GPU
    may run it in TF32 (about three decimal digits), which the Newton
    steps on log-pressures cannot absorb."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def _prepare_static(table: ChemTable):
    """Host-side preprocessing shared by every solve (cheap numpy
    work, recomputed per call; the jitted solve below is the cached
    part)."""
    nu = np.asarray(table.stoich)
    eps = np.asarray(table.abundances)
    E = table.n_elements
    ie = E - 1 if table.elements[-1] == "e-" else None
    order = np.argsort(-eps[: ie if ie is not None else E])
    return dict(
        nu=nu, eps=eps, order=order, ie=ie,
        coeffs=np.asarray(table.coeffs),
        iH=table.elements.index("H"),
        iH2=table.species.index("H2") if "H2" in table.species else None,
    )


@partial(jax.jit, static_argnames=("n_sweeps", "n_inner"))
def _gs_solve(nu, eps, coeffs, order, ie, T, P_bar, z0,
              n_sweeps: int, n_inner: int):
    """Vectorized Gauss-Seidel equilibrium solve.  All arguments are
    device arrays except the static iteration counts; ``order`` is the
    element visitation order (descending abundance)."""
    dtype = T.dtype
    B = T.shape[0]
    S, E = nu.shape
    nu = nu.astype(dtype)
    eps = eps.astype(dtype)

    mask_pos = nu > 0                                     # (S, E)
    ln_nu = jnp.where(mask_pos, jnp.log(jnp.maximum(nu, 1e-30)), 0.0)
    nu_e = nu[:, ie]
    is_cat = nu_e < 0
    is_an = nu_e > 0

    lnK = _ln_k(coeffs.astype(dtype), T[:, None])         # (B, S)
    ln_P = jnp.log(P_bar)                                 # (B,)
    ln_eps = jnp.where(eps > 0, jnp.log(jnp.maximum(eps, 1e-300)), _NEG)

    lam0 = z0[:, :E]
    m0 = z0[:, E]

    def electron(lam):
        """Exact charge balance for +-1 gas charges: p_e^2 (1 + sum
        anions/p_e-part) = sum cations-part."""
        y_no_e = lnK + _dot(lam, nu.T) - jnp.outer(lam[:, ie], nu_e)
        lse_cat = _masked_lse(y_no_e, is_cat[None, :])
        t_an = jnp.concatenate(
            [jnp.zeros((B, 1), dtype), y_no_e], axis=1)
        m_an = jnp.concatenate(
            [jnp.ones((B, 1), bool),
             jnp.broadcast_to(is_an[None, :], (B, S))], axis=1)
        lse_an = _masked_lse(t_an, m_an)
        return 0.5 * (lse_cat - lse_an)

    def gs_sweep(carry, _):
        lam, m = carry
        y = lnK + _dot(lam, nu.T)                              # (B, S)

        def element_body(k, state):
            lam, y = state
            j = order[k]
            nu_j = nu[:, j]                               # (S,)
            mask_j = mask_pos[:, j]
            base = y - nu_j[None, :] * lam[:, j][:, None] + ln_nu[:, j]
            target = ln_eps[j] + m                        # (B,)

            def newton_1d(_, xj):
                terms = jnp.concatenate(
                    [xj[:, None], base + nu_j[None, :] * xj[:, None]],
                    axis=1)
                mask = jnp.concatenate(
                    [jnp.ones((B, 1), bool),
                     jnp.broadcast_to(mask_j[None, :], (B, S))], axis=1)
                t = _masked_lse(terms, mask)
                w = jnp.where(mask, jnp.exp(terms - t[:, None]), 0.0)
                slope = w[:, 0] + _dot(w[:, 1:], nu_j)
                return xj - (t - target) / jnp.maximum(slope, 0.5)

            xj = jax.lax.fori_loop(0, n_inner, newton_1d, lam[:, j])
            y = y + jnp.outer(xj - lam[:, j], nu_j)
            lam = lam.at[:, j].set(xj)
            return lam, y

        lam, y = jax.lax.fori_loop(0, order.shape[0], element_body,
                                   (lam, y))
        lam = lam.at[:, ie].set(electron(lam))
        y = lnK + _dot(lam, nu.T)

        # total-pressure residual and secant update on m
        t_all = jnp.concatenate([lam, y], axis=1)
        ln_P_tot = _masked_lse(t_all, jnp.ones(t_all.shape, bool))
        r_p = ln_P_tot - ln_P
        return (lam, m - r_p), jnp.max(jnp.abs(r_p))

    (lam, m), r_hist = jax.lax.scan(gs_sweep, (lam0, m0),
                                    None, length=n_sweeps)
    y = lnK + _dot(lam, nu.T)
    ln_p = jnp.concatenate([lam, y], axis=1)
    z = jnp.concatenate([lam, m[:, None]], axis=1)
    return ln_p, z, r_hist


def _solve_batch(static, T, P_bar, x0, n_sweeps, n_inner):
    dtype = T.dtype
    nu, eps = static["nu"], static["eps"]
    S, E = nu.shape
    ie = static["ie"]
    if ie is None:
        raise NotImplementedError("tables without an electron row")
    B = T.shape[0]
    ln_P = jnp.log(P_bar)
    if x0 is None:
        # atomic start with the H/H2 quadratic solved analytically
        eps_d = jnp.asarray(eps, dtype)
        ln_eps = jnp.where(eps_d > 0,
                           jnp.log(jnp.maximum(eps_d, 1e-300)), _NEG)
        m0 = ln_P - jnp.log(jnp.sum(eps_d))
        lam0 = ln_eps[None, :] + m0[:, None]
        lam0 = lam0.at[:, ie].set(ln_P - 40.0)
        if static["iH2"] is not None:
            lnK2 = _ln_k(jnp.asarray(static["coeffs"], dtype),
                         T[:, None])[:, static["iH2"]]
            K2 = jnp.exp(jnp.minimum(lnK2, 600.0))
            epsH = eps_d[static["iH"]]
            pH = ((-1.0 + jnp.sqrt(1.0 + 8.0 * K2 * epsH
                                   * jnp.exp(m0))) / (4.0 * K2))
            lam0 = lam0.at[:, static["iH"]].set(
                jnp.log(jnp.maximum(pH, 1e-300)))
        z0 = jnp.concatenate([lam0, m0[:, None]], axis=1)
    else:
        z0 = x0
    return _gs_solve(
        jnp.asarray(nu, dtype), jnp.asarray(eps, dtype),
        jnp.asarray(static["coeffs"], dtype),
        jnp.asarray(static["order"]), ie,
        T, P_bar, z0, n_sweeps=n_sweeps, n_inner=n_inner)


class FastChemJAX:
    """Chemistry model: equilibrium mass mixing ratios for the opacity
    species, batched over layers (and columns).

    Pipeline parity with the reference ``chemistry()``
    (`chemistry.py:114-205`): isotopologue -> species name -> Hill
    name -> solver index; VMR = n_i / n_gas = p_i / P; MMR = VMR *
    m_species / m_bar.  Unknown species raise at construction instead
    of printing (`chemistry.py:200-201`).

    Parameters
    ----------
    opacity_species : sequence of isotopologue names (opacity keys).
    m_bar_g : mean molecular weight [g].
    mode : 'table' (default) precomputes log-VMRs on a (log T, log P)
        grid with the float64 exact solver at construction and
        interpolates bilinearly on device — cheap, float32-safe, and
        accurate to ~1e-3 relative at the default 64 x 32 resolution.
        'exact' runs the Gauss-Seidel solve per call (use float64).
    T_range, P_range_bar : table-mode grid coverage (defaults
        500-6000 K / 1e-8-1e3 bar: the DACE opacity validity range
        plus T headroom so RC-iteration overshoots above 5000 K stay
        on-table instead of clamping).
    """

    def __init__(self, opacity_species: Sequence[str], m_bar_g: float,
                 table: Optional[ChemTable] = None, mode: str = "table",
                 n_sweeps: int = 60, grid_shape=(64, 32),
                 T_range=(500.0, 6000.0), P_range_bar=(1e-8, 1e3)):
        self.table = table if table is not None else load_chem_table()
        self.m_bar_g = float(m_bar_g)
        self.mode = mode
        self.n_sweeps = int(n_sweeps)
        self.isotopologues = tuple(opacity_species)
        idx, mass = [], []
        for iso in self.isotopologues:
            hill = species_name_to_fastchem_name(iso_to_species(iso))
            i = self.table.species_index(hill)
            if i == UNKNOWN_SPECIES:
                raise ValueError(
                    f"species {iso!r} ({hill!r}) not in chemistry tables"
                )
            idx.append(i)
            mass.append(iso_to_mass_g(iso))
        self._indices = np.array(idx)
        self._masses_g = np.array(mass)
        if mode == "table":
            self._build_vmr_table(grid_shape, T_range, P_range_bar)
        elif mode != "exact":
            raise ValueError(f"unknown chemistry mode {mode!r}")

    def _build_vmr_table(self, grid_shape, T_range, P_range_bar):
        nT, nP = grid_shape
        logT = np.linspace(np.log10(T_range[0]), np.log10(T_range[1]), nT)
        logP = np.linspace(np.log10(P_range_bar[0]),
                           np.log10(P_range_bar[1]), nP)
        P_row = 10.0 ** logP
        ln_vmr = np.empty((nT, nP, len(self._indices)))
        worst = 0.0
        with jax.enable_x64(True):
            # Continuation: solve the hottest row cold (chemistry is
            # mildest there), then walk down in T warm-starting each
            # row from the previous one — ~4x fewer sweeps overall.
            z = None
            for k in range(nT - 1, -1, -1):
                T_row = np.full(nP, 10.0 ** logT[k])
                ln_p, z, r = equilibrium_log_pressures(
                    self.table, jnp.asarray(T_row, jnp.float64),
                    jnp.asarray(P_row, jnp.float64),
                    x0=z, n_sweeps=self.n_sweeps if z is None else 16,
                    return_residuals=True)
                if float(r[-1]) > 1e-8:
                    # warm start from the neighboring T row was not
                    # close enough (coarse grids / stiff cold rows) —
                    # finish the row with a full-sweep continuation
                    ln_p, z, r = equilibrium_log_pressures(
                        self.table, jnp.asarray(T_row, jnp.float64),
                        jnp.asarray(P_row, jnp.float64),
                        x0=z, n_sweeps=self.n_sweeps,
                        return_residuals=True)
                worst = max(worst, float(r[-1]))
                ln_vmr[k] = (np.asarray(ln_p)[:, self._indices]
                             - np.log(P_row)[:, None])
        #: worst final pressure-closure residual over the table build —
        #: convergence telemetry (asserted in tests; loud failure
        #: detection for pathological (T, P) coverage requests)
        self.table_residual = worst
        if worst > 1e-6:
            raise RuntimeError(
                f"chemistry table build did not converge: final "
                f"pressure-closure residual {worst:.2e} (> 1e-6); "
                f"raise n_sweeps or shrink T_range/P_range_bar")
        self._tab_logT = jnp.asarray(logT, jnp.float32)
        self._tab_logP = jnp.asarray(logP, jnp.float32)
        self._tab_lnvmr = jnp.asarray(ln_vmr, jnp.float32)

    def _vmr_from_table(self, temperatures, pressures_cgs):
        dtype = jnp.result_type(temperatures)
        logT = jnp.log10(jnp.asarray(temperatures, jnp.float32))
        logP = jnp.log10(jnp.asarray(pressures_cgs, jnp.float32)
                         / const.BAR_TO_CGS)
        ti, tf = _clip_interp_axis(self._tab_logT, logT)
        pj, pf = _clip_interp_axis(self._tab_logP, logP)
        v = self._tab_lnvmr
        out = ((1 - tf)[..., None] * ((1 - pf)[..., None] * v[ti, pj]
                                      + pf[..., None] * v[ti, pj + 1])
               + tf[..., None] * ((1 - pf)[..., None] * v[ti + 1, pj]
                                  + pf[..., None] * v[ti + 1, pj + 1]))
        return jnp.moveaxis(jnp.exp(out), -1, 0).astype(dtype)

    def vmr(self, temperatures, pressures_cgs):
        """(S,) + batch volume mixing ratios."""
        if self.mode == "table":
            return self._vmr_from_table(temperatures, pressures_cgs)
        return self.vmr_with_state(temperatures, pressures_cgs)[0]

    def vmr_with_state(self, temperatures, pressures_cgs, z0=None,
                       n_sweeps: Optional[int] = None):
        """Exact-mode VMRs plus the warm-start state ``z`` for the next
        call (pure function — thread ``z`` through an iteration loop
        to re-solve with far fewer sweeps as temperatures drift; the
        exact-mode analogue of the table build's row-to-row
        continuation).  Also returns the per-sweep residual history as
        the third element (``r_hist[-1]`` is the convergence metric).
        """
        if self.mode == "table":
            raise AttributeError("warm-start state is exact-mode only")
        P_bar = jnp.asarray(pressures_cgs) / const.BAR_TO_CGS
        ln_p, z, r_hist = equilibrium_log_pressures(
            self.table, jnp.asarray(temperatures), P_bar, x0=z0,
            n_sweeps=self.n_sweeps if n_sweeps is None else n_sweeps,
            return_residuals=True)
        ln_vmr = (ln_p[..., self._indices]
                  - jnp.log(P_bar)[..., None])
        return jnp.moveaxis(jnp.exp(ln_vmr), -1, 0), z, r_hist

    def mmr(self, temperatures, pressures_cgs):
        """(S,) + batch mass mixing ratios (`chemistry.py:197-199`)."""
        v = self.vmr(temperatures, pressures_cgs)
        scale = jnp.asarray(self._masses_g / self.m_bar_g, v.dtype)
        return v * scale.reshape(scale.shape + (1,) * (v.ndim - 1))

    def layer_ln_mmr_tables(self, pressures_cgs):
        """Layer-factored form for the fused iteration kernel (table
        mode only): pre-interpolate the (logT, logP) ln-VMR table onto
        the fixed layer pressures, fold in the mass/m_bar scale, and
        return (log10 T grid, (L, nTc, S) ln-MMR table).  The kernel's
        clipped 1-D logT interpolation then reproduces
        :meth:`_vmr_from_table` exactly (bilinear interpolation
        factors axis-by-axis)."""
        if self.mode != "table":
            raise AttributeError(
                "layer-factored chemistry requires table mode")
        logP = jnp.log10(jnp.asarray(pressures_cgs, jnp.float32)
                         / const.BAR_TO_CGS)
        pj, pf = _clip_interp_axis(self._tab_logP, logP)
        v = self._tab_lnvmr                        # (nTc, nPc, S)
        tab = ((1 - pf)[None, :, None] * v[:, pj, :]
               + pf[None, :, None] * v[:, pj + 1, :])   # (nTc, L, S)
        tab = tab + jnp.log(
            jnp.asarray(self._masses_g / self.m_bar_g, tab.dtype))
        return self._tab_logT, jnp.moveaxis(tab, 0, 1)  # (L, nTc, S)

    def supports_layer_factoring(self):
        """True when :meth:`layer_mmr_interp` is available (table
        mode): the hot loop can hoist the P interpolation."""
        return self.mode == "table"

    def layer_mmr_interp(self, pressures_cgs):
        """Hot-loop MMR evaluator on the fixed layer grid (table mode
        only): returns ``mmr_fn(temps)`` with ``temps`` (..., L) ->
        (S, ..., L) mass mixing ratios, equal to
        ``self.mmr(temps, pressures_cgs)`` to float32 rounding.

        Why this exists: :meth:`_vmr_from_table` re-does the
        pressure-axis searchsorted and four 2-D fancy-index gathers on
        (batch, L)-shaped indices EVERY solver iteration.  Here the P
        axis is interpolated ONCE onto the static layer pressures
        (:meth:`layer_ln_mmr_tables`), leaving a per-iteration 1-D
        logT interpolation expressed as a one-hot contraction — the
        same gather-free pattern as the kappa table lookup
        (opacity/tables.py `layer_interp_weights`).  Temperatures are
        CLAMPED to the table range (matching ``_vmr_from_table``'s
        clip, not the opacity tables' zero-fill)."""
        if self.mode != "table":
            raise AttributeError(
                "layer-factored chemistry requires table mode")
        logT_grid, tab = self.layer_ln_mmr_tables(pressures_cgs)
        nTc = logT_grid.shape[0]

        def mmr_fn(temps):
            dtype = jnp.result_type(temps)
            x = jnp.log10(jnp.asarray(temps, jnp.float32))
            i, f = _clip_interp_axis(logT_grid, x)
            oh = (jax.nn.one_hot(i, nTc, dtype=jnp.float32)
                  * (1.0 - f)[..., None]
                  + jax.nn.one_hot(i + 1, nTc, dtype=jnp.float32)
                  * f[..., None])                  # (..., L, nTc)
            ln = jnp.einsum('...lk,lks->...ls', oh, tab,
                            precision=jax.lax.Precision.HIGHEST)
            return jnp.moveaxis(jnp.exp(ln), -1, 0).astype(dtype)

        return mmr_fn


def hot_loop_mmr_fn(chem, pressures_cgs):
    """Best MMR evaluator for a solver hot loop on the FIXED layer
    pressure grid: the layer-factored table path
    (:meth:`FastChemJAX.layer_mmr_interp`) when the chemistry model
    advertises it via ``supports_layer_factoring()``, else the generic
    ``chem.mmr(temps, pressures_cgs)``.

    Dispatch is an explicit capability check, NOT exception-driven:
    an incidental ``AttributeError`` inside a custom model's
    ``layer_mmr_interp`` must propagate loudly rather than silently
    demote the solve to the gather path.  Shared by ``api.Grid`` and
    ``parallel.solve_ensemble`` so every entry point gets the same
    hot-loop chemistry."""
    supports = getattr(chem, "supports_layer_factoring", None)
    fast = getattr(chem, "layer_mmr_interp", None)
    if fast is not None and (supports is None or supports()):
        return fast(pressures_cgs)

    def mmr_fn(temps):
        return chem.mmr(temps, pressures_cgs)

    return mmr_fn
