"""Device-resident opacity tables and the fused kappa lookup.

The reference keeps one ``xarray.DataArray`` per species and, inside the
layer loop, re-runs chemistry and does a per-layer scipy interpolation
(`/root/reference/frei/opacity.py:203-269`, called from
`twostream.py:368-370`).  frei_tpu instead canonicalizes all binned
tables onto one device array of shape (species, T, P, wavelength) and
evaluates kappa for *all layers (and columns) at once* as a fused
gather / bilinear-interp / weighted-sum, hoisted out of the layer scan
— numerically identical, but one XLA op-cluster instead of
O(layers x species) scipy calls per sweep.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants as const
from ..chemistry.names import iso_to_mass_g

__all__ = ["OpacityStack", "make_opacity_stack", "interp_tp",
           "set_interp_mode", "kappa_from_stack", "load_example_opacity"]

#: None = auto (the gather, on every backend); or an explicit engine
#: name "onehot" / "gather" (cross-check tests force these).
_INTERP_MODE: Optional[str] = None


def set_interp_mode(mode: Optional[str]) -> None:
    """Select the (T, P) interpolation engine: ``"gather"``, the
    experimental ``"onehot"`` matrix product, or None for the default
    (the gather)."""
    global _INTERP_MODE
    if mode in (None, "onehot", "gather"):
        _INTERP_MODE = mode
    else:
        raise ValueError(f"unknown interp mode {mode!r}")


class OpacityStack(NamedTuple):
    """Binned opacities for all species on a shared (T, P) grid.

    ``values[s, i, j, w]`` is the opacity of species ``s`` at
    temperature ``temps[i]``, pressure ``press_cgs[j]`` and wavelength
    bin ``w``, in cm^2 / g.  Axes are canonicalized ascending.
    The shared grid mirrors the reference behavior: ``binned_opacity``
    interpolates every species onto the run's (T, P) grid at load time
    (`opacity.py:141-146`), so the per-species grids coincide.
    """

    values: jnp.ndarray       # (S, nT, nP, W)
    temps: jnp.ndarray        # (nT,) ascending [K]
    press_cgs: jnp.ndarray    # (nP,) ascending [barye]
    species: tuple            # (S,) isotopologue names, static metadata
    masses_g: np.ndarray      # (S,) species masses [g], host-side

    @property
    def n_species(self) -> int:
        return self.values.shape[0]


def _canonicalize_axis(coord, values, axis):
    """Sort one table axis ascending and drop duplicate coordinates
    (keep first occurrence), like ``drop_duplicates`` in the example
    fixture (`opacity.py:339`)."""
    coord = np.asarray(coord, dtype=np.float64)
    # np.unique returns ascending unique values with the index of the
    # first occurrence of each — exactly "sort + keep first duplicate".
    uniq, first_idx = np.unique(coord, return_index=True)
    return uniq, np.take(values, first_idx, axis=axis)


def make_opacity_stack(
    tables: dict, dtype=jnp.float32
) -> OpacityStack:
    """Build an :class:`OpacityStack` from per-species arrays.

    Parameters
    ----------
    tables : dict
        ``{isotopologue: (values, temps_K, press_bar)}`` with ``values``
        of shape (nT, nP, W) — any axis ordering of T/P descending is
        canonicalized here.  All species must share the grid shape
        (guaranteed for tables produced by the binning pipeline).
    """
    species = tuple(tables.keys())
    vals, ref_T, ref_P = None, None, None
    stacked = []
    for name in species:
        values, temps, press_bar = tables[name]
        temps, values = _canonicalize_axis(temps, np.asarray(values), 0)
        press_bar, values = _canonicalize_axis(press_bar, values, 1)
        if ref_T is None:
            ref_T, ref_P = temps, press_bar
        else:
            if not (np.array_equal(ref_T, temps)
                    and np.array_equal(ref_P, press_bar)):
                raise ValueError(
                    "all species must share the binned (T, P) grid; "
                    f"species {name!r} differs"
                )
        stacked.append(values)
    masses = np.array([iso_to_mass_g(s) for s in species])
    return OpacityStack(
        values=jnp.asarray(np.stack(stacked), dtype=dtype),
        temps=jnp.asarray(ref_T, dtype=dtype),
        press_cgs=jnp.asarray(ref_P * const.BAR_TO_CGS, dtype=dtype),
        species=species,
        masses_g=masses,
    )


def _axis_weights(coord, x):
    """Lower index, interpolation fraction, and in-range mask for linear
    interpolation of points ``x`` on ascending axis ``coord``.

    The hull test carries a few-ULP relative tolerance: solver grids
    routinely place lookup points EXACTLY on a table edge (the run's
    initial temperatures are the table's temperature axis), and an
    LSB-level perturbation from a different compute path (e.g. a
    backend that round-trips arrays with ~1e-13 relative error) must
    not flip the zero-fill and silently erase that layer's
    molecular opacity.  Points genuinely outside by more than ~8 ULP
    still zero-fill, matching the reference (`opacity.py:241-263`)."""
    n = coord.shape[0]
    if n == 1:
        # Degenerate 1-point axis: treat as axis-constant (idx 0,
        # frac 0, always in range on THIS axis) instead of dividing
        # by x1 - x0 == 0 (NaN even at the tabulated point).  This is
        # the same convention as the reference's 1-point-T axis skip
        # (`opacity.py:256-259`) and the ETL's single-P mirroring
        # (opacity_dir_to_store), which both read "no variation along
        # this axis".  Callers' idx+1 lookups clamp (JAX gather) and
        # are weighted by frac == 0.
        shape = jnp.shape(x)
        return (jnp.zeros(shape, jnp.int32),
                jnp.zeros(shape, jnp.result_type(coord)),
                jnp.ones(shape, bool))
    idx = jnp.clip(jnp.searchsorted(coord, x, side="right") - 1, 0, n - 2)
    x0 = coord[idx]
    x1 = coord[idx + 1]
    frac = (x - x0) / (x1 - x0)
    eps = 8.0 * jnp.finfo(jnp.result_type(coord)).eps
    lo = coord[0] - eps * jnp.abs(coord[0])
    hi = coord[-1] + eps * jnp.abs(coord[-1])
    in_range = (x >= lo) & (x <= hi)
    return idx, frac, in_range


def interp_tp(stack: OpacityStack, temperature, pressure_cgs):
    """Bilinear (T, P) interpolation of every species' spectrum.

    Matches the reference per-layer lookup ``opacities[s].interp(...,
    method='linear', fill_value=0)`` (`opacity.py:241-263`): linear
    inside the grid hull, exactly zero outside (this matters — layer
    temperatures can leave the tabulated range during the RC iteration,
    and the reference zeroes the molecular opacity there).  Tables with
    a single temperature point skip the T axis, as the reference does
    (`opacity.py:256-259`).

    Two engines compute the same function (cross-checked to float32
    roundoff in ``tests/test_opacity.py``): a 4-point gather (exact;
    the default) and an experimental weighted one-hot matrix product
    at ``Precision.HIGHEST``, selected with :func:`set_interp_mode`.

    Parameters
    ----------
    temperature, pressure_cgs : scalars or arrays of shape B
        Lookup points (broadcast together).

    Returns
    -------
    array of shape (S,) + B + (W,)
    """
    values = stack.values
    nT = values.shape[1]

    if nT > 1 and _INTERP_MODE == "onehot":
        return _interp_tp_onehot(stack, temperature, pressure_cgs)

    pj, pf, p_ok = _axis_weights(stack.press_cgs, pressure_cgs)
    if nT == 1:
        v = values[:, 0]                                   # (S, nP, W)
        out = ((1.0 - pf)[..., None] * v[:, pj]
               + pf[..., None] * v[:, pj + 1])
        return jnp.where(p_ok[..., None], out, 0.0)

    ti, tf, t_ok = _axis_weights(stack.temps, temperature)
    v00 = values[:, ti, pj]            # (S,) + B + (W,)
    v01 = values[:, ti, pj + 1]
    v10 = values[:, ti + 1, pj]
    v11 = values[:, ti + 1, pj + 1]
    tf = tf[..., None]
    pf = pf[..., None]
    out = ((1.0 - tf) * ((1.0 - pf) * v00 + pf * v01)
           + tf * ((1.0 - pf) * v10 + pf * v11))
    ok = (t_ok & p_ok)[..., None]
    return jnp.where(ok, out, 0.0)


def _interp_tp_onehot(stack: OpacityStack, temperature, pressure_cgs):
    """Matrix-product formulation of :func:`interp_tp`: build the
    (points, nT*nP) bilinear-weight matrix as a sum of four one-hots
    and contract it with the (nT*nP, species*W) table in one
    ``Precision.HIGHEST`` matmul.  Numerically equal to the gather path up to float32
    summation order (~1e-7 relative)."""
    values = stack.values                      # (S, nT, nP, W)
    S, nT, nP, W = values.shape
    temperature, pressure_cgs = jnp.broadcast_arrays(
        jnp.asarray(temperature), jnp.asarray(pressure_cgs))
    B = temperature.shape

    ti, tf, t_ok = _axis_weights(stack.temps, temperature)
    pj, pf, p_ok = _axis_weights(stack.press_cgs, pressure_cgs)
    i00 = (ti * nP + pj).reshape(-1)
    tf = tf.reshape(-1)
    pf = pf.reshape(-1)
    M = nT * nP
    dt = values.dtype
    oh = (jax.nn.one_hot(i00, M, dtype=dt) * ((1 - tf) * (1 - pf))[:, None]
          + jax.nn.one_hot(i00 + 1, M, dtype=dt) * ((1 - tf) * pf)[:, None]
          + jax.nn.one_hot(i00 + nP, M, dtype=dt) * (tf * (1 - pf))[:, None]
          + jax.nn.one_hot(i00 + nP + 1, M, dtype=dt) * (tf * pf)[:, None])
    flat = jnp.moveaxis(values.reshape(S, M, W), 0, 1).reshape(M, S * W)
    out = jnp.matmul(oh, flat,
                     precision=jax.lax.Precision.HIGHEST)  # (N, S*W)
    out = jnp.moveaxis(out.reshape(B + (S, W)), -2, 0)     # (S,) + B + (W,)
    ok = (t_ok & p_ok)[..., None]
    return jnp.where(ok, out, 0.0)


def kappa_from_stack(stack: OpacityStack, mmr, temperature, pressure_cgs,
                     sigma_scat):
    """Total opacity and scattering opacity [cm^2 / g].

    Vectorized equivalent of the reference ``kappa``
    (`opacity.py:203-269`): per-species bilinear lookup at (T, P),
    weighted by the mass mixing ratio, summed over species, plus the
    Rayleigh scattering term (which the reference adds to the total —
    note its single-scattering albedo therefore uses
    ``sigma / (sigma + k_total)`` with ``k_total`` already containing
    ``sigma``; we reproduce that downstream).

    Parameters
    ----------
    mmr : (S,) + B array
        Mass mixing ratios from the chemistry model.
    temperature, pressure_cgs : B arrays
    sigma_scat : (W,) array
        Host-precomputed Rayleigh opacity.

    Returns
    -------
    k_total, sigma_scat : (B + (W,)) and (W,) arrays
    """
    per_species = interp_tp(stack, temperature, pressure_cgs)
    k_mol = jnp.sum(mmr[..., None] * per_species, axis=0)
    return k_mol + sigma_scat, sigma_scat


class LayerKappaTables(NamedTuple):
    """Per-layer pre-P-interpolated opacity tables.

    The solver's kappa lookup points are always (T_l, p_l) on the
    run's FIXED layer-pressure grid — only the temperatures change
    between sweeps (`/root/reference/frei/twostream.py:368-370` with
    `tp.py`'s static pressure grid).  Bilinear interpolation therefore
    factors exactly: interpolate the (T, P) tables onto each layer's
    pressure ONCE per configuration (here), leaving a per-sweep 1-D
    linear interpolation in temperature — a (points, nT)-wide weight
    contraction instead of (points, nT*nP).
    Values match the bilinear 4-corner blend up to float32 rounding
    (linear interpolation commutes axis-by-axis).
    """

    tab: jnp.ndarray     # (L, S*nT, W): P-interp'd, zero outside P hull
    temps: jnp.ndarray   # (nT,) ascending [K]
    n_species: int


def make_layer_tables(stack: OpacityStack,
                      pressures_cgs) -> LayerKappaTables:
    """Hoist the pressure axis of the bilinear kappa interpolation
    onto the fixed layer grid (see :class:`LayerKappaTables`)."""
    v = stack.values                                  # (S, nT, nP, W)
    S, nT, nP, W = v.shape
    pj, pf, p_ok = _axis_weights(stack.press_cgs,
                                 jnp.asarray(pressures_cgs))
    w1 = (pf * p_ok)[None, None, :, None]
    w0 = ((1.0 - pf) * p_ok)[None, None, :, None]
    tabs = w0 * v[:, :, pj, :] + w1 * v[:, :, pj + 1, :]  # (S, nT, L, W)
    tab = jnp.moveaxis(tabs, 2, 0).reshape(
        pressures_cgs.shape[0], S * nT, W)            # k = s*nT + t
    return LayerKappaTables(tab=tab, temps=stack.temps, n_species=S)


def layer_interp_weights(lt: LayerKappaTables, mmr, temperature):
    """Species-weighted 1-D T-interpolation weight rows: the (..., L,
    S*nT) matrix W such that ``k_mol[..., l, :] = W[..., l, :] @
    lt.tab[l]``."""
    nT = lt.temps.shape[0]
    dt = lt.tab.dtype
    ti, tf, t_ok = _axis_weights(lt.temps, temperature)
    w_lo = ((1.0 - tf) * t_ok).astype(dt)
    w_hi = (tf * t_ok).astype(dt)
    oh = (jax.nn.one_hot(ti, nT, dtype=dt) * w_lo[..., None]
          + jax.nn.one_hot(ti + 1, nT, dtype=dt) * w_hi[..., None])
    m = jnp.moveaxis(mmr, 0, -1).astype(dt)           # (..., L, S)
    return (m[..., :, None] * oh[..., None, :]).reshape(
        jnp.shape(temperature) + (lt.n_species * nT,))


def kappa_from_layer_tables(lt: LayerKappaTables, mmr, temperature,
                            sigma_scat):
    """Total opacity on the layer grid: 1-D T-interp weight rows
    (species-weighted) contracted with the per-layer tables.
    ``temperature`` is (..., L); ``mmr`` is (S, ..., L).  Returns
    (k_total, sigma_scat) like :func:`kappa_from_stack`, with identical
    out-of-hull zero-fill semantics."""
    ohs = layer_interp_weights(lt, mmr, temperature)
    k_mol = jnp.einsum('...lk,lkw->...lw', ohs, lt.tab,
                       precision=jax.lax.Precision.HIGHEST)
    return k_mol + sigma_scat, sigma_scat


def load_example_opacity(grid, seed: int = 42, scale_factor: float = 20.0,
                         dtype=jnp.float32) -> OpacityStack:
    """Deterministic synthetic water-like opacity fixture.

    Regeneration of the reference fixture
    (`/root/reference/frei/opacity.py:272-342`): gaussian IR and optical
    bumps, 15 seeded random optical absorption lines, three NIR
    water-like bands, scaled as ``10**(2.5 * (x - 0.4))``, constant
    over the (T, P) axes, keyed "1H2-16O".  Used by the golden
    integration tests and the docs quickstart so the multi-GB DACE
    download is never needed.

    Calibration note: the reference source carries an extra prefactor
    of 5 on the opacity profile (`opacity.py:326`), but its published
    golden test values (`frei/tests/test_core.py:52-71`: peak
    wavelength 1.1518 um, peak flux 1.296e13 erg/s/cm^3, T_eff ~
    T_ref) are reproduced — to three significant figures, with the
    Stefan-Boltzmann effective temperature landing exactly on T_ref —
    only *without* that factor; with it, all three golden assertions
    fail in an independent float64 re-implementation of the pipeline
    (see ``tests/reference_impl.py``).  The goldens predate the
    prefactor, so this fixture omits it to stay consistent with the
    published correctness anchors in BASELINE.md.

    Parameters
    ----------
    grid : RTGrid (or any object with ``lam_micron``, ``pressures_bar``
        and ``init_temperatures`` attributes).
    """
    lam_um = np.asarray(grid.lam_micron, dtype=np.float64)
    press_bar = np.asarray(grid.pressures_bar, dtype=np.float64)
    temps = np.asarray(grid.init_temperatures, dtype=np.float64)

    rng = np.random.RandomState(seed)  # legacy MT19937, as np.random.seed
    so = (np.exp(-0.5 * (lam_um - 6.0) ** 2 / 2.0 ** 2)
          + 0.8 * np.exp(-0.5 * (lam_um - 0.3) ** 2 / 0.5 ** 2))
    amps = rng.uniform(low=0.1, high=0.2, size=15)
    wls = rng.uniform(low=0.5, high=1.0, size=15)
    for amp, wl in zip(amps, wls):
        so += amp * np.exp(-0.5 * (lam_um - wl) ** 2 / 0.005 ** 2)
    for amp, wl in zip([0.22, 0.2, 0.18],
                       np.logspace(np.log10(1.4), np.log10(2.7), 3)):
        so += amp * np.exp(-0.5 * (lam_um - wl) ** 2 / 0.13 ** 2)

    profile = scale_factor * 10.0 ** (2.5 * (so - 0.4))
    values = np.broadcast_to(
        profile, (temps.shape[0], press_bar.shape[0], lam_um.shape[0])
    ).copy()
    return make_opacity_stack(
        {"1H2-16O": (values, temps, press_bar)}, dtype=dtype
    )
