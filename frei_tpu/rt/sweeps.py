"""Emit / absorb layer sweeps as (associative) scans.

The reference solver core is a sequential per-layer Python loop
(`/root/reference/frei/twostream.py:290-550`): ``emit`` sweeps layers
bottom-to-top propagating the upward flux, ``absorb`` sweeps
top-to-bottom propagating the downward flux, and each step interleaves
a temperature-tendency computation.  The key structural facts (derived
in SURVEY.md section 3.3 and verified against the reference line by
line) are:

* within a sweep, the *propagated* flux forms a first-order affine
  recurrence: in ``emit``, ``F_up[i+1] = a_i F_up[i] + c_i`` where
  ``c_i`` depends only on the *stale* opposite-direction flux array and
  the thermal source (`twostream.py:383-394`); in ``absorb``,
  symmetrically for ``F_down`` (`twostream.py:511-522`);
* the opposite-direction flux written during a sweep
  (``fluxes_down[i]`` in emit, ``fluxes_up[i+1]`` in absorb) and all
  temperature tendencies depend only on the recurrence solution and
  stale state, so they vectorize across layers after the recurrence is
  solved;
* layer temperatures are frozen for the duration of a sweep
  (`twostream.py:353-354`), so the opacity / chemistry lookups hoist
  out of the layer loop entirely.

This turns each sweep into: [hoisted kappa for all layers] ->
[two-stream couplers for all layers] -> [one affine prefix scan over
layers] -> [vectorized flux/temperature postprocessing].  The prefix
scan runs either as ``lax.scan`` (the default, see
SolverConfig.associative) or
``lax.associative_scan`` (log-depth, for deep grids); both reproduce
the reference's Gauss-Seidel-like update ordering exactly.

Boundary quirks faithfully reproduced (SURVEY.md section 7 "hard
parts"): the top-layer pressure extrapolation ``p2 = p[-1] p[-2]/p[-3]``
(`twostream.py:358-359`), dtau output seeded with a row of ones
(`twostream.py:352,487`), emit leaving layer 0 untouched (loop from
i=1, `twostream.py:356`), emit not storing the top layer's outgoing
flux (`twostream.py:392-393`), and absorb leaving the top F_down and
bottom F_up rows untouched.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
from jax import lax

from ..ops.planck import planck_lambda
from ..ops.twostream import two_stream_couplers
from . import physics
from .physics import PhysicsParams

__all__ = ["SweepResult", "emit_sweep", "absorb_sweep", "bolometric_flux",
           "emit_dtaus"]


def emit_dtaus(k_all, pressures, params):
    """The dtaus diagnostic of an emit sweep (`twostream.py:352,371`):
    a row of ones followed by the per-swept-layer optical depths.
    Shape-generic over leading batch axes of ``k_all``; ``params.g``
    may be per-column (B,)/(B, 1) against (B, L, W) ``k_all``."""
    p = pressures
    g = jnp.asarray(params.g)
    if g.ndim >= 1:
        g = g.reshape(g.shape[0], 1, 1)    # (B, 1, 1) vs (B, L-1, W)
    p2 = jnp.concatenate([p[2:], (p[-1] * p[-2] / p[-3])[None]])
    dtau = physics.delta_tau(k_all[..., 1:, :], p[1:, None], p2[:, None],
                             g)
    ones = jnp.ones_like(k_all[..., :1, :])
    return jnp.concatenate([ones, dtau], axis=-2)


class SweepResult(NamedTuple):
    F_up: jnp.ndarray        # (L, W) updated upward fluxes
    F_down: jnp.ndarray      # (L, W) updated downward fluxes
    temps: jnp.ndarray       # (L,) updated temperatures
    dT: jnp.ndarray          # (L,) temperature change applied (T_new = T - dT)
    dtaus: jnp.ndarray       # (L, W): [ones, dtau per swept layer in sweep order]


def bolometric_flux(flux, trapz_w):
    """``np.trapz(flux, lam)`` as a quadrature dot product
    (`twostream.py:16-20`).  The precision is pinned: this sum drives
    every temperature update, and a float32 dot left at the default
    may run in TF32 on a GPU (about three decimal digits)."""
    return jnp.matmul(flux, trapz_w, precision=lax.Precision.HIGHEST)


def _affine_prefix_assoc(A, c, init):
    """z_k = (e_k o ... o e_0)(init) for affine maps e_j(x) = A_j x + c_j,
    via a log-depth associative scan over the layer axis."""
    def combine(left, right):
        a_l, c_l = left
        a_r, c_r = right
        return a_r * a_l, a_r * c_l + c_r
    A_pref, c_pref = lax.associative_scan(combine, (A, c), axis=0)
    return A_pref * init + c_pref


def _affine_prefix_seq(A, c, init):
    """Sequential reference implementation of the same prefix map."""
    def step(carry, ac):
        a, cc = ac
        new = a * carry + cc
        return new, new
    _, z = lax.scan(step, init, (A, c))
    return z


def _affine_prefix(A, c, init, associative: bool):
    if associative:
        return _affine_prefix_assoc(A, c, init)
    return _affine_prefix_seq(A, c, init)


def emit_sweep(
    temps, F_up, F_down, k_all, sigma_scat, F_toa,
    lam_cm, trapz_w, pressures, params: PhysicsParams,
    associative: bool = False,
) -> SweepResult:
    """One bottom-to-top emission sweep (one timestep of reference
    ``emit``, `twostream.py:290-421`).

    Parameters
    ----------
    temps : (L,) layer temperatures, frozen during the sweep.
    F_up, F_down : (L, W) flux state carried across sweeps.
    k_all : (L, W) total opacity at (temps[i], pressures[i]) — hoisted
        ``kappa`` lookup including the scattering term.
    sigma_scat : (W,) Rayleigh scattering opacity.
    F_toa : (W,) top-of-atmosphere incident flux.
    lam_cm, trapz_w : (W,) wavelength grid and quadrature weights.
    pressures : (L,) layer pressures, BOA first [barye].
    """
    L = temps.shape[0]
    p = pressures
    # Swept layers i = 1 .. L-1 (`twostream.py:356`).
    T1 = temps[1:]
    p1 = p[1:]
    # Neighbor above; top layer uses the extrapolated pressure
    # p[-1]*p[-2]/p[-3] and its own temperature (`twostream.py:358-363`).
    p2 = jnp.concatenate([p[2:], (p[-1] * p[-2] / p[-3])[None]])
    T2 = jnp.concatenate([temps[2:], temps[-1:]])

    k = k_all[1:]
    dtau = physics.delta_tau(k, p1[:, None], p2[:, None], params.g)
    # Single-scattering albedo, Deitrick 2020 Eq. 17 as the reference
    # computes it — k already contains sigma (`twostream.py:376-378`).
    omega_0 = sigma_scat / (sigma_scat + k)

    # One Planck evaluation per layer: B1/B2 are shifted views of the
    # same per-layer radiances (T2 duplicates T1 rows), so evaluate
    # the transcendental once for all L layers and slice.
    B_all = planck_lambda(temps[:, None], lam_cm[None, :])
    B1 = B_all[1:]
    B2 = jnp.concatenate([B_all[2:], B_all[-1:]])
    cp = two_stream_couplers(dtau, omega_0, B1, B2, g_0=0.0)

    # Stale downward flux entering each layer top: F_down[i+1] for
    # i < L-1, F_TOA for the top layer (`twostream.py:379-382`).
    F2_down = jnp.concatenate([F_down[2:], F_toa[None, :]])

    # Affine recurrence for the upward flux (`twostream.py:383-393`):
    # F_up[i+1] = a_i F_up[i] + (-b_i F2_down_i + s_up_i), seeded with
    # the stale F_up[1].
    c = -cp.b * F2_down + cp.s_up
    z = _affine_prefix(cp.a, c, F_up[1], associative)   # z_i = F_2_up at i
    u = jnp.concatenate([F_up[1][None, :], z[:-1]])     # u_i = F_1_up at i

    F1_down = cp.a * F2_down - cp.b * u + cp.s_down

    # State updates: F_up[2:] <- z[:-1] (the top layer's outgoing flux
    # is computed but never stored, `twostream.py:392-393`);
    # F_down[1:] <- F1_down; rows 0 (and F_up[1]) untouched.
    F_up_new = jnp.concatenate([F_up[:2], z[:-1]])
    F_down_new = jnp.concatenate([F_down[:1], F1_down])

    # Temperature tendencies (`twostream.py:396-405`).
    bu2 = bolometric_flux(z, trapz_w)
    bd2 = bolometric_flux(F2_down, trapz_w)
    bu1 = bolometric_flux(u, trapz_w)
    bd1 = bolometric_flux(F1_down, trapz_w)
    div, dz = physics.div_bol_net_flux(bu2, bd2, bu1, bd1,
                                       T1, T2, p1, p2, params)
    dt = physics.radiative_timestep(T1, T2, p1, p2, div, dz, params)
    dT_swept = physics.delta_temperature(div, dt, T1, p1, p2, params)
    dT = jnp.concatenate([jnp.zeros_like(temps[:1]), dT_swept])

    dtaus = jnp.concatenate([jnp.ones_like(dtau[:1]), dtau])
    return SweepResult(F_up_new, F_down_new, temps - dT, dT, dtaus)


def absorb_sweep(
    temps, F_up, F_down, k_all, sigma_scat, F_toa,
    lam_cm, trapz_w, pressures, params: PhysicsParams,
    associative: bool = False,
) -> SweepResult:
    """One top-to-bottom absorption sweep (one timestep of reference
    ``absorb``, `twostream.py:424-550`).

    Sweeps layers i = L-2 .. 0 propagating the downward flux as the
    affine recurrence ``F_down[i] = a_i F_down[i+1] + c_i``, with the
    stale upward flux array entering through ``c_i``
    (`twostream.py:491-522`).
    """
    del F_toa  # enters only through the caller-maintained F_down state
    L = temps.shape[0]
    p = pressures
    # Swept layers i = 0 .. L-2.
    T1 = temps[:-1]
    T2 = temps[1:]
    p1 = p[:-1]
    p2 = p[1:]

    k = k_all[:-1]
    dtau = physics.delta_tau(k, p1[:, None], p2[:, None], params.g)
    omega_0 = sigma_scat / (sigma_scat + k)

    # One Planck evaluation per layer (see emit_sweep).
    B_all = planck_lambda(temps[:, None], lam_cm[None, :])
    B1 = B_all[:-1]
    B2 = B_all[1:]
    cp = two_stream_couplers(dtau, omega_0, B1, B2, g_0=0.0)

    F1_up_stale = F_up[:-1]
    c = -cp.b * F1_up_stale + cp.s_down
    # Downward recurrence, seeded with the stale F_down[L-1]: solve as a
    # forward prefix scan on the layer-reversed sequence, then flip back.
    d = jnp.flip(
        _affine_prefix(jnp.flip(cp.a, 0), jnp.flip(c, 0), F_down[-1],
                       associative),
        0,
    )                                                    # d_i = F_1_down at i
    d_next = jnp.concatenate([d[1:], F_down[-1][None, :]])  # F_2_down at i

    F2_up = cp.a * F1_up_stale - cp.b * d_next + cp.s_up

    # State updates: F_down[:-1] <- d (top row L-1 untouched);
    # F_up[1:] <- F2_up (bottom row 0 untouched), `twostream.py:521-522`.
    F_down_new = jnp.concatenate([d, F_down[-1:]])
    F_up_new = jnp.concatenate([F_up[:1], F2_up])

    bu2 = bolometric_flux(F2_up, trapz_w)
    bd2 = bolometric_flux(d_next, trapz_w)
    bu1 = bolometric_flux(F1_up_stale, trapz_w)
    bd1 = bolometric_flux(d, trapz_w)
    div, dz = physics.div_bol_net_flux(bu2, bd2, bu1, bd1,
                                       T1, T2, p1, p2, params)
    dt = physics.radiative_timestep(T1, T2, p1, p2, div, dz, params)
    dT_swept = physics.delta_temperature(div, dt, T1, p1, p2, params)
    dT = jnp.concatenate([dT_swept, jnp.zeros_like(temps[:1])])

    # dtau rows in sweep order (top-down), after the seed row of ones
    # (`twostream.py:487,505`).
    dtaus = jnp.concatenate([jnp.ones_like(dtau[:1]), jnp.flip(dtau, 0)])
    return SweepResult(F_up_new, F_down_new, temps - dT, dT, dtaus)
