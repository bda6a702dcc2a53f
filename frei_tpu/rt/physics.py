"""Radiative-convective time-step physics, branch-free and batched.

Unitless-CGS, jittable equivalents of the per-layer scalar helpers in
`/root/reference/frei/twostream.py:16-287` (Malik et al. 2017
Eqs. 18-28).  The reference evaluates these one layer at a time on
astropy Quantities with Python ``if`` branches on quantity signs
(`twostream.py:32-43,285-287`); here every function is elementwise over
whole (layers,) or (columns, layers) arrays with the branches as
``jnp.where`` selects — required for jit and for the batched
solver.  All formulas are numerically identical for the same
inputs.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from .. import constants as const

__all__ = ["PhysicsParams", "c_p", "delta_z", "delta_tau", "rho_p",
           "gamma_lapse", "gamma_adiabatic", "delta_gamma",
           "mixing_length", "convective_flux", "div_bol_net_flux",
           "radiative_timestep", "delta_temperature"]


class PhysicsParams(NamedTuple):
    """Static physical parameters of one column (CGS floats).

    Mirrors the reference's keyword defaults: ``m_bar = 2.4 m_p``,
    ``n_dof = 5``, ``alpha = 1`` (`twostream.py:23,98,291-293`).
    """

    g: float = const.g_jup            # surface gravity [cm / s^2]
    m_bar: float = 2.4 * const.m_p    # mean molecular weight [g]
    alpha: float = 1.0                # mixing-length scale heights
    n_dof: int = 5                    # molecular degrees of freedom


def c_p(params: PhysicsParams):
    """Specific heat capacity (Malik Eq. 25, `twostream.py:220-224`)."""
    return (2.0 + params.n_dof) / (2.0 * params.m_bar) * const.k_B


def delta_z(T_1, p_1, p_2, params: PhysicsParams):
    """Layer geometric thickness (Malik Eq. 18, `twostream.py:180-187`).

    Sequential divisions on purpose: forming ``m_bar * g`` first makes
    a ~1e-20 CGS product whose reverse-mode quotient rule squares it
    to ~1e-40 — the reciprocal overflows float32 and every gradient
    w.r.t. gravity came back inf (round-5 chip finding; value is the
    same expression in a different association, ~1-ulp)."""
    return (const.k_B * T_1 / params.m_bar) / params.g \
        * jnp.log(p_1 / p_2)


def delta_tau(kappa, p_1, p_2, g):
    """Layer optical depth (Malik Eq. 19, `twostream.py:227-231`)."""
    return (p_1 - p_2) / g * kappa


def rho_p(T_1, p_1, p_2, params: PhysicsParams):
    """Local mass density (`twostream.py:234-238`)."""
    return ((p_1 - p_2) / params.g) / delta_z(T_1, p_1, p_2, params)


def gamma_lapse(T_1, T_2, p_1, p_2, params: PhysicsParams):
    """Temperature lapse rate dT/dz (`twostream.py:241-250`)."""
    return (T_1 - T_2) / delta_z(T_1, p_1, p_2, params)


def gamma_adiabatic(params: PhysicsParams):
    """Adiabatic lapse rate g / c_p (`twostream.py:253-254`)."""
    return params.g / c_p(params)


def delta_gamma(T_1, T_2, p_1, p_2, params: PhysicsParams):
    """Super-adiabaticity gamma - gamma_ad (`twostream.py:257-266`)."""
    return gamma_lapse(T_1, T_2, p_1, p_2, params) - gamma_adiabatic(params)


def mixing_length(T_1, params: PhysicsParams):
    """Mixing length alpha * k_B T / (m_bar g) (`twostream.py:269-270`).

    Sequential divisions: same float32 gradient-overflow hazard as
    :func:`delta_z` (the ``m_bar * g`` product is ~1e-20 CGS)."""
    return params.alpha * (const.k_B * T_1 / params.m_bar) / params.g


def convective_flux(T_1, T_2, p_1, p_2, params: PhysicsParams):
    """Mixing-length convective flux, gated on super-adiabaticity.

    ``rho c_p l^2 sqrt(g / T) dgamma^1.5`` where ``dgamma > 0``, else 0
    (`twostream.py:273-287`).  The reference's Python ``if`` becomes a
    NaN-safe ``jnp.where`` (the 1.5-power is evaluated on a clamped
    argument so the dead branch never produces NaN gradients).

    Note: the reference returns this flux multiplied by one length unit
    (``flux_unit * u.cm``, `twostream.py:287`) because ``bolometric
    flux`` carries per-wavelength units; in unitless CGS the value is
    identical.
    """
    dg = delta_gamma(T_1, T_2, p_1, p_2, params)
    dg_safe = jnp.where(dg > 0, dg, 1.0)
    flux = (rho_p(T_1, p_1, p_2, params) * c_p(params)
            * mixing_length(T_1, params) ** 2
            * jnp.sqrt(params.g / T_1) * dg_safe ** 1.5)
    return jnp.where(dg > 0, flux, 0.0)


def div_bol_net_flux(F_2_up_bol, F_2_down_bol, F_1_up_bol, F_1_down_bol,
                     T_1, T_2, p_1, p_2, params: PhysicsParams):
    """Divergence of the bolometric net flux (Malik Eq. 23,
    `twostream.py:190-205`).

    Returns (div, dz).  The radiative piece is the net-flux difference
    across the layer; the convective piece is added before dividing by
    the layer thickness.
    """
    delta_F_rad = (F_2_up_bol - F_2_down_bol) - (F_1_up_bol - F_1_down_bol)
    delta_F_conv = convective_flux(T_1, T_2, p_1, p_2, params)
    dz = delta_z(T_1, p_1, p_2, params)
    return (delta_F_rad + delta_F_conv) / dz, dz


def radiative_timestep(T_1, T_2, p_1, p_2, div, dz, params: PhysicsParams):
    """Adaptive timestep (Malik Eqs. 27-28, `twostream.py:23-43`).

    * prefactor ``f = 1e5 / |div * dz|^0.9`` when the flux divergence is
      nonzero, else 1 (`twostream.py:32-35`);
    * radiative timestep ``c_p p_1 / (sigma_sb g T_1^3)``
      (`twostream.py:37`);
    * when the layer is super-adiabatic, take the min with the
      convective timestep ``sqrt(T_1 / (g dgamma))``
      (`twostream.py:39-43`).
    """
    dF_dz = div * dz
    # double-where: the untaken branch at dF_dz == 0 evaluates
    # 1e5 / 0**0.9 = inf, whose reverse-mode cotangent is NaN even
    # though the branch is masked (inf * 0).  Unreachable in float64
    # test shapes, but at float32 a near-converged layer lands on
    # exactly 0 and poisons every gradient upstream (measured:
    # non-finite retrieval gradients at the 20-iteration float32
    # headline shape until this guard).
    dF_safe = jnp.where(dF_dz != 0.0, dF_dz, 1.0)
    f_pre = jnp.where(dF_dz != 0.0,
                      1e5 / jnp.abs(dF_safe) ** 0.9,
                      1.0)
    dt_rad = c_p(params) * p_1 / (const.sigma_sb * params.g * T_1 ** 3)
    dg = delta_gamma(T_1, T_2, p_1, p_2, params)
    dg_safe = jnp.where(dg > 0, dg, 1.0)
    dt_conv = jnp.sqrt(T_1 / (params.g * dg_safe))
    dt = jnp.where(dg > 0, jnp.minimum(dt_rad, dt_conv), dt_rad)
    return f_pre * dt


def delta_temperature(div, dt, T_1, p_1, p_2, params: PhysicsParams):
    """Temperature update (Malik Eq. 24, `twostream.py:208-217`):
    ``div * dt / (rho c_p)``.

    The reference invokes this with its *default* mean molecular weight
    rather than the planet's (`twostream.py:403-405` omits ``m_bar``) —
    an inconsistency that is invisible for the default hot-Jupiter
    configuration (m_bar = 2.4 m_p).  frei_tpu uses the configured
    ``params.m_bar`` consistently.
    """
    return div * dt / (rho_p(T_1, p_1, p_2, params) * c_p(params))
