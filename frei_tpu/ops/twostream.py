"""Improved two-stream radiative transfer kernel.

Implements the closed-form improved two-stream flux propagation of
Malik et al. (2017) Eq. 12-15 with the E-correction of Deitrick et
al. (2020) Eq. 19 and the up/down flux forms of Deitrick et al. (2022)
Appendix B — the same scheme as the reference ``propagate_fluxes``
(`/root/reference/frei/twostream.py:70-177`), re-derived in a
float32-stable factored form.

Stability: the reference evaluates the Planck-gradient source term as
``Bprime * (chi - psi - xi)`` with ``Bprime = (B1 - B2) / delta_tau``
(`twostream.py:158,161-176`).  For optically thin layers
(delta_tau -> 0) that is an inf * 0 product assembled from three
catastrophically cancelling terms.  Algebraically, with
``zeta_plus + zeta_minus == 1``,

    chi           = (zm*T - zp) * (zm*T + zp)
    chi + xi      = (zm - zp) * (zm*T^2 + zp)
    psi           = (zm - zp) * T
    chi - psi - xi = (T - 1) * (zm*T + zp)
    xi + psi - chi = (1 - T) * (zm*T + zp)

where ``T = exp(-2*k*delta_tau)`` is the transmission.  Substituting
``T - 1 = expm1(-2*k*delta_tau)`` removes the cancellation entirely and
lets the source term be computed as ``(B1-B2) * expm1(..)/delta_tau``,
which tends smoothly to ``-2k (B1-B2)`` in the thin limit.  These
factored forms are exactly equal to the reference expressions in real
arithmetic (property-tested in ``tests/test_twostream.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

__all__ = ["e_correction", "TwoStreamCouplers", "two_stream_couplers",
           "propagate_fluxes"]


def e_correction(omega_0, g_0):
    """Improved two-stream correction term E(omega_0, g_0).

    Deitrick et al. (2020) Eq. 19, matching the reference ``E``
    (`twostream.py:70-94`): a fitted polynomial for omega_0 > 0.1 and
    exactly 1 otherwise.
    """
    poly = (1.225 - 0.1582 * g_0 - 0.1777 * omega_0 - 0.07465 * g_0 ** 2
            + 0.2351 * omega_0 * g_0 - 0.05582 * omega_0 ** 2)
    return jnp.where(omega_0 > 0.1, poly, 1.0)


class TwoStreamCouplers(NamedTuple):
    """Precomputed per-(layer, wavelength) two-stream coupling terms.

    With these, both sweep directions become affine maps in the incoming
    fluxes:

        F_2_up   = a * F_1_up   - b * F_2_down + s_up
        F_1_down = a * F_2_down - b * F_1_up   + s_down

    where ``a = psi / chi`` and ``b = xi / chi`` — the form exploited by
    the associative layer scan in ``frei_tpu.rt.sweeps``.
    """

    a: jnp.ndarray        # psi / chi: transmission-like coupling
    b: jnp.ndarray        # xi / chi: reflection-like coupling
    s_up: jnp.ndarray     # upward thermal source term [flux]
    s_down: jnp.ndarray   # downward thermal source term [flux]


def two_stream_couplers(delta_tau, omega_0, B1, B2, g_0=0.0):
    """Compute the affine two-stream couplers for a set of layers.

    Parameters
    ----------
    delta_tau : array
        Layer optical depth (Malik 2017 Eq. 19), > 0.
    omega_0 : array
        Single-scattering albedo (Deitrick 2020 Eq. 17).
    B1, B2 : array
        Planck radiance at the layer bottom (1) and top (2) interfaces.
    g_0 : array or float
        Scattering asymmetry parameter (reference always passes 0,
        `twostream.py:389,518`).

    Notes
    -----
    Follows `twostream.py:139-176`:

    * transmission ``T = exp(-2 sqrt(E (E - w0) (1 - w0 g0)) dtau)``
      (Deitrick 2020 Eq. B2, `twostream.py:139-140`),
    * ``zeta_pm = (1 +- sqrt((E - w0) / E / (1 - w0 g0))) / 2``
      (Malik 2017 Eq. 13, `twostream.py:143-146`),
    * couplers chi/xi/psi/pi (Malik 2017 Eq. 12, `twostream.py:149-152`)
      in the factored form derived in the module docstring,
    * linear-in-tau Planck source ``Bprime = (B1 - B2) / dtau``
      (Malik 2017 Eq. 5, `twostream.py:158`) folded into s_up / s_down
      via the expm1 identity.
    """
    E = e_correction(omega_0, g_0)
    one_m_wg = 1.0 - omega_0 * g_0
    # sqrt argument is positive for omega_0 <= 1/2 (always true here:
    # omega_0 = sigma / (sigma + kappa_total) with kappa_total >= sigma).
    k_hat = jnp.sqrt(E * (E - omega_0) * one_m_wg)
    ratio = jnp.sqrt((E - omega_0) / (E * one_m_wg))
    zp = 0.5 * (1.0 + ratio)
    zm = 0.5 * (1.0 - ratio)

    em = jnp.expm1(-2.0 * k_hat * delta_tau)      # = T - 1, in (-1, 0]
    T = 1.0 + em                                   # transmission

    zmT_zp = zm * T + zp                           # zm*T + zp
    chi = (zm * T - zp) * zmT_zp                   # < 0 always
    psi = (zm - zp) * T
    chi_p_xi = (zm - zp) * (zm * T ** 2 + zp)      # chi + xi
    pi_term = jnp.pi * (1.0 - omega_0) / (E - omega_0)

    # Source terms (Deitrick 2022 Eq. B4, `twostream.py:161-176`):
    #   s_up_raw   = pi * (B2 (chi+xi) - psi B1 + Bp' * (chi-psi-xi))
    #   s_down_raw = pi * (B1 (chi+xi) - psi B2 + Bp' * (xi+psi-chi))
    # with Bp' = Bprime / (2 E (1 - w0 g0)).  Using
    # chi - psi - xi = em * zmT_zp, the gradient piece is
    #   (B1 - B2) * (em / dtau) * zmT_zp / (2 E (1 - w0 g0)).
    grad = (B1 - B2) * (em / delta_tau) * zmT_zp / (2.0 * E * one_m_wg)
    s_up_raw = pi_term * (B2 * chi_p_xi - psi * B1 + grad)
    s_down_raw = pi_term * (B1 * chi_p_xi - psi * B2 - grad)

    inv_chi = 1.0 / chi
    xi = chi_p_xi - chi
    return TwoStreamCouplers(
        a=psi * inv_chi,
        b=xi * inv_chi,
        s_up=s_up_raw * inv_chi,
        s_down=s_down_raw * inv_chi,
    )


def propagate_fluxes(F_1_up, F_2_down, B1, B2, delta_tau,
                     omega_0=0.0, g_0=0.0):
    """Propagate fluxes across one layer (reference-parity entry point).

    Drop-in functional equivalent of the reference ``propagate_fluxes``
    (`twostream.py:97-177`), but parameterized on the interface Planck
    radiances ``B1``/``B2`` instead of (lam, T_1, T_2) so callers can
    hoist the Planck evaluations.

    Returns
    -------
    F_2_up, F_1_down : arrays
        Flux leaving the layer top upward, and leaving the layer bottom
        downward.
    """
    cp = two_stream_couplers(delta_tau, omega_0, B1, B2, g_0)
    F_2_up = cp.a * F_1_up - cp.b * F_2_down + cp.s_up
    F_1_down = cp.a * F_2_down - cp.b * F_1_up + cp.s_down
    return F_2_up, F_1_down
