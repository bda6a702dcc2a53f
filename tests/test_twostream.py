"""Two-stream kernel: factored forms vs the literal published formulas.

The library implements the Malik 2017 / Deitrick 2020-2022 improved
two-stream scheme in an algebraically factored, float32-stable form
(see frei_tpu/ops/twostream.py).  Here we re-derive the *literal*
textbook expressions independently in float64 and verify both paths
agree, plus physical limit checks.
"""

import jax.numpy as jnp
import numpy as np

from frei_tpu.constants import hc_over_k, h, c
from frei_tpu.ops.planck import planck_lambda
from frei_tpu.ops.twostream import (e_correction, propagate_fluxes,
                                    two_stream_couplers)


def planck_np(T, lam):
    return 2 * h * c ** 2 / lam ** 5 / np.expm1(hc_over_k / (lam * T))


def literal_two_stream(F1_up, F2_down, B1, B2, dtau, w0, g0=0.0):
    """Direct transcription of Malik 2017 Eq. 12-15 / Deitrick 2020
    Eq. B2 / Deitrick 2022 Eq. B4, as published."""
    E = np.where(
        w0 > 0.1,
        1.225 - 0.1582 * g0 - 0.1777 * w0 - 0.07465 * g0 ** 2
        + 0.2351 * w0 * g0 - 0.05582 * w0 ** 2,
        1.0,
    )
    T = np.exp(-2 * np.sqrt(E * (E - w0) * (1 - w0 * g0)) * dtau)
    zp = 0.5 * (1 + np.sqrt((E - w0) / E / (1 - w0 * g0)))
    zm = 0.5 * (1 - np.sqrt((E - w0) / E / (1 - w0 * g0)))
    chi = zm ** 2 * T ** 2 - zp ** 2
    xi = zp * zm * (1 - T ** 2)
    psi = (zm ** 2 - zp ** 2) * T
    pi_t = np.pi * (1 - w0) / (E - w0)
    Bprime = (B1 - B2) / dtau
    F2_up = (1 / chi) * (
        psi * F1_up - xi * F2_down
        + pi_t * (B2 * (chi + xi) - psi * B1
                  + Bprime / (2 * E * (1 - w0 * g0)) * (chi - psi - xi))
    )
    F1_down = (1 / chi) * (
        psi * F2_down - xi * F1_up
        + pi_t * (B1 * (chi + xi) - psi * B2
                  + Bprime / (2 * E * (1 - w0 * g0)) * (xi + psi - chi))
    )
    return F2_up, F1_down


def test_factored_matches_literal_formulas():
    rng = np.random.RandomState(0)
    n = 4096
    dtau = 10 ** rng.uniform(-8, 3, n)
    w0 = rng.uniform(1e-6, 0.5, n)
    lam = 10 ** rng.uniform(np.log10(0.5e-4), np.log10(1e-3), n)
    T1 = rng.uniform(500, 5000, n)
    T2 = T1 * rng.uniform(0.9, 1.1, n)
    B1 = planck_np(T1, lam)
    B2 = planck_np(T2, lam)
    F1_up = rng.uniform(0, 1, n) * np.pi * B1
    F2_down = rng.uniform(0, 1, n) * np.pi * B2

    want_up, want_down = literal_two_stream(F1_up, F2_down, B1, B2, dtau, w0)
    got_up, got_down = propagate_fluxes(
        jnp.asarray(F1_up), jnp.asarray(F2_down),
        jnp.asarray(B1), jnp.asarray(B2),
        jnp.asarray(dtau), jnp.asarray(w0),
    )
    # The residual disagreement is dominated by the *literal* form's
    # catastrophic cancellation at small dtau (the factored form is the
    # accurate one there): tight tolerance away from that regime, loose
    # overall.
    thick = dtau > 1e-5
    np.testing.assert_allclose(got_up[thick], want_up[thick], rtol=2e-8)
    np.testing.assert_allclose(got_down[thick], want_down[thick], rtol=2e-8)
    np.testing.assert_allclose(got_up, want_up, rtol=5e-6)
    np.testing.assert_allclose(got_down, want_down, rtol=5e-6)


def test_e_correction_branches():
    assert float(e_correction(0.05, 0.0)) == 1.0
    w = 0.3
    expected = 1.225 - 0.1777 * w - 0.05582 * w ** 2
    np.testing.assert_allclose(float(e_correction(w, 0.0)), expected)


def test_thick_isothermal_limit():
    """Optically thick isothermal layer emits pi * B from both faces."""
    lam = 1e-4
    B = planck_np(2000.0, lam)
    F2_up, F1_down = propagate_fluxes(
        0.123 * B, 0.456 * B, B, B, delta_tau=1e4, omega_0=1e-12
    )
    np.testing.assert_allclose(float(F2_up), np.pi * B, rtol=1e-10)
    np.testing.assert_allclose(float(F1_down), np.pi * B, rtol=1e-10)


def test_thin_limit_transmits():
    """As dtau -> 0 the layer transmits incident fluxes unchanged."""
    lam = 1e-4
    B1 = planck_np(2100.0, lam)
    B2 = planck_np(1900.0, lam)
    F1_up, F2_down = 1.7e10, 0.8e10
    F2_up, F1_down = propagate_fluxes(
        F1_up, F2_down, B1, B2, delta_tau=1e-12, omega_0=1e-12
    )
    np.testing.assert_allclose(float(F2_up), F1_up, rtol=1e-6)
    np.testing.assert_allclose(float(F1_down), F2_down, rtol=1e-6)


def test_float32_thin_layer_no_nans():
    """The factored form survives float32 in regimes where the literal
    form would produce 0 * inf NaNs."""
    lam = jnp.float32(1e-4)
    B1 = planck_lambda(jnp.float32(2100.0), lam)
    B2 = planck_lambda(jnp.float32(1900.0), lam)
    for dtau in [1e-3, 1e-6, 1e-9, 1e-12, 1e-20]:
        F2_up, F1_down = propagate_fluxes(
            jnp.float32(1e10), jnp.float32(5e9), B1, B2,
            jnp.float32(dtau), jnp.float32(0.3),
        )
        assert np.isfinite(float(F2_up)) and np.isfinite(float(F1_down))


def test_couplers_energy_conservation_no_scattering():
    """With w0 -> 0 there is no reflection: b == 0 and a == T."""
    cp = two_stream_couplers(jnp.asarray(0.7), jnp.asarray(1e-14),
                             jnp.asarray(1e10), jnp.asarray(9e9))
    T = np.exp(-2 * 0.7)
    np.testing.assert_allclose(float(cp.a), T, rtol=1e-10)
    np.testing.assert_allclose(float(cp.b), 0.0, atol=1e-10)

