"""Resort-rebin kernels vs a literal numpy transcription of the
reference's numba Trapz semantics (`frei/interp.py:174-194`)."""

import jax.numpy as jnp
import numpy as np
import pytest

from frei_tpu.ops.rebin import bin_codes, reference_bin_scaling, resort_rebin


def trapz_in_bins_oracle(values, x, edges):
    """Loop transcription: right-closed pd.cut bins; a trapezoid panel
    counts only when both samples share a bin; empty bins are 0."""
    n_bins = len(edges) - 1
    codes = np.full(x.shape, -1, dtype=int)
    for k in range(n_bins):
        codes[(x > edges[k]) & (x <= edges[k + 1])] = k
    out = np.zeros(values.shape[:-1] + (n_bins,))
    for i in range(len(x) - 1):
        if codes[i] >= 0 and codes[i] == codes[i + 1]:
            out[..., codes[i]] += (
                (values[..., i] + values[..., i + 1]) / 2
                * (x[i + 1] - x[i]))
    return out


@pytest.fixture(scope="module")
def problem():
    rng = np.random.RandomState(5)
    n_hr, n_bins = 4001, 37
    x = np.sort(rng.uniform(0.5, 10.0, n_hr))
    edges = np.logspace(np.log10(0.48), np.log10(10.2), n_bins + 1)
    values = rng.lognormal(0.0, 2.0, (6, n_hr))
    return x, edges, values


def test_bin_codes_right_closed(problem):
    x, edges, _ = problem
    codes = np.asarray(bin_codes(jnp.asarray(x), jnp.asarray(edges)))
    # exactly on an inner edge -> lower bin (right-closed)
    c = np.asarray(bin_codes(jnp.asarray(edges[3]), jnp.asarray(edges)))
    assert c == 2
    # below the first edge or above the last -> -1
    assert np.asarray(bin_codes(jnp.asarray(edges[0]),
                                jnp.asarray(edges))) == -1
    assert np.asarray(bin_codes(jnp.asarray(edges[-1] + 1.0),
                                jnp.asarray(edges))) == -1
    assert codes.min() >= 0 and codes.max() == len(edges) - 2


def test_resort_rebin_matches_oracle(problem):
    x, edges, values = problem
    want = trapz_in_bins_oracle(values, x, edges)
    got = np.asarray(resort_rebin(jnp.asarray(values), jnp.asarray(x),
                                  jnp.asarray(edges)))
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_empty_bins_are_zero():
    x = np.array([1.0, 1.1, 5.0, 5.1])
    edges = np.array([0.5, 2.0, 3.0, 6.0])
    got = np.asarray(resort_rebin(jnp.asarray(x * 0 + 2.0),
                                  jnp.asarray(x), jnp.asarray(edges)))
    assert got[1] == 0.0          # bin (2, 3] has no samples
    np.testing.assert_allclose(got[0], 2.0 * 0.1)
    np.testing.assert_allclose(got[2], 2.0 * 0.1, rtol=1e-12)


def test_reference_scaling(problem):
    x, edges, values = problem
    binned = resort_rebin(jnp.asarray(values), jnp.asarray(x),
                          jnp.asarray(edges))
    scaled = np.asarray(reference_bin_scaling(binned, jnp.asarray(edges)))
    width = edges[1:] - edges[:-1]
    np.testing.assert_allclose(scaled, np.asarray(binned) * width * 1e-3,
                               rtol=1e-12)


def test_resort_rebin_ragged_sizes():
    """Ragged sizes (odd rows and samples, edges past both ends of the
    samples) match the loop oracle in float32."""
    rng = np.random.RandomState(9)
    x = np.sort(rng.uniform(0.0, 1.0, 777))
    edges = np.linspace(-0.01, 1.01, 12)
    values = rng.uniform(0, 1, (3, 777))
    want = trapz_in_bins_oracle(values, x, edges)
    got = np.asarray(resort_rebin(
        jnp.asarray(values, jnp.float32), jnp.asarray(x),
        jnp.asarray(edges)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("op", ["sum", "mean", "max", "min", "count"])
def test_grouped_aggregate_ops(op):
    """Generic aggregation matches a per-bin numpy loop (the
    reference's numpy_groupies surface, `interp.py:223-243`)."""
    from frei_tpu.ops.rebin import grouped_aggregate

    rng = np.random.RandomState(5)
    x = np.sort(rng.uniform(0.0, 10.0, 300))
    edges = np.linspace(-1.0, 11.0, 14)   # includes empty end bins
    vals = rng.randn(2, 300)
    got = np.asarray(grouped_aggregate(
        jnp.asarray(vals), jnp.asarray(x), jnp.asarray(edges), op=op,
        fill=0.0))
    fns = {"sum": np.sum, "mean": np.mean, "max": np.max,
           "min": np.min, "count": len}
    want = np.zeros((2, 13))
    for k in range(13):
        m = (x > edges[k]) & (x <= edges[k + 1])
        if m.any():
            for b in range(2):
                want[b, k] = fns[op](vals[b, m]) if op != "count" \
                    else float(m.sum())
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


def test_grouped_aggregate_trapz_alias():
    from frei_tpu.ops.rebin import grouped_aggregate, resort_rebin

    rng = np.random.RandomState(6)
    x = np.linspace(0.5, 10.0, 500)
    edges = np.geomspace(0.5, 10.0, 21)
    vals = rng.rand(3, 500)
    a = grouped_aggregate(jnp.asarray(vals), jnp.asarray(x),
                          jnp.asarray(edges), op="trapz")
    b = resort_rebin(jnp.asarray(vals), jnp.asarray(x),
                     jnp.asarray(edges))
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.slow   # opt-in negative-result engine (docs/opacities.md)
def test_matmul_engine_matches_oracle(problem):
    """The block-banded matmul formulation (static x/edges -> scan of
    dense per-tile dots, ops/rebin_matmul.py) against the float64
    transcription oracle — float64 input must match to summation
    order, float32 to rounding."""
    from frei_tpu.ops.rebin_matmul import make_resort_rebin_matmul

    x, edges, values = problem
    want = trapz_in_bins_oracle(values, x, edges)
    fn = make_resort_rebin_matmul(x, edges)
    got64 = np.asarray(fn(jnp.asarray(values, jnp.float64)))
    got32 = np.asarray(fn(jnp.asarray(values, jnp.float32)))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got64, want, rtol=1e-10,
                               atol=1e-10 * scale)
    np.testing.assert_allclose(got32, want, rtol=2e-5,
                               atol=2e-5 * scale)


@pytest.mark.slow   # opt-in negative-result engine (docs/opacities.md)
def test_matmul_engine_small_tiles(problem):
    """Forcing many tiles (tile smaller than a bin's sample count)
    exercises the cross-tile partial-bin accumulation: a bin split
    across tiles must still sum exactly once per panel."""
    from frei_tpu.ops.rebin_matmul import make_resort_rebin_matmul

    x, edges, values = problem
    want = np.asarray(resort_rebin(
        jnp.asarray(values, jnp.float64), jnp.asarray(x),
        jnp.asarray(edges)))
    fn = make_resort_rebin_matmul(x, edges, tile=512)
    got = np.asarray(fn(jnp.asarray(values, jnp.float64)))
    np.testing.assert_allclose(got, want, rtol=1e-10,
                               atol=1e-10 * np.abs(want).max())


@pytest.mark.slow   # opt-in negative-result engine (docs/opacities.md)
def test_matmul_engine_degenerate_cases():
    from frei_tpu.ops.rebin_matmul import make_resort_rebin_matmul

    # every sample outside the bins -> exact zeros
    fn = make_resort_rebin_matmul(np.linspace(100.0, 101.0, 64),
                                  np.geomspace(0.5, 10.0, 11))
    assert np.asarray(fn(jnp.ones((2, 64)))).sum() == 0.0
    # N not a multiple of the tile; samples straddling the edges
    rng = np.random.RandomState(3)
    x = np.sort(rng.uniform(0.0, 12.0, 1013))
    edges = np.geomspace(0.5, 10.0, 8)
    vals = rng.rand(3, 1013)
    want = np.asarray(resort_rebin(
        jnp.asarray(vals, jnp.float64), jnp.asarray(x),
        jnp.asarray(edges)))
    got = np.asarray(make_resort_rebin_matmul(x, edges, tile=512)(
        jnp.asarray(vals, jnp.float64)))
    np.testing.assert_allclose(got, want, rtol=1e-10,
                               atol=1e-10 * max(np.abs(want).max(), 1e-30))


@pytest.mark.slow   # opt-in negative-result engine (docs/opacities.md)
def test_matmul_engine_auto_tile_bounds_span():
    """Log-spaced edges over linearly-spaced samples give very few
    samples per bin at short wavelengths; the factory must shrink its
    tile until the padded per-tile bin span is bounded (<= 640 incl.
    the 128-lane rounding) instead of paying a huge dense-matmul pad,
    and stay exact while doing it."""
    from frei_tpu.ops.rebin_matmul import make_resort_rebin_matmul

    rng = np.random.RandomState(9)
    x = np.linspace(0.5, 10.0, 20000)
    edges = np.geomspace(0.5, 10.0, 1001)
    fn = make_resort_rebin_matmul(x, edges)
    assert fn.span_pad <= 640, (fn.tile, fn.span_pad)
    vals = rng.rand(3, 20000)
    want = np.asarray(resort_rebin(
        jnp.asarray(vals, jnp.float64), jnp.asarray(x),
        jnp.asarray(edges)))
    got = np.asarray(fn(jnp.asarray(vals, jnp.float64)))
    np.testing.assert_allclose(got, want, rtol=1e-10,
                               atol=1e-10 * np.abs(want).max())


def test_float32_coordinates_use_host_codes():
    """An interior sample within a float32 ulp of a bin edge is
    misassigned (or its panel dropped) when bin codes and panel widths
    come from downcast device coordinates; the ETL precomputes both on
    the float64 host grid (round-4 review; `ops.rebin.bin_codes_np`).
    Also pins that segment ids are NOT flagged sorted: the parked
    out-of-band panels interleave with in-order codes."""
    from frei_tpu.ops.rebin import bin_codes_np

    edges = np.array([1.0, 1.0 + 5e-8, 2.0], np.float64)
    x = np.array([0.9, 1.0 + 1e-8, 1.0 + 4e-8, 1.5, 1.9], np.float64)
    vals = np.ones((1, 5), np.float32)
    want = np.asarray(resort_rebin(jnp.asarray(vals, jnp.float64),
                                   jnp.asarray(x), jnp.asarray(edges)))
    assert want[0, 0] > 0      # the sub-ulp bin really has a panel
    got = np.asarray(resort_rebin(
        jnp.asarray(vals), jnp.asarray(x, jnp.float32),
        jnp.asarray(edges, jnp.float32),
        codes=jnp.asarray(bin_codes_np(x, edges)),
        dx=jnp.asarray(np.diff(x), jnp.float32)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # without host codes the float32 path cannot even see the bin
    f32 = np.asarray(resort_rebin(jnp.asarray(vals),
                                  jnp.asarray(x, jnp.float32),
                                  jnp.asarray(edges, jnp.float32)))
    assert f32[0, 0] == 0.0
