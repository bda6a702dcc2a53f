"""Block-banded matmul formulation of the resort-rebin.

**Opt-in engine, never chosen by "auto".**  It was built on the
premise that XLA's segment-sum scatter is slow; with sorted, dense bin
codes the segment-sum is not, and this engine is kept as a documented
negative result with its parity tests in the slow lane.  Whether it
beats the segment-sum on the GPU is not measured.

The reasoning: the reference's rebin
(`/root/reference/frei/interp.py:156-202`) is a scatter — each
trapezoid panel accumulates into its bin — and scatters often
serialize on accelerators.

But the scatter is an illusion of generality: in every real call the
sample coordinates ``x`` and the bin ``edges`` are fixed per
configuration (they come from the opacity store and the run's
wavelength grid), so the whole rebin is one STATIC linear map

    out[..., b] = sum_j W[j, b] * values[..., j]

where ``W`` has at most one nonzero per row: sample ``j`` contributes
``0.5 * (same_{j-1} dx_{j-1} + same_j dx_j)`` to its own bin
(both panels touching ``j`` live in ``j``'s bin whenever they count at
all — a panel is kept only if BOTH its samples share a bin).  Because
``x`` is ascending, ``W`` is block-banded: a contiguous run of samples
maps to a contiguous run of bins.  This module evaluates the map as a
``lax.scan`` of small dense matmuls — one (rows, K) @ (K, S) dot
per sample tile against an on-the-fly one-hot-times-weight slab, with
per-tile partial bins combined by static-offset adds.  No scatter
anywhere; the matrix unit does the aggregation.

Semantics are bit-compatible with :func:`frei_tpu.ops.rebin.
resort_rebin` up to float32 summation order (verified in
`tests/test_rebin.py` against the float64 numpy oracle).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["make_resort_rebin_matmul"]


def _host_weights(x, edges):
    """Static per-sample (bin, weight) of the trapezoid linear map."""
    x = np.asarray(x, np.float64)
    edges = np.asarray(edges, np.float64)
    # right-closed bins, as ops.rebin.bin_codes / pd.cut
    codes = np.searchsorted(edges, x, side="left") - 1
    codes[~((x > edges[0]) & (x <= edges[-1]))] = -1
    left = codes[:-1]
    same = (left == codes[1:]) & (left >= 0)
    dx = np.diff(x)
    panel_w = np.where(same, 0.5 * dx, 0.0)
    w = np.zeros_like(x)
    w[:-1] += panel_w
    w[1:] += panel_w
    seg = np.where(w > 0.0, codes, -1)
    return seg.astype(np.int32), w


def make_resort_rebin_matmul(x, edges, *, tile=None, span_pad=None):
    """Build a jittable ``fn(values (..., N)) -> (..., B)`` equal to
    ``resort_rebin(values, x, edges)`` for these STATIC ``x``/``edges``.

    Parameters
    ----------
    x : (N,) ascending sample coordinates (host/numpy; static).
    edges : (B + 1,) ascending bin edges (host/numpy; static).
    tile : samples per matmul tile.  Default: sized so a tile spans
        ~96 bins, clamped to [4096, 131072] and rounded to 512.
    span_pad : bins per tile (padded); default: the measured maximum
        span rounded up to a multiple of 128.

    Returns
    -------
    fn : callable mapping (..., N) float values to (..., B) per-bin
        trapezoid integrals (empty bins -> 0).  Pure jnp; safe to
        ``jax.jit`` and to close over in larger jitted programs (the
        precomputed weight/segment rows are small device constants).
    """
    seg, w = _host_weights(x, edges)
    n = seg.shape[0]
    n_bins = np.shape(edges)[0] - 1

    in_bin = seg >= 0
    if not in_bin.any():
        def all_empty(values):
            values = jnp.asarray(values)
            return jnp.zeros(values.shape[:-1] + (n_bins,), values.dtype)
        return all_empty

    def tiling(k):
        n_tiles = -(-n // k)
        seg_p = np.full(n_tiles * k, -1, np.int32)
        seg_p[:n] = seg
        seg_t = seg_p.reshape(n_tiles, k)
        # per-tile first bin; empty tiles borrow a neighbor (weights 0)
        b0 = np.array([r[r >= 0].min() if (r >= 0).any() else -1
                       for r in seg_t], np.int64)
        if (b0 < 0).any():
            fill = 0
            for t in range(n_tiles):
                fill = b0[t] = b0[t] if b0[t] >= 0 else fill
        span = np.array([r[r >= 0].max() - b
                         for r, b in zip(seg_t, b0)
                         if (r >= 0).any()]).max() + 1
        return seg_t, b0, int(span)

    if tile is None:
        per_bin = max(1, int(in_bin.sum()) // max(1, n_bins))
        tile = int(np.clip(96 * per_bin, 4096, 131072))
        tile = max(512, (tile // 512) * 512)
        seg_t, b0, span = tiling(tile)
        # non-uniform bin densities (e.g. log edges over linear x)
        # can blow up the padded span; shrink the tile until the
        # matmul padding is bounded
        while span > 512 and tile > 512:
            tile //= 2
            seg_t, b0, span = tiling(tile)
        if span > 512:
            # performance cliff, not a correctness issue: even the
            # minimum tile straddles many bins, so each tile becomes a
            # near-dense (tile x span_pad) matmul — surface it so ETL
            # runs can pick a different engine instead of crawling
            import warnings
            warnings.warn(
                f"rebin_matmul: per-tile bin span is {span} even at "
                f"the minimum tile ({tile} samples) — extremely "
                "non-uniform bin density for this x/edges pair; the "
                "block-banded matmul degrades toward dense. Consider "
                "engine='xla' or 'native' for this grid.", stacklevel=2)
    else:
        seg_t, b0, span = tiling(tile)
    n_tiles = seg_t.shape[0]
    n_pad = n_tiles * tile
    w_p = np.zeros(n_pad, np.float64)
    w_p[:n] = w
    if span_pad is None:
        span_pad = int(-(-span // 128) * 128)
    elif span > span_pad:
        raise ValueError(f"span_pad {span_pad} < measured span {span}")
    span_pad = min(span_pad, n_bins)

    seg_t_dev = jnp.asarray(seg_t)                        # (T, K)
    w_t_host = w_p.reshape(n_tiles, tile)
    b0_dev = jnp.asarray(b0, jnp.int32)                   # (T,)
    lane = jnp.arange(span_pad, dtype=jnp.int32)          # (S,)

    def fn(values):
        values = jnp.asarray(values)
        dt = values.dtype if jnp.issubdtype(values.dtype, jnp.inexact) \
            else jnp.float32
        batch = values.shape[:-1]
        v = values.reshape(-1, values.shape[-1]).astype(dt)
        v = jnp.pad(v, ((0, 0), (0, n_pad - n)))
        v = v.reshape(v.shape[0], n_tiles, tile)
        w_dev = jnp.asarray(w_t_host, dt)

        def step(acc, inp):
            vt, st, wt, bt = inp
            onehot = jnp.where(st[:, None] == bt + lane[None, :],
                               wt[:, None], 0.0)           # (K, S)
            part = jax.lax.dot_general(
                vt, onehot, (((1,), (0,)), ((), ())),
                precision=jax.lax.Precision.HIGHEST,
                preferred_element_type=dt)                 # (R, S)
            z = jnp.zeros((), bt.dtype)
            upd = jax.lax.dynamic_slice(
                acc, (z, bt), (acc.shape[0], span_pad)) + part
            return jax.lax.dynamic_update_slice(acc, upd, (z, bt)), None

        acc0 = jnp.zeros((v.shape[0], n_bins + span_pad), dt)
        acc, _ = jax.lax.scan(
            step, acc0,
            (jnp.moveaxis(v, 1, 0), seg_t_dev, w_dev, b0_dev))
        return acc[:, :n_bins].reshape(batch + (n_bins,))

    # introspection for tests / tuning
    fn.tile = tile
    fn.span_pad = span_pad
    fn.n_tiles = n_tiles
    return fn
