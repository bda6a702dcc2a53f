"""Resort-rebin: grouped trapezoid reduction of high-resolution opacity
onto the run's wavelength bins.

The reference implements this as a hand-rolled numba aggregation kernel
(`/root/reference/frei/interp.py:156-202`, registered into
numpy_groupies at `interp.py:223-243`) driven through pandas bin codes
and xarray ``apply_ufunc`` (`interp.py:270-307`), invoked per species in
``binned_opacity`` (`opacity.py:124-148`).  The semantics, preserved
exactly here:

* samples are assigned to right-closed bins ``(e_k, e_{k+1}]``
  (``pd.cut`` defaults, `interp.py:284`);
* adjacent sample pairs contribute a trapezoid panel ``(y_i + y_{i+1})
  / 2 * (x_{i+1} - x_i)`` only when BOTH samples fall in the same bin
  (`interp.py:181-192`) — panels straddling a bin edge are dropped;
* empty bins yield the fill value 0 (`interp.py:246-267`);
* the reference then multiplies by the bin width and 1e-3
  (`opacity.py:137-139`).

On the device this is a masked segment-sum over the pair axis — one
XLA op batched over the (T, P) table axes.  (NOT flagged
``indices_are_sorted``: dropped straddle panels are parked in the
out-of-range segment BETWEEN in-order codes, so the id sequence is
not sorted and the hint would let a scatter lowering misplace sums.)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["bin_codes", "resort_rebin", "reference_bin_scaling",
           "grouped_aggregate"]


def bin_codes(x, edges):
    """Right-closed bin codes: x in (edges[k], edges[k+1]] -> k;
    outside any bin -> -1.  Matches ``pd.cut`` (`interp.py:284-286`)."""
    x = jnp.asarray(x)
    edges = jnp.asarray(edges, x.dtype)
    idx = jnp.searchsorted(edges, x, side="left") - 1
    in_range = (x > edges[0]) & (x <= edges[-1])
    return jnp.where(in_range, idx, -1)


def bin_codes_np(x, edges):
    """Host float64 twin of :func:`bin_codes`.

    ETL precomputation: without x64 the device arrays are float32, and
    at line-list resolution (dx/x ~ 1e-6) float32 coordinates misplace
    samples that sit within ~1 ulp of a bin edge — bin ASSIGNMENT must
    be decided on the float64 host coordinates (as the native and
    matmul engines do) even when the summation runs in float32."""
    x = np.asarray(x, np.float64)
    edges = np.asarray(edges, np.float64)
    idx = np.searchsorted(edges, x, side="left") - 1
    return np.where((x > edges[0]) & (x <= edges[-1]), idx, -1)


def resort_rebin(values, x, edges, *, codes=None, dx=None):
    """Grouped trapezoid integral of ``values`` over ``x`` per bin.

    Parameters
    ----------
    values : (..., N) array
        High-resolution samples (leading axes batch over e.g. the
        (T, P) table grid).
    x : (N,) array
        Ascending sample coordinates.
    edges : (B + 1,) array
        Ascending bin edges.
    codes : optional precomputed :func:`bin_codes` of ``x`` (use
        :func:`bin_codes_np` when the device dtype is float32 and the
        coordinates are high-resolution — see its docstring).
    dx : optional precomputed panel widths ``diff(x)``.  Pass widths
        differenced in float64 on the host when ``x`` would be a
        float32 device array: ``fl32(x1) - fl32(x0)`` at line-list
        resolution carries up to ~10% relative error per panel, while
        ``fl32(x1 - x0)`` is exact to 1 ulp.

    Returns
    -------
    (..., B) array of per-bin trapezoid integrals (0 for empty bins).
    """
    values = jnp.asarray(values)
    x = jnp.asarray(x, values.dtype)
    n_bins = np.shape(edges)[0] - 1
    if codes is None:
        codes = bin_codes(x, edges)
    left = codes[:-1]
    same = (left == codes[1:]) & (left >= 0)
    dx = (x[1:] - x[:-1]) if dx is None else jnp.asarray(dx, values.dtype)
    panels = 0.5 * (values[..., :-1] + values[..., 1:]) * dx
    panels = jnp.where(same, panels, 0.0)
    seg = jnp.where(same, left, n_bins)  # park dropped panels out of range
    if panels.ndim == 1:
        out = jax.ops.segment_sum(panels, seg, num_segments=n_bins + 1)
        return out[:n_bins]
    return _batched_segsum(panels, seg, n_bins)


def _batched_segsum(panels, seg, n_bins):
    """segment_sum over the last axis with leading batch axes."""
    flat = panels.reshape(-1, panels.shape[-1])
    out = jax.vmap(
        lambda p: jax.ops.segment_sum(p, seg,
                                      num_segments=n_bins + 1)[:n_bins]
    )(flat)
    return out.reshape(panels.shape[:-1] + (n_bins,))


def reference_bin_scaling(binned, edges, dtype=None):
    """Apply the reference's post-rebin scaling: multiply the per-bin
    integral by the bin width and 1e-3 (`opacity.py:137-139`).  Kept as
    a separate step so the physically-plain per-bin *average*
    (integral / width) is also available."""
    edges = jnp.asarray(edges, binned.dtype if dtype is None else dtype)
    width = edges[1:] - edges[:-1]
    return binned * width * 1e-3


def grouped_aggregate(values, x, edges, op: str = "trapz", *,
                      codes=None, fill=0.0):
    """Generic grouped aggregation of samples into wavelength bins.

    The reference extends numpy_groupies with a custom trapezoid op so
    that ``trapz`` sits alongside the library's sum/mean/max/... table
    (`/root/reference/frei/interp.py:223-243`).  This is the same
    surface in XLA: one segment-reduction primitive parameterized by
    ``op`` in {"trapz", "sum", "mean", "max", "min", "count"}, batched
    over leading axes, jit/vmap friendly on every backend.

    ``trapz`` uses the pair-within-bin semantics of
    :func:`resort_rebin`; the others aggregate the per-sample values
    whose coordinate falls in the (right-closed) bin.  Empty bins get
    ``fill`` (the reference fills binned-average gaps afterwards,
    `opacity.py:60-63`).
    """
    if op == "trapz":
        return resort_rebin(values, x, edges, codes=codes)
    values = jnp.asarray(values)
    x = jnp.asarray(x, values.dtype)
    n_bins = np.shape(edges)[0] - 1
    if codes is None:
        codes = bin_codes(x, edges)
    valid = codes >= 0
    seg = jnp.where(valid, codes, n_bins)

    def reduce_last(vals, segsum_like, init):
        masked = jnp.where(valid, vals, init)
        flat = masked.reshape(-1, masked.shape[-1])
        out = jax.vmap(
            lambda p: segsum_like(p, seg, num_segments=n_bins + 1)[:n_bins]
        )(flat)
        return out.reshape(masked.shape[:-1] + (n_bins,))

    count = jax.ops.segment_sum(valid.astype(values.dtype), seg,
                                num_segments=n_bins + 1)[:n_bins]
    empty = count == 0
    if op == "count":
        return jnp.broadcast_to(count, values.shape[:-1] + (n_bins,))
    if op == "sum":
        out = reduce_last(values, jax.ops.segment_sum, 0.0)
    elif op == "mean":
        out = reduce_last(values, jax.ops.segment_sum, 0.0)
        out = out / jnp.maximum(count, 1.0)
    elif op == "max":
        out = reduce_last(values, jax.ops.segment_max,
                          jnp.asarray(-jnp.inf, values.dtype))
    elif op == "min":
        out = reduce_last(values, jax.ops.segment_min,
                          jnp.asarray(jnp.inf, values.dtype))
    else:
        raise ValueError(f"unknown aggregation op {op!r}")
    return jnp.where(empty, jnp.asarray(fill, out.dtype), out)
