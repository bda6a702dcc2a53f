"""Device mesh construction and canonical shardings.

Scaling design (SURVEY.md section 7, BASELINE.json north star): the
solve is domain-decomposed over a 2-D logical mesh

    ('columns', 'bins')

* ``columns`` — batched atmospheric columns (retrieval / phase-curve
  ensembles).  Embarrassingly parallel: every per-column quantity is
  sharded on this axis and no collective ever crosses it.
* ``bins`` — spectral bins.  All per-wavelength physics is local; the
  ONLY cross-bin coupling in the entire solver is the bolometric
  integral entering the temperature tendency (the reference's
  ``np.trapz`` at `twostream.py:16-20,396-400`), which under GSPMD
  becomes a single psum of partial dot products per sweep.

The reference's only distribution mechanism was a vestigial, orphaned
dask path (`core.py:22-31`, `opacity.py:45-63`); this mesh replaces it
with jax.sharding + jit (XLA GSPMD inserts and schedules the
collectives).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "column_sharding", "replicated", "COLUMNS", "BINS"]

COLUMNS = "columns"
BINS = "bins"


def make_mesh(n_columns: Optional[int] = None, n_bins: int = 1,
              devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """Build a ('columns', 'bins') mesh over the available devices.

    Defaults to all devices on the columns axis (the right choice for
    large ensembles: zero-collective scaling).  Put devices on the
    bins axis only when a single column's spectral grid is too large
    or too slow per device.  The layout follows the algorithm alone:
    no device topology is assumed.
    """
    if devices is None:
        devices = jax.devices()
    devices = np.asarray(devices)
    if n_columns is None:
        n_columns = len(devices) // n_bins
    if n_columns * n_bins != len(devices):
        raise ValueError(
            f"mesh {n_columns} x {n_bins} != {len(devices)} devices"
        )
    return Mesh(devices.reshape(n_columns, n_bins), (COLUMNS, BINS))


def column_sharding(mesh: Mesh, *, batch_axis: bool = True,
                    bins_axis_index: Optional[int] = None) -> NamedSharding:
    """Sharding for an array with a leading columns axis and,
    optionally, a wavelength axis at ``bins_axis_index``."""
    ndim = 1 + (1 if bins_axis_index is not None else 0)
    spec = [None] * max(ndim, (bins_axis_index or 0) + 1)
    if batch_axis:
        spec[0] = COLUMNS
    if bins_axis_index is not None:
        spec[bins_axis_index] = BINS
    return NamedSharding(mesh, P(*spec))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
