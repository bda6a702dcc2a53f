"""The one place the hot-loop kappa model is wired.

Every solver entry point (``api.Grid._build_solver_inputs`` and
``parallel.solve_ensemble``) needs the same closure stack:
layer-factored opacity tables plus the hot-loop chemistry evaluator.
This module is the single definition; tests/test_hotpath.py asserts
that every entry point routes through it.

Replaces the reference's per-call ``kappa`` recomputation
(`frei/opacity.py:219-254`), which re-runs FastChem and re-interpolates
the (T, P) grids inside every sweep.
"""

from __future__ import annotations

from ..chemistry.fastchem import hot_loop_mmr_fn
from .tables import (OpacityStack, kappa_from_layer_tables, kappa_from_stack,
                     make_layer_tables)

__all__ = ["build_kappa_model"]


def build_kappa_model(stack: OpacityStack, chem, pressures, sigma_scat):
    """Build ``kappa_all(temps, pressures) -> (L, W)`` for the RC loop.

    Multi-T-point stacks get the layer-factored fast path: the
    P-interpolation is hoisted onto the fixed layer pressure grid once
    (:func:`make_layer_tables`) and chemistry becomes a gather-free
    one-hot T-contraction when the model supports it
    (:func:`hot_loop_mmr_fn`).  Single-T-point stacks (no T axis to
    factor) use the generic ``kappa_from_stack`` path.
    """
    if stack.values.shape[1] > 1:
        lt = make_layer_tables(stack, pressures)
        mmr_fn = hot_loop_mmr_fn(chem, pressures)

        def kappa_all(temps, pressures_in):
            del pressures_in  # fixed to the layer grid by design
            k, _ = kappa_from_layer_tables(lt, mmr_fn(temps), temps,
                                           sigma_scat)
            return k
        return kappa_all

    def kappa_all(temps, pressures_in):
        mmr = chem.mmr(temps, pressures_in)
        k, _ = kappa_from_stack(stack, mmr, temps, pressures_in,
                                sigma_scat)
        return k
    return kappa_all
