"""Smoke test of the main path on one GPU, or on four with --four-cards.

Runs the batched radiative-convective solve through the public entry
points at the headline width -- hot-Jupiter configuration, 500 bins x
30 layers, float32, the synthetic opacity fixture, 8192 columns, 20
fixed RC iterations -- and checks every phase against a reference:

* golden:     ``Grid.emission_spectrum`` against the BASELINE.md goldens;
* headline:   ``Grid.emission_spectra`` (and the warm ``solve_rc_batched``
              it calls), sampled columns against the float64 numpy
              oracle ``MiniFrei`` (tests/reference_impl.py);
* population: ``parallel.solve_population`` (per-column F_toa / g /
              alpha), sampled columns against ``MiniFrei`` built with
              each column's own parameters;
* chemistry:  equilibrium chemistry in the loop, sampled columns against
              the same public solve in float64 on the CPU backend;
* gradient:   ``jax.value_and_grad`` through ``Grid.spectrum_fn``: the
              forward flux against the non-differentiable solve, the
              gradient of the sampled columns against a float64 CPU
              gradient of the same columns.

``--four-cards`` runs only the mesh paths -- ``solve_ensemble`` on a
(4, 1) and a (2, 2) mesh and ``solve_population`` on (4, 1) -- each
against a single-card ``solve_rc_batched`` of sampled columns.

Each phase prints one JSON line: compile time (first call minus warm
call), warm wall time, the process's peak device memory so far, and
each measured error beside its bound.  The last line is
``{"ok": true, "device": {...}}``.  With no GPU, or when any phase fails,
the script exits non-zero and prints no result line.

Usage::

    python chip_smoke.py                 # one GPU
    python chip_smoke.py --four-cards    # four GPUs of one host
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE / "tests"))          # reference_impl oracle

# Bounds against the float64 references.  Float32 solves of this fixed,
# unconverged horizon are chaotic in a few places: the adaptive timestep
# of the top layers and the convective switch amplify rounding, so a few
# cells and columns depart from float64 far more than the rest, and two
# float32 programs that round differently pick different ones.  On the
# H100 at 8192 columns each float32 program had about 3 columns whose
# flux departs from MiniFrei by 1e-4 to 3e-4 of peak, while the rest sit
# near 2e-6.  The bounds therefore sit on statistics that such a column
# does not move and that a precision fault does: a control run with the
# bolometric quadrature at the default precision (TF32 on the H100)
# breaks every one of them.
#
# Flux: max |dF| / peak |F| over the sampled columns.  Sound H100 runs
# read 1.5e-6 to 2.1e-6; the TF32 control read 2.7e-4.  (A chaotic
# column drawn into the sample would fail it too: about 3 in 8192.)
FLUX_BOUND = 1e-4
# Final temperatures, |dT| over the sampled (column, layer) pairs: the
# 95th percentile, and each layer's median over the columns, must stay
# within TEMP_BOUND_K; the top layer's median within TOP_LAYER_BOUND_K;
# the maximum is printed.  The 95th percentile cannot see a fault
# confined to one layer (3 % of the pairs); the per-layer median sees
# one that reaches most columns.  The top layer is the least resolved:
# in a CPU probe (256 columns, float32 against float64) about half its
# columns differed by more than 0.5 K, and medians of 8 columns reached
# 11 K; below it, no layer's 8-column median passed 0.2 K.  Sound H100
# runs read p95 0.02-0.14 K, layer medians up to 0.10 K and top-layer
# medians up to 0.56 K; the TF32 control read p95 3.0 K and a layer
# median of 3.5 K.
TEMP_BOUND_K = 0.5
TOP_LAYER_BOUND_K = 20.0
# Gradient: per sampled column, max |dG_c| / max |G| against a float64
# CPU gradient of the same columns.  The reverse pass through the
# chaotic columns is ill-conditioned: of 32 columns on the H100 the
# median read 2.5e-5, four read above 1e-3 and two near 0.04.  All but
# one column in eight must be within the bound (the 28th of 32 read
# 8.0e-4), so a fault that reaches more than one column in eight fails.
GRAD_BOUND = 5e-3
# BASELINE.md goldens of the quickstart (reference test_core.py).
GOLDEN_PEAK_UM = (1.1518, 0.02)
GOLDEN_PEAK_FLUX = (1.296e13, 0.1e13)
GOLDEN_TEFF_K = (2400.0, 200.0)


class Sizes(NamedTuple):
    columns: int = 8192
    bins: int = 500
    layers: int = 30
    iters: int = 20
    sample: int = 8
    grad_sample: int = 32


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def report(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_name_and_power_limit() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def fixed_horizon(sz: Sizes) -> dict:
    """Convergence exits disabled: every run does identical work."""
    return dict(n_timesteps=sz.iters, n_zero_crossings=10 ** 6,
                convergence_dT=0.0)


def make_grid(sz: Sizes, dtype, chemistry=None):
    from frei_tpu import Grid, Planet, load_example_opacity

    planet = Planet.from_hot_jupiter()
    grid = Grid(planet, n_wl_bins=sz.bins, n_layers=sz.layers,
                T_ref=2400.0, dtype=dtype)
    grid.load_opacities(opacities=load_example_opacity(
        grid, scale_factor=1.0, dtype=dtype), chemistry=chemistry)
    return planet, grid


def initial_temps(grid, n_columns, seed=0):
    rng = np.random.RandomState(seed)
    base = np.asarray(grid.rt_grid.init_temperatures, np.float64)
    return base[None, :] * rng.uniform(0.95, 1.05, (n_columns, 1))


def sample_columns(n_columns, n_sample, seed=7):
    rng = np.random.RandomState(seed)
    n = min(n_sample, n_columns)
    return np.sort(rng.choice(n_columns, n, replace=False))


def random_planets(n, seed=1):
    """Per-column irradiation, gravity and mixing length, as a
    retrieval or phase-curve population varies them."""
    from frei_tpu import Planet

    rng = np.random.RandomState(seed)
    return [Planet(a_rstar=float(a), m_bar=2.4, g=float(g),
                   T_star=float(t), alpha=float(al))
            for a, g, t, al in zip(rng.uniform(4.0, 9.0, n),
                                   rng.uniform(10.0, 50.0, n),
                                   rng.uniform(4500.0, 6300.0, n),
                                   rng.uniform(0.8, 1.5, n))]


def oracle_errors(sz: Sizes, planets, T0, flux, final_temps):
    """Deviation of sampled solver columns from the float64 numpy
    oracle, as :func:`compare` reports it.  ``planets[i]`` supplies
    column i's F_toa, g, alpha and m_bar; ``T0``, ``flux`` and
    ``final_temps`` hold the same columns."""
    return compare(flux, final_temps, *oracle_solve(sz, planets, T0))


def oracle_solve(sz: Sizes, planets, T0):
    """(flux, final temperatures) of the float64 numpy oracle
    ``MiniFrei`` for each column of ``T0``, with ``planets[i]``'s
    parameters, over the fixed horizon of ``sz``.

    The oracle reads the configuration's tables from a float64 grid.
    Fed a float32 grid's tables -- its pressure axis rounded, beside
    float64 layer pressures -- it moved the two bottom layers of half
    the headline's sampled columns by up to 8 K, while the float32
    solver, consistent with its own rounded tables, stayed within
    0.01 K of the float64 solve there."""
    import jax.numpy as jnp

    from frei_tpu.constants import u_amu
    from frei_tpu.opacity.rayleigh import rayleigh_total
    from frei_tpu.stellar.irradiation import f_toa_np
    from reference_impl import MiniFrei

    with cpu64():
        _, grid = make_grid(sz, jnp.float64)
    lam_cm = np.asarray(grid.rt_grid.lam_cm, np.float64)
    stack = grid.opacities
    k_table = np.asarray(stack.values, np.float64)[0]
    f_ref, t_ref = [], []
    for c, p in enumerate(planets):
        mini = MiniFrei(
            lam_cm=lam_cm, pressures_cgs=grid.rt_grid.pressures_cgs,
            k_table=k_table,
            temps_axis=np.asarray(stack.temps, np.float64),
            press_axis_cgs=np.asarray(stack.press_cgs, np.float64),
            mmr=1.5e-3 * 18.0 * u_amu / p.m_bar,
            sigma_scat=rayleigh_total(lam_cm, p.m_bar),
            F_toa=f_toa_np(lam_cm, p.T_star, p.a_rstar),
            g=p.g, m_bar=p.m_bar, alpha=p.alpha)
        F, T = mini.emission_spectrum(
            np.asarray(T0[c], np.float64), n_timesteps=sz.iters,
            n_zero_crossings=10 ** 6, convergence_dT=0.0)[:2]
        f_ref.append(F)
        t_ref.append(T)
    return np.stack(f_ref), np.stack(t_ref)


def column_flux_errors(flux, flux_ref):
    """Per column: max |dF_c| / peak |F_ref| over all columns given."""
    flux_ref = np.asarray(flux_ref, np.float64)
    return (np.max(np.abs(np.asarray(flux, np.float64) - flux_ref), axis=1)
            / np.max(np.abs(flux_ref)))


def compare(flux, temps, flux_ref, temps_ref) -> dict:
    """Flux and final-temperature deviations of sampled columns from a
    reference solve of the same columns (see the bounds above)."""
    dT = np.abs(np.asarray(temps, np.float64)
                - np.asarray(temps_ref, np.float64))
    layer_median = np.median(dT, axis=0)
    return {"flux_err": float(np.max(column_flux_errors(flux, flux_ref))),
            "temp_p95_K": float(np.percentile(dT, 95)),
            "temp_layer_median_K": float(np.max(layer_median[:-1])),
            "temp_top_median_K": float(layer_median[-1]),
            "temp_max_K": float(np.max(dT))}


def within_bounds(errs) -> bool:
    return (errs["flux_err"] <= FLUX_BOUND
            and errs["temp_p95_K"] <= TEMP_BOUND_K
            and errs["temp_layer_median_K"] <= TEMP_BOUND_K
            and errs["temp_top_median_K"] <= TOP_LAYER_BOUND_K)


BOUNDS = {"flux_bound": FLUX_BOUND, "temp_bound_K": TEMP_BOUND_K,
          "top_layer_bound_K": TOP_LAYER_BOUND_K}


def timed(fn, repeats=2):
    """(result, first-call seconds, best warm-call seconds), each call
    ending in ``block_until_ready``."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    warm = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        warm = min(warm, time.perf_counter() - t0)
    return out, first, warm


def peak_gb(devices):
    """Process peak device memory so far [GB], per device."""
    return [round(d.memory_stats()["peak_bytes_in_use"] / 1e9, 3)
            for d in devices]


def cpu64():
    """Context for the float64 references: 64-bit types on the
    in-process CPU backend."""
    import contextlib

    import jax

    stack = contextlib.ExitStack()
    stack.enter_context(jax.enable_x64(True))
    stack.enter_context(jax.default_device(jax.devices("cpu")[0]))
    return stack


# --------------------------------------------------------------------------
# one-card phases
# --------------------------------------------------------------------------

def phase_golden(sz: Sizes, dev):
    import jax.numpy as jnp

    from frei_tpu import effective_temperature

    _, grid = make_grid(sz, jnp.float32)
    (spec, temps, _, dtaus), first, warm = timed(
        lambda: grid.emission_spectrum(n_timesteps=1))
    i = int(np.argmax(spec.flux_cgs))
    peak_um = float(spec.wavelength_um[i])
    peak_flux = float(spec.flux_cgs[i])
    teff = float(effective_temperature(grid, spec, dtaus, temps))
    on_device = sorted({d.platform for d in grid.last_result.flux.devices()})
    report("golden", compile_s=first - warm, warm_s=warm,
           peak_gb=peak_gb([dev]), peak_um=peak_um,
           peak_um_bound=GOLDEN_PEAK_UM, peak_flux=peak_flux,
           peak_flux_bound=GOLDEN_PEAK_FLUX, T_eff_K=teff,
           T_eff_bound_K=GOLDEN_TEFF_K, result_platforms=on_device)
    check(abs(peak_um - GOLDEN_PEAK_UM[0]) <= GOLDEN_PEAK_UM[1],
          f"golden peak wavelength {peak_um}")
    check(abs(peak_flux - GOLDEN_PEAK_FLUX[0]) <= GOLDEN_PEAK_FLUX[1],
          f"golden peak flux {peak_flux}")
    check(abs(teff - GOLDEN_TEFF_K[0]) <= GOLDEN_TEFF_K[1],
          f"golden T_eff {teff}")
    check(on_device == [dev.platform],
          f"result arrays on {on_device}, not on {dev.platform}")


def phase_headline(sz: Sizes, dev):
    import jax.numpy as jnp

    from frei_tpu.rt.solver import SolverConfig, solve_rc_batched

    planet, grid = make_grid(sz, jnp.float32)
    T0 = initial_temps(grid, sz.columns)
    kw = fixed_horizon(sz)
    (spec, temps, _, _), first, warm = timed(
        lambda: grid.emission_spectra(T0, **kw))
    # the compiled solve the call above ran, without its host copies
    T0_d = jnp.asarray(T0, jnp.float32)
    _, _, solve_s = timed(lambda: solve_rc_batched(
        T0_d, grid._consts, planet.physics_params(), grid._kappa_fn,
        SolverConfig(**kw)).flux, repeats=3)
    check(spec.flux_cgs.shape == (sz.columns, sz.bins),
          f"flux shape {spec.flux_cgs.shape}")
    check(np.all(np.isfinite(spec.flux_cgs)), "non-finite flux")
    s = sample_columns(sz.columns, sz.sample)
    errs = oracle_errors(sz, [planet] * len(s), T0[s], spec.flux_cgs[s],
                         temps[s])
    report("headline", columns=sz.columns, bins=sz.bins,
           layers=sz.layers, iters=sz.iters, compile_s=first - warm,
           warm_s=warm, solve_s=solve_s,
           columns_bins_per_s=sz.columns * sz.bins / solve_s,
           peak_gb=peak_gb([dev]), sampled=s.tolist(), **errs, **BOUNDS)
    check(within_bounds(errs), "headline outside the oracle bounds")
    return T0, spec.flux_cgs


def phase_population(sz: Sizes, dev):
    import jax.numpy as jnp

    from frei_tpu.parallel import solve_population
    from frei_tpu.rt.solver import SolverConfig

    _, grid = make_grid(sz, jnp.float32)
    T0 = initial_temps(grid, sz.columns)
    planets = random_planets(sz.columns)
    cfg = SolverConfig(**fixed_horizon(sz))
    res, first, warm = timed(lambda: solve_population(
        jnp.asarray(T0, jnp.float32), grid, planets, cfg))
    flux = np.asarray(res.flux)
    check(np.all(np.isfinite(flux)), "non-finite flux")
    s = sample_columns(sz.columns, sz.sample)
    errs = oracle_errors(sz, [planets[i] for i in s], T0[s], flux[s],
                         np.asarray(res.final_temps)[s])
    report("population", columns=sz.columns, compile_s=first - warm,
           warm_s=warm, peak_gb=peak_gb([dev]), sampled=s.tolist(),
           **errs, **BOUNDS)
    check(within_bounds(errs), "population outside the oracle bounds")


def phase_chemistry(sz: Sizes, dev):
    import jax.numpy as jnp

    _, grid = make_grid(sz, jnp.float32, chemistry="equilibrium")
    T0 = initial_temps(grid, sz.columns)
    kw = fixed_horizon(sz)
    (spec, temps, _, _), first, warm = timed(
        lambda: grid.emission_spectra(T0, **kw))
    check(np.all(np.isfinite(spec.flux_cgs)), "non-finite flux")
    s = sample_columns(sz.columns, sz.sample)
    with cpu64():
        # the same chemistry object: its tables are float32 on every
        # grid, and building them again on the CPU costs minutes
        _, grid64 = make_grid(sz, jnp.float64, chemistry=grid.chemistry)
        spec64, temps64, _, _ = grid64.emission_spectra(T0[s], **kw)
    errs = compare(spec.flux_cgs[s], temps[s], spec64.flux_cgs, temps64)
    report("chemistry", columns=sz.columns, compile_s=first - warm,
           warm_s=warm, peak_gb=peak_gb([dev]), sampled=s.tolist(),
           **errs, **BOUNDS)
    check(within_bounds(errs), "chemistry outside the float64 bounds")


def spectrum_loss(grid, sz: Sizes, planet):
    """``value_and_grad`` of a per-column-separable spectrum loss
    through the differentiable public path; the flux rides along."""
    import jax
    import jax.numpy as jnp

    fn = grid.spectrum_fn(**fixed_horizon(sz))
    params = planet.physics_params()

    def loss(T):
        flux = fn(T, params)
        return jnp.sum((flux / 1e13) ** 2), flux
    return jax.jit(jax.value_and_grad(loss, has_aux=True))


def phase_gradient(sz: Sizes, dev, T0, headline_flux):
    import jax.numpy as jnp

    planet, grid = make_grid(sz, jnp.float32)
    vg = spectrum_loss(grid, sz, planet)
    T0_d = jnp.asarray(T0, jnp.float32)
    ((value, flux), grad), first, warm = timed(lambda: vg(T0_d))
    grad = np.asarray(grad)
    flux = np.asarray(flux)
    check(np.all(np.isfinite(grad)), "non-finite gradient")
    # The forward value (the loss over all columns) and every column's
    # flux against the while-loop solve of the headline phase.  Compiled
    # alone, the differentiable forward is bit-identical to that solve;
    # compiled together with its backward pass, XLA fuses it otherwise,
    # and float32 rounding that differs is amplified in the chaotic
    # columns the bounds above describe: on the H100, 3 of 8192 columns
    # read 0.8e-4 to 2.8e-4 of peak, the median 2e-7, and against
    # float64 each program was the worse one in a different column.
    # All but one column in a thousand must be within FLUX_BOUND.
    ref_value = float(np.sum((np.asarray(headline_flux, np.float64)
                              / 1e13) ** 2))
    value_err = abs(float(value) - ref_value) / ref_value
    fwd_err = column_flux_errors(flux, headline_flux)
    fwd_p999 = float(np.quantile(fwd_err, 0.999))
    s = sample_columns(sz.columns, sz.grad_sample)
    with cpu64():
        planet64, grid64 = make_grid(sz, jnp.float64)
        (_, _), grad64 = spectrum_loss(grid64, sz, planet64)(
            jnp.asarray(T0[s], jnp.float64))
    col_err = gradient_errors(grad[s], np.asarray(grad64))
    report("gradient", columns=sz.columns, compile_s=first - warm,
           warm_s=warm, peak_gb=peak_gb([dev]), sampled=s.tolist(),
           forward_value_err=value_err, forward_flux_err_p999=fwd_p999,
           forward_flux_err_max=float(np.max(fwd_err)),
           forward_columns_over_bound=int(np.sum(fwd_err > FLUX_BOUND)),
           forward_flux_bound=FLUX_BOUND,
           grad_err_median=float(np.median(col_err)),
           grad_err_7_in_8=seven_in_eight(col_err),
           grad_err_max=float(np.max(col_err)), grad_bound=GRAD_BOUND)
    check(value_err <= FLUX_BOUND and fwd_p999 <= FLUX_BOUND,
          "differentiable forward differs from the while-loop solve")
    check(seven_in_eight(col_err) <= GRAD_BOUND,
          "gradient outside the float64 bound")


def gradient_errors(grad, grad_ref):
    """Per column: max |dG_c| / max |G_ref| over all sampled columns."""
    grad_ref = np.asarray(grad_ref, np.float64)
    return (np.max(np.abs(np.asarray(grad, np.float64) - grad_ref),
                   axis=1) / np.max(np.abs(grad_ref)))


def seven_in_eight(errors) -> float:
    """The largest error left once the worst column in every eight is
    set aside: at most one column in eight may exceed it."""
    errors = np.sort(np.asarray(errors))
    return float(errors[-(len(errors) // 8) - 1])


def one_card(sz: Sizes, dev):
    phase_golden(sz, dev)
    T0, flux = phase_headline(sz, dev)
    phase_population(sz, dev)
    phase_chemistry(sz, dev)
    phase_gradient(sz, dev, T0, flux)


# --------------------------------------------------------------------------
# four-card phases
# --------------------------------------------------------------------------

def check_spread(name, res, devices):
    """The output spans every card, and the cards' peak memory agrees
    to within a quarter."""
    spans = {d.id for d in res.flux.sharding.device_set}
    check(spans == {d.id for d in devices},
          f"{name}: output on devices {sorted(spans)}")
    peaks = peak_gb(devices)
    check(max(peaks) <= 1.25 * min(peaks),
          f"{name}: unbalanced peak memory {peaks}")
    return peaks


def mesh_phase(name, sz, devices, solve, T0, reference):
    res, first, warm = timed(solve)
    peaks = check_spread(name, res, devices)
    s = sample_columns(T0.shape[0], sz.sample)
    ref = reference(s)
    errs = compare(np.asarray(res.flux)[s], np.asarray(res.final_temps)[s],
                   ref.flux, ref.final_temps)
    report(name, columns=int(T0.shape[0]), compile_s=first - warm,
           warm_s=warm, peak_gb=peaks, sampled=s.tolist(), **errs,
           **BOUNDS)
    check(within_bounds(errs), f"{name}: differs from the single-card solve")


def four_cards(sz: Sizes, devices):
    import jax
    import jax.numpy as jnp

    from frei_tpu.parallel import (make_mesh, solve_ensemble,
                                   solve_population)
    from frei_tpu.rt.solver import SolverConfig, solve_rc_batched

    planet, grid = make_grid(sz, jnp.float32)
    params = planet.physics_params()
    cfg = SolverConfig(**fixed_horizon(sz))

    def single_card(T0):
        def reference(s):
            with jax.default_device(devices[0]):
                return jax.device_get(solve_rc_batched(
                    jnp.asarray(T0[s], jnp.float32), grid._consts,
                    params, grid._kappa_fn, cfg))
        return reference

    for name, shape, n_cols in [("ensemble_4x1", (4, 1), 4 * sz.columns),
                                ("ensemble_2x2", (2, 2), 2 * sz.columns)]:
        mesh = make_mesh(*shape, devices=devices)
        T0 = initial_temps(grid, n_cols, seed=2)
        T0_d = jnp.asarray(T0, jnp.float32)
        mesh_phase(name, sz, devices, lambda: solve_ensemble(
            T0_d, grid._consts, params, grid.opacities, grid.chemistry,
            cfg, mesh=mesh), T0, single_card(T0))

    mesh = make_mesh(4, 1, devices=devices)
    T0 = initial_temps(grid, 4 * sz.columns, seed=3)
    T0_d = jnp.asarray(T0, jnp.float32)
    planets = random_planets(T0.shape[0], seed=4)

    def population_reference(s):
        with jax.default_device(devices[0]):
            return jax.device_get(solve_population(
                jnp.asarray(T0[s], jnp.float32), grid,
                [planets[i] for i in s], cfg))

    mesh_phase("population_4x1", sz, devices, lambda: solve_population(
        T0_d, grid, planets, cfg, mesh=mesh), T0, population_reference)


# --------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card mesh phases")
    args = ap.parse_args(argv)

    import jax

    from frei_tpu.diag.telemetry import use_compile_cache

    devices = jax.devices()
    need = 4 if args.four_cards else 1
    if devices[0].platform != "gpu" or len(devices) < need:
        print(f"chip_smoke: needs {need} GPU(s); JAX found {devices}",
              file=sys.stderr)
        return 2
    print(card_name_and_power_limit(), flush=True)
    cache_dir = use_compile_cache(HERE / ".jax_cache")
    print(json.dumps({"jax": jax.__version__,
                      "XLA_FLAGS": os.environ.get("XLA_FLAGS", ""),
                      "compile_cache": cache_dir}), flush=True)
    sz = Sizes()
    t0 = time.perf_counter()
    try:
        if args.four_cards:
            four_cards(sz, devices[:4])
        else:
            one_card(sz, devices[0])
    except Exception as exc:       # report the failed phase, exit non-zero
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    print(json.dumps({"total_s": time.perf_counter() - t0}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
