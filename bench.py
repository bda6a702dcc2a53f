"""Headline benchmark: batched RC emission-spectrum throughput on one GPU.

Metric (BASELINE.md): columns x spectral-bins per second on one card
at R~500 (500 wavelength bins x 30 layers, hot-Jupiter configuration,
synthetic opacity fixture, mock chemistry), solving a batch of 8192
columns through a fixed 20-iteration radiative-convective horizon
(emit + absorb per iteration + final emit), float32, XLA sweep engine.

The JSON line also carries the BASELINE variant legs:

* ``"population"`` — per-planet F_toa / gravity / alpha (BASELINE
  config 5, reference `core.py:48-62`);
* ``"chemistry"`` — equilibrium chemistry (table mode) inside the RC
  loop instead of the constant-VMR mock (BASELINE config 4, reference
  `opacity.py:246-248`);
* ``"gradient"`` — one ``value_and_grad`` through the differentiable
  solver at the same 8192 columns (the retrieval path,
  docs/retrieval.md), asserting gradient finiteness.

``vs_baseline``: speedup over the reference-equivalent execution model
— a single-column, float64, per-layer-loop numpy implementation of the
identical algorithm (tests/reference_impl.py), timed on the host CPU
for the same 20-iteration horizon as the median of 15 runs with the
spread recorded.  (The reference publishes no benchmark numbers,
`README.rst:1-13`; the oracle is favorable to it: the reference also
re-runs C++ FastChem per layer per sweep, which the oracle skips.)

Every leg runs in a child process, one after another, so one process
uses the card at a time; the parent never imports JAX.  The legs share
the persistent compilation cache (``frei_tpu.diag.use_compile_cache``).
A leg that fails or times out fails the run: the JSON line then names
the failed legs and the exit code is 1.  A preflight that finds no GPU
also exits 1.

Prints exactly one JSON line on stdout; progress goes to stderr.

Usage::

    python bench.py
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from functools import partial
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(_HERE))
sys.path.insert(0, str(_HERE / "tests"))

import chip_smoke  # noqa: E402  (shared set-up: grid, T0, horizon)

SIZES = chip_smoke.Sizes()
N_COLUMNS = SIZES.columns
N_BINS = SIZES.bins
N_LAYERS = SIZES.layers
N_ITERS = SIZES.iters

#: per-leg wall-clock limit [s], compilation included
LEG_TIMEOUT_S = 1200

METRIC = ("columns x spectral-bins per second on one GPU "
          "(R~500, 30 layers, 20 RC iterations, float32)")


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


# --------------------------------------------------------------------------
# Leg implementations (each runs inside its own child process)
# --------------------------------------------------------------------------

def _solver_inputs(chemistry=None):
    """The inputs ``chip_smoke.py`` checks: the same grid, seeded
    initial profiles and fixed horizon (convergence exits disabled, so
    every run does identical work)."""
    import jax.numpy as jnp

    from frei_tpu.rt.solver import SolverConfig

    planet, grid = chip_smoke.make_grid(SIZES, jnp.float32,
                                        chemistry=chemistry)
    cfg = SolverConfig(**chip_smoke.fixed_horizon(SIZES))
    return planet, grid, cfg, chip_smoke.initial_temps(grid, N_COLUMNS)


def _time_solve(fn, T0):
    import jax

    res = fn(T0)
    jax.block_until_ready(res.flux)   # compile + warm-up
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        res = fn(T0)
        jax.block_until_ready(res.flux)
        times.append(time.perf_counter() - t0)
    wall = min(times)
    if not np.all(np.isfinite(np.asarray(res.flux))):
        raise FloatingPointError("non-finite flux")
    return N_COLUMNS * N_BINS / wall, wall


def leg_preflight():
    """Tiny device op: proves the backend initializes and executes,
    and names the device every other leg runs on."""
    import jax
    import jax.numpy as jnp

    t0 = time.perf_counter()
    jnp.ones((8, 128)).sum().block_until_ready()
    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()),
            "tiny_op_s": round(time.perf_counter() - t0, 3)}


def leg_headline(chemistry=None):
    import jax.numpy as jnp

    from frei_tpu.rt.solver import solve_rc_batched

    planet, grid, cfg, T0 = _solver_inputs(chemistry=chemistry)
    fn = partial(
        solve_rc_batched, consts=grid._consts,
        params=planet.physics_params(), kappa_all=grid._kappa_fn,
        cfg=cfg)
    throughput, wall = _time_solve(fn, jnp.asarray(T0, jnp.float32))
    return {"value": round(throughput, 1), "wall_s": round(wall, 4)}


def leg_chemistry():
    return leg_headline(chemistry="equilibrium")


def leg_population():
    """Per-planet population variant (BASELINE config 5): same shape,
    every column its own irradiation / gravity / mixing-length.  The
    per-planet constants are built once (as ``solve_population`` does)
    so the timed region is the device solve, like the headline."""
    import jax.numpy as jnp

    from frei_tpu.parallel.solve import _population_inputs
    from frei_tpu.rt.solver import solve_rc_batched

    _, grid, cfg, T0 = _solver_inputs()
    consts, params = _population_inputs(
        grid, chip_smoke.random_planets(N_COLUMNS))
    fn = partial(solve_rc_batched, consts=consts, params=params,
                 kappa_all=grid._kappa_fn, cfg=cfg)
    throughput, wall = _time_solve(fn, jnp.asarray(T0, jnp.float32))
    return {"value": round(throughput, 1), "wall_s": round(wall, 4)}


def leg_gradient():
    """Differentiable-path leg (docs/retrieval.md): one
    ``value_and_grad`` of a spectrum loss through the fixed-horizon
    rematerialized solver at the headline width.  Asserts gradient
    finiteness at production shape/dtype (the float32 NaN-gradient
    bug class)."""
    import jax
    import jax.numpy as jnp

    from frei_tpu.rt.solver import SolverConfig, solve_rc_batched

    planet, grid, _, T0 = _solver_inputs()
    T0 = jnp.asarray(T0, jnp.float32)
    cfg = SolverConfig(differentiable=True,
                       **chip_smoke.fixed_horizon(SIZES))

    def loss(T):
        res = solve_rc_batched(T, grid._consts,
                               planet.physics_params(),
                               grid._kappa_fn, cfg)
        return jnp.sum((res.flux / 1e13) ** 2)

    g = jax.jit(jax.value_and_grad(loss))
    out = g(T0)
    jax.block_until_ready(out[1])          # compile + warm-up
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = g(T0)
        jax.block_until_ready(out[1])
        walls.append(time.perf_counter() - t0)
    wall = min(walls)
    if not np.all(np.isfinite(np.asarray(out[1]))):
        raise FloatingPointError("non-finite retrieval gradients")
    return {"value": round(N_COLUMNS * N_BINS / wall, 1),
            "wall_s": round(wall, 4), "columns": N_COLUMNS}


def leg_oracle():
    """Single-column float64 numpy per-layer-loop baseline, timed on
    the host CPU.  The CPU platform is forced before any backend touch,
    so this leg never opens the card."""
    import jax
    jax.config.update("jax_platforms", "cpu")

    from frei_tpu import Grid, Planet, load_example_opacity
    from frei_tpu.constants import u_amu
    from frei_tpu.opacity.rayleigh import rayleigh_total
    from frei_tpu.stellar.irradiation import f_toa_np
    from reference_impl import MiniFrei

    planet = Planet.from_hot_jupiter()
    grid = Grid(planet, n_wl_bins=N_BINS, n_layers=N_LAYERS, T_ref=2400.0)
    # The oracle consumes the table as host numpy float64; the device
    # dtype of the fixture is irrelevant to its timing.
    stack = load_example_opacity(grid, scale_factor=1.0)
    lam_cm = grid.rt_grid.lam_cm
    mini = MiniFrei(
        lam_cm=lam_cm, pressures_cgs=grid.rt_grid.pressures_cgs,
        k_table=np.asarray(stack.values)[0],
        temps_axis=np.asarray(stack.temps),
        press_axis_cgs=np.asarray(stack.press_cgs),
        mmr=1.5e-3 * 18.0 * u_amu / planet.m_bar,
        sigma_scat=rayleigh_total(lam_cm, planet.m_bar),
        F_toa=f_toa_np(lam_cm, planet.T_star, planet.a_rstar),
        g=planet.g, m_bar=planet.m_bar, alpha=planet.alpha)
    T0 = np.asarray(grid.rt_grid.init_temperatures)
    mini.emission_spectrum(T0, n_timesteps=1)      # warm caches
    # Median of 15 with the spread recorded: host-clock timings on a
    # shared machine swing with other load.
    walls = []
    for _ in range(15):
        t0 = time.perf_counter()
        mini.emission_spectrum(T0, n_timesteps=N_ITERS,
                               n_zero_crossings=10 ** 6,
                               convergence_dT=0.0)
        walls.append(time.perf_counter() - t0)
    wall = float(np.median(walls))
    return {"value": round(N_BINS / wall, 1), "wall_s": round(wall, 3),
            "wall_min_s": round(min(walls), 3),
            "wall_max_s": round(max(walls), 3), "n_runs": len(walls)}


LEGS = {"preflight": leg_preflight, "headline": leg_headline,
        "oracle": leg_oracle, "population": leg_population,
        "chemistry": leg_chemistry, "gradient": leg_gradient}


# --------------------------------------------------------------------------
# Parent-side orchestration: one child per leg, plain timeout
# --------------------------------------------------------------------------

def run_leg(leg: str, timeout_s: float = LEG_TIMEOUT_S):
    """Run one leg in a child process.  Returns (result | None,
    error | None)."""
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--leg", leg],
            capture_output=True, text=True, timeout=timeout_s)
    except subprocess.TimeoutExpired:
        return None, f"timeout after {timeout_s:.0f}s"
    dt = time.perf_counter() - t0
    tail = "\n".join(proc.stderr.strip().splitlines()[-4:])
    if proc.returncode != 0:
        _log(f"[bench] {leg}: FAILED in {dt:.0f}s")
        return None, f"rc={proc.returncode}: {tail}"
    lines = proc.stdout.strip().splitlines()
    try:
        result = json.loads(lines[-1])
    except (IndexError, json.JSONDecodeError):
        return None, f"no JSON on the leg's stdout: {tail}"
    _log(f"[bench] {leg}: ok in {dt:.0f}s -> {result}")
    return result, None


def check_preflight(pre: dict) -> None:
    """Refuse any device but a GPU: a number measured elsewhere must not
    go out under the benchmark's name."""
    if pre.get("platform") != "gpu":
        raise RuntimeError(
            f"preflight ran on platform {pre.get('platform')!r}, not a "
            "GPU; bench.py measures only on the card")


def main() -> int:
    args = sys.argv[1:]
    if args and args[0] == "--leg":
        from frei_tpu.diag.telemetry import use_compile_cache

        use_compile_cache(_HERE / ".jax_cache")
        print(json.dumps(LEGS[args[1]]()))
        return 0

    record = {"metric": METRIC, "unit": "columns*bins/s"}
    pre, err = run_leg("preflight", timeout_s=300)
    if pre is None:
        record["error"] = f"preflight failed: {err}"
        print(json.dumps(record))
        return 1
    try:
        check_preflight(pre)
    except RuntimeError as exc:
        record.update(error=str(exc), device=pre)
        print(json.dumps(record))
        return 1
    record["device"] = {k: pre[k] for k in ("platform", "kind", "count")}
    record["card"] = chip_smoke.card_name_and_power_limit()

    results, errors = {}, {}
    for leg in ("headline", "oracle", "population", "chemistry",
                "gradient"):
        results[leg], err = run_leg(leg)
        if err is not None:
            errors[leg] = err
    head, oracle = results["headline"], results["oracle"]
    record.update(
        value=head and head["value"],
        population=results["population"],
        chemistry=results["chemistry"],
        gradient=results["gradient"],
        vs_baseline=(round(head["value"] / oracle["value"], 1)
                     if head and oracle else None),
        details={"batch_columns": N_COLUMNS,
                 "wall_s": head and head["wall_s"],
                 "preflight": pre,
                 "baseline": "single-column float64 numpy layer-loop "
                             "(reference execution model), host CPU",
                 "baseline_leg": oracle})
    if errors:
        record["errors"] = errors
    print(json.dumps(record))
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
