#!/usr/bin/env python
"""Resort-rebin throughput across engines (BASELINE config 2).

Times the grouped-trapezoid rebin of a synthetic high-resolution
opacity cube onto an R~500 grid — the reference's numba hot loop
(`/root/reference/frei/interp.py:156-202`) — for each engine:

  xla     jax segment-sum kernel (any backend)
  matmul  block-banded matmul formulation (opt-in engine)
  native  threaded C++ (std::thread) kernel, built on first use

Default: a 16-row kernel microbench.  ``--production`` runs the
realistic line-list regime instead (1e6 high-res samples x 100 (T, P)
rows, the multi-GB `docs/frei/opacities.rst` scale streamed in
row chunks through the full ``_rebin_store`` path) and prints one
BENCH-style JSON line.

Run: PYTHONPATH=. python tools/bench_rebin.py [--production]
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

N_HR = 1_000_000       # high-res samples (DACE cubes: ~1e6-1e7 / bin file)
N_ROWS = 16            # (T, P) rows per chunk
N_BINS = 500


def timed(fn, n=5):
    fn()                      # warm-up / compile / build
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n


def kernel_bench():
    import jax
    import jax.numpy as jnp

    rng = np.random.RandomState(0)
    x = np.linspace(0.3, 30.0, N_HR)
    rows = rng.rand(N_ROWS, N_HR).astype(np.float32)
    edges = np.geomspace(0.5, 10.0, N_BINS + 1)

    results = {}

    from frei_tpu.ops.rebin import resort_rebin

    # Arrays must be ARGUMENTS, not jit closure captures: a captured
    # array can be re-uploaded on every call, which turns a kernel
    # microbench into a transfer bench.
    xr = jnp.asarray(rows)
    xx = jnp.asarray(x, jnp.float32)
    xe = jnp.asarray(edges, jnp.float32)
    f = jax.jit(resort_rebin)
    results["xla"] = timed(
        lambda: jax.block_until_ready(f(xr, xx, xe)))

    from frei_tpu.ops.rebin_matmul import make_resort_rebin_matmul
    m = jax.jit(make_resort_rebin_matmul(x, edges))
    results["matmul"] = timed(
        lambda: jax.block_until_ready(m(xr)))

    from frei_tpu.native import grouped_trapezoid_native
    try:
        results["native"] = timed(
            lambda: grouped_trapezoid_native(rows, x, edges))
    except Exception as e:
        print("native engine failed:", str(e)[:80])

    total = N_ROWS * N_HR
    dev = jax.devices()[0]
    print(f"device={dev.platform} kind={dev.device_kind!r}  "
          f"{N_ROWS} rows x {N_HR:,} samples -> {N_BINS} bins")
    for name, wall in results.items():
        print(f"  {name:8s} {wall*1e3:8.2f} ms   "
              f"{total/wall/1e9:6.2f} Gsamples/s")


def production_bench(tmp_dir=None, n_hr=1_000_000, n_t=10, n_p=10,
                     engines=("native", "xla", "matmul")):
    """Full ETL path at line-list scale: memmap store -> streamed
    row-chunk rebin -> nearest (T, P) selection (the reference's
    ``binned_opacity`` over a ~`opacities.rst` sized cube)."""
    import tempfile

    from frei_tpu.grids import make_rt_grid
    from frei_tpu.opacity.etl import OpacityStore, _rebin_store, \
        make_synthetic_store

    tmp_dir = tmp_dir or tempfile.mkdtemp(prefix="frei_etl_bench")
    temps = tuple(np.linspace(500.0, 4100.0, n_t))
    press = tuple(np.logspace(-6.0, 2.0, n_p))
    t0 = time.perf_counter()
    store_path = make_synthetic_store(
        Path(tmp_dir) / "1H2-16O__bench.ftop", n_hr=n_hr,
        temps=temps, press_bar=press)
    build_s = time.perf_counter() - t0
    st = OpacityStore(store_path)
    cube_gb = st.cube.size * 4 / 1e9
    grid = make_rt_grid(n_wl_bins=N_BINS, n_layers=30, T_ref=2400.0)

    total = st.cube.shape[0] * st.cube.shape[1] * n_hr
    best = None
    per_engine = {}
    for eng in engines:
        try:
            t0 = time.perf_counter()
            _rebin_store(st, grid, eng, row_chunk=16)
            wall = time.perf_counter() - t0
        except Exception as e:
            print(f"# engine {eng} failed: {str(e)[:80]}",
                  file=sys.stderr)
            continue
        per_engine[eng] = wall
        if best is None or wall < best[1]:
            best = (eng, wall)
    assert best is not None, "no ETL engine succeeded"
    print(json.dumps({
        "metric": "opacity ETL resort-rebin throughput "
                  "(streamed memmap store -> R~500 tables)",
        "value": round(total / best[1] / 1e9, 3),
        "unit": "Gsamples/s",
        "vs_baseline": None,
        "details": {
            "engine": best[0],
            "cube": f"{n_t}x{n_p}x{n_hr}",
            "cube_gb": round(cube_gb, 2),
            "wall_s": {k: round(v, 3) for k, v in per_engine.items()},
            "store_build_s": round(build_s, 1),
        },
    }))


if __name__ == "__main__":
    if "--production" in sys.argv:
        production_bench()
    else:
        kernel_bench()
