"""The run scripts on the CPU: chip_smoke.py and bench.py refuse to
measure anywhere but on a GPU, chip_smoke's comparison with the float64
oracle holds at a small width, and the compile-cache setting goes where
it should."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import bench  # noqa: E402
import chip_smoke  # noqa: E402
from frei_tpu.diag.telemetry import use_compile_cache  # noqa: E402


def test_chip_smoke_refuses_cpu():
    """On a machine whose JAX finds no GPU the script exits non-zero
    and prints no result line."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                          capture_output=True, text=True, timeout=300,
                          env=env, cwd=REPO)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "needs 1 GPU" in proc.stderr


def test_chip_smoke_oracle_comparison_small_f64():
    """The sampled-oracle comparison of the headline phase, at a small
    width in float64: the solver agrees with MiniFrei to roundoff, and
    a flux off by 1e-3 falls outside the bounds."""
    sz = chip_smoke.Sizes(columns=4, bins=24, layers=6, iters=3,
                          sample=2)
    planet, grid = chip_smoke.make_grid(sz, jnp.float64)
    T0 = chip_smoke.initial_temps(grid, sz.columns)
    spec, temps, _, _ = grid.emission_spectra(
        T0, **chip_smoke.fixed_horizon(sz))
    s = chip_smoke.sample_columns(sz.columns, sz.sample)
    assert len(s) == 2
    errs = chip_smoke.oracle_errors(sz, [planet] * len(s), T0[s],
                                    spec.flux_cgs[s], temps[s])
    assert errs["flux_err"] < 1e-9 and errs["temp_max_K"] < 1e-6, errs
    assert chip_smoke.within_bounds(errs)
    off = chip_smoke.oracle_errors(sz, [planet] * len(s), T0[s],
                                   spec.flux_cgs[s] * 1.001, temps[s])
    assert not chip_smoke.within_bounds(off), off


@pytest.mark.parametrize("platform,ok", [("gpu", True), ("cpu", False)])
def test_bench_preflight_accepts_only_gpu(platform, ok):
    pre = {"platform": platform, "kind": "x", "count": 1}
    if ok:
        bench.check_preflight(pre)
    else:
        with pytest.raises(RuntimeError, match="not a GPU"):
            bench.check_preflight(pre)


def test_bench_refuses_cpu_with_nonzero_exit():
    """A full bench run on a CPU-only machine stops after the preflight:
    exit code 1 and one JSON line that names the error and no value."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, str(REPO / "bench.py")],
                          capture_output=True, text=True, timeout=300,
                          env=env, cwd=REPO)
    assert proc.returncode == 1
    record = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "not a GPU" in record["error"] and "value" not in record


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_location(monkeypatch, tmp_path, env_set):
    """With JAX_COMPILATION_CACHE_DIR set, JAX's own setting stands and
    nothing else is configured; without it the cache goes to the fixed
    directory the caller names."""
    before = jax.config.jax_compilation_cache_dir
    fixed = tmp_path / ".jax_cache"
    try:
        if env_set:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR",
                               str(tmp_path / "from_env"))
            assert use_compile_cache(fixed) == str(tmp_path / "from_env")
            assert jax.config.jax_compilation_cache_dir == before
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR",
                               raising=False)
            assert use_compile_cache(fixed) == str(fixed)
            assert jax.config.jax_compilation_cache_dir == str(fixed)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_chip_smoke_gradient_error_is_per_column():
    """The gradient statistic normalizes each column's deviation by the
    reference's global scale, and sets aside the worst column in every
    eight: one ill-conditioned column of eight passes, two do not."""
    ref = np.ones((8, 3))
    got = ref.copy()
    got[2, 1] += 0.5
    err = chip_smoke.gradient_errors(got, ref)
    np.testing.assert_allclose(err, [0, 0, 0.5, 0, 0, 0, 0, 0])
    assert chip_smoke.seven_in_eight(err) == 0.0
    got[5, 0] -= 0.5
    err = chip_smoke.gradient_errors(got, ref)
    assert chip_smoke.seven_in_eight(err) == 0.5


@pytest.mark.parametrize("n,expected", [(1, 9.0), (7, 9.0), (8, 8.0),
                                        (32, 5.0)])
def test_chip_smoke_seven_in_eight_rank(n, expected):
    """All but one in eight: of 32 columns the 28th smallest, of 8 the
    second largest, of fewer than 8 the largest."""
    errors = np.concatenate([np.zeros(n - min(n, 5)),
                             [5.0, 6.0, 7.0, 8.0, 9.0][-min(n, 5):]])
    assert chip_smoke.seven_in_eight(np.random.RandomState(0)
                                     .permutation(errors)) == expected


def _temperature_case(case):
    """Sampled final temperatures (8 columns x 30 layers) and a
    reference that differs as ``case`` names."""
    rng = np.random.RandomState(0)
    ref = rng.uniform(1000.0, 2500.0, (8, 30))
    got = ref + rng.uniform(-0.05, 0.05, ref.shape)
    if case == "chaotic_cells":      # float32 chaos: single cells
        got[3, -1] += 30.0
        got[6, 16] -= 1.5
    elif case == "one_layer":        # a fault confined to one layer
        got[:, 20] += 1.0
    elif case == "top_layer":        # a fault confined to the top layer
        got[:, -1] += 25.0
    elif case == "one_column":       # one column wrong throughout
        got[4] += 2.0
    return got, ref


@pytest.mark.parametrize("case,ok", [("sound", True), ("chaotic_cells", True),
                                     ("one_layer", False),
                                     ("top_layer", False),
                                     ("one_column", False)])
def test_chip_smoke_temperature_statistics(case, ok):
    """The temperature bounds pass isolated chaotic cells and catch a
    fault confined to one layer, to the top layer or to one column."""
    got, ref = _temperature_case(case)
    flux = np.ones((8, 5))
    errs = chip_smoke.compare(flux, got, flux, ref)
    assert chip_smoke.within_bounds(errs) is ok, errs
