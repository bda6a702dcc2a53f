"""Opacity ETL: store format, DACE ingest, streaming rebin, cache,
and the native C++ kernel."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from frei_tpu.grids import make_rt_grid
from frei_tpu.native import grouped_trapezoid_native, native_available
from frei_tpu.opacity.etl import (OpacityStore, binned_opacity_stack,
                                  binned_opacity_tables,
                                  make_synthetic_store,
                                  opacity_dir_to_store)
from frei_tpu.ops.rebin import resort_rebin


@pytest.fixture()
def cache_env(tmp_path, monkeypatch):
    monkeypatch.setenv("FREI_TPU_CACHE", str(tmp_path / "cache"))
    return tmp_path


def test_synthetic_store_roundtrip(cache_env):
    p = make_synthetic_store(cache_env / "syn.ftop", n_hr=5000)
    st = OpacityStore(p)
    assert st.isotopologue == "1H2-16O"
    assert st.species == "H2O"
    assert st.cube.shape == (3, 4, 5000)
    assert np.all(np.diff(st.wavelength_um) > 0)


def test_dace_bin_dir_ingest(cache_env):
    """Filename-metadata parsing and cube assembly
    (`opacity.py:395-483` semantics), including the [1:][::-1]
    wavelength handling and single-pressure mirroring."""
    bdir = cache_env / "bins"
    bdir.mkdir()
    wn0, wn1 = 10000, 10010     # 1000 wavenumber samples at 0.01 step
    n = len(np.arange(wn0, wn1, 0.01))
    rng = np.random.RandomState(0)
    for T in (1000, 2000):
        for ptag, pval in [("p100", 10.0), ("n200", 0.01)]:
            data = rng.uniform(0.0, 1.0, n).astype(np.float32)
            data.tofile(bdir / f"Out_{wn0}_{wn1}_{T}_{ptag}.bin")
    out = opacity_dir_to_store(bdir, cache_env / "ing.ftop", "12C-16O")
    st = OpacityStore(out)
    assert st.cube.shape == (2, 2, n - 1)
    np.testing.assert_allclose(sorted(st.press_bar), [0.01, 10.0])
    np.testing.assert_allclose(sorted(st.temps), [1000, 2000])
    # ascending microns, first wavenumber sample dropped
    wav = np.asarray(st.wavelength_um)
    assert np.all(np.diff(wav) > 0)
    np.testing.assert_allclose(wav[-1], 1.0 / (wn0 + 0.01) / 1e-4)


def test_single_pressure_mirroring(cache_env):
    bdir = cache_env / "bins1p"
    bdir.mkdir()
    n = len(np.arange(5000, 5005, 0.01))
    data = np.ones(n, dtype=np.float32)
    data.tofile(bdir / "Out_5000_5005_1500_p200.bin")   # P = 100 bar
    st = OpacityStore(opacity_dir_to_store(bdir, cache_env / "m.ftop",
                                           "Na"))
    np.testing.assert_allclose(sorted(st.press_bar), [0.01, 100.0])
    assert np.all(st.cube[0, 0] == st.cube[0, 1])


def test_binned_stack_end_to_end(cache_env):
    store_dir = cache_env / "cache" / "opacities"
    store_dir.mkdir(parents=True)
    make_synthetic_store(store_dir / "1H2-16O__synthetic.ftop",
                         n_hr=40000)
    grid = make_rt_grid(n_wl_bins=64, n_layers=8, T_ref=2400.0)
    stack = binned_opacity_stack(grid, dtype=jnp.float64)
    assert stack.species == ("1H2-16O",)
    assert stack.values.shape == (1, 8, 8, 64)
    v = np.asarray(stack.values)
    assert np.all(np.isfinite(v)) and v.max() > 0
    # cached second load is identical
    t2 = binned_opacity_tables(grid)
    np.testing.assert_array_equal(
        np.asarray(t2["1H2-16O"][0])[
            np.ix_(*[np.arange(s) for s in v.shape[1:3]])],
        np.asarray(t2["1H2-16O"][0]))


def test_species_filter_and_missing(cache_env):
    store_dir = cache_env / "cache" / "opacities"
    store_dir.mkdir(parents=True)
    make_synthetic_store(store_dir / "1H2-16O__synthetic.ftop",
                         n_hr=2000)
    grid = make_rt_grid(n_wl_bins=16, n_layers=4)
    t = binned_opacity_tables(grid, species=["H2O"], cache=False)
    assert list(t) == ["1H2-16O"]
    with pytest.raises(FileNotFoundError):
        binned_opacity_tables(grid, species=["TiO"], cache=False)


def test_native_kernel_matches_xla():
    if not native_available():
        pytest.skip("no C++ toolchain available")
    rng = np.random.RandomState(2)
    x = np.sort(rng.uniform(0.5, 10.0, 3001))
    edges = np.logspace(np.log10(0.49), 1.0, 41)
    vals = rng.lognormal(0, 1, (7, 3001)).astype(np.float32)
    want = np.asarray(resort_rebin(jnp.asarray(vals, jnp.float64),
                                   jnp.asarray(x), jnp.asarray(edges)))
    got = grouped_trapezoid_native(vals, x, edges)
    np.testing.assert_allclose(got, want, rtol=2e-6)


def test_auto_engine_resolution(monkeypatch):
    """engine='auto' picks the C++ host engine on EVERY backend — the
    ETL streams a host memmap, so a device engine pays a host->device
    transfer per chunk — falling back to the portable XLA path only
    when no C++ toolchain exists.  The removed Pallas engine name is
    refused like any unknown name."""
    from frei_tpu.opacity.etl import resolve_rebin_engine
    assert resolve_rebin_engine("xla") == "xla"       # explicit wins
    assert resolve_rebin_engine("matmul") == "matmul"  # opt-in stays
    assert resolve_rebin_engine("auto") == "native"
    # no C++ toolchain -> portable XLA path, not a g++ crash mid-ETL
    import frei_tpu.native as native_mod
    monkeypatch.setattr(native_mod, "native_available", lambda: False)
    assert resolve_rebin_engine("auto") == "xla"
    # a typo must not silently run the slowest engine
    with pytest.raises(ValueError, match="unknown rebin engine"):
        resolve_rebin_engine("matmull")
    with pytest.raises(ValueError, match="unknown rebin engine"):
        resolve_rebin_engine("pallas")


def test_reload_preserves_chemistry():
    """Reloading opacities without naming a chemistry must keep the
    configured model — it used to silently downgrade equilibrium
    chemistry to the constant-VMR mock (round-4 review)."""
    from frei_tpu import Grid, Planet, load_example_opacity

    planet = Planet.from_hot_jupiter()
    grid = Grid(planet, n_wl_bins=16, n_layers=4, T_ref=2400.0)
    stack = load_example_opacity(grid)

    class MarkerChem:
        def mmr(self, temps, pressures_cgs):
            import jax.numpy as jnp
            return jnp.full((1,) + jnp.shape(temps), 1e-3)

    marker = MarkerChem()
    grid.load_opacities(opacities=stack, chemistry=marker)
    assert grid.chemistry is marker
    grid.load_opacities(opacities=stack)          # reload, no kwarg
    assert grid.chemistry is marker               # preserved
    grid.load_opacities(opacities=stack, chemistry="mock")
    from frei_tpu.chemistry.mocks import MockChemistry
    assert isinstance(grid.chemistry, MockChemistry)  # explicit reset


def test_corrupt_binned_cache_is_a_miss(cache_env):
    """A truncated/garbage cache file (writer killed mid-save on an
    older version) must read as a cache miss and be dropped, not
    poison every future run with BadZipFile; saves are atomic now
    (temp file + os.replace)."""
    from frei_tpu.io.cache import (binned_cache_dir, load_binned_cache,
                                   save_binned_cache)
    binned_cache_dir().mkdir(parents=True, exist_ok=True)
    bad = binned_cache_dir() / "deadbeef.npz"
    bad.write_bytes(b"this is not a zip file")
    assert load_binned_cache("deadbeef") is None
    assert not bad.exists()              # dropped for rebuild
    tables = {"1H2-16O": (np.ones((2, 2, 4), np.float32),
                          np.array([1000.0, 2000.0]),
                          np.array([0.1, 1.0]))}
    save_binned_cache("cafe", tables)
    got = load_binned_cache("cafe")
    np.testing.assert_array_equal(got["1H2-16O"][0],
                                  tables["1H2-16O"][0])
    # no stray temp files left behind
    assert not list(binned_cache_dir().glob("*.tmp*"))


def test_duplicate_isotopologue_rejected(cache_env):
    """Two stores for the same isotopologue (e.g. two linelists of one
    molecule) would silently shadow each other in the
    isotopologue-keyed tables — must refuse loudly (round-4 review)."""
    store_dir = cache_env / "cache" / "opacities"
    store_dir.mkdir(parents=True)
    make_synthetic_store(store_dir / "1H2-16O__BT2.ftop", n_hr=2000)
    make_synthetic_store(store_dir / "1H2-16O__POKAZATEL.ftop",
                         n_hr=2000)
    grid = make_rt_grid(n_wl_bins=16, n_layers=4)
    with pytest.raises(ValueError, match="isotopologue"):
        binned_opacity_tables(grid, cache=False)


def test_grid_load_opacities_engine_kwarg(cache_env):
    """Grid.load_opacities threads engine= through to the ETL rebin
    (round-3 review: the matmul engine was unreachable from the user
    API)."""
    from frei_tpu import Grid, Planet

    store_dir = cache_env / "cache" / "opacities"
    store_dir.mkdir(parents=True)
    make_synthetic_store(store_dir / "1H2-16O__synthetic.ftop",
                         n_hr=20000)
    planet = Planet.from_hot_jupiter()
    grids = []
    for eng in ["matmul", "xla"]:
        # separate binned-result caches: the cache key is engine-blind
        # (engines agree numerically), so a shared dir would serve the
        # first engine's result to the second
        cache_dir = cache_env / f"binned-{eng}"
        cache_dir.mkdir()
        os.symlink(store_dir, cache_dir / "opacities")
        os.environ["FREI_TPU_CACHE"] = str(cache_dir)
        g = Grid(planet, n_wl_bins=32, n_layers=4, T_ref=2400.0,
                 dtype=jnp.float64)
        g.load_opacities(engine=eng)
        grids.append(g)
    np.testing.assert_allclose(np.asarray(grids[0].opacities.values),
                               np.asarray(grids[1].opacities.values),
                               rtol=2e-4, atol=1e-8)


def test_engines_agree(cache_env):
    store_dir = cache_env / "cache" / "opacities"
    store_dir.mkdir(parents=True)
    make_synthetic_store(store_dir / "1H2-16O__synthetic.ftop",
                         n_hr=20000)
    grid = make_rt_grid(n_wl_bins=32, n_layers=4)
    t_xla = binned_opacity_tables(grid, engine="xla", cache=False)
    engines = ["matmul"]
    if native_available():
        engines.append("native")
    for eng in engines:
        t = binned_opacity_tables(grid, engine=eng, cache=False)
        np.testing.assert_allclose(
            t["1H2-16O"][0], t_xla["1H2-16O"][0], rtol=2e-4, atol=1e-8)


def _exact_rebin_oracle(st, grid):
    """Float64 numpy transcription of the reference's groupies=False
    path (`/root/reference/frei/opacity.py:150-170` with
    ``mapfunc_exact``, `:33-42`): per right-closed bin, nearest-(T, P)
    interp, trapezoid average over the samples in the bin placed at
    their mean wavelength, then per-target linear interpolation with
    straight-line extrapolation onto the bin centers (`:164-167`)."""
    edges = np.asarray(grid.wl_edges_cm, np.float64) / 1e-4
    lam = np.asarray(grid.lam_micron, np.float64)
    wav = np.asarray(st.wavelength_um, np.float64)
    ti = np.argmin(np.abs(st.temps[None, :]
                          - grid.init_temperatures[:, None]), axis=1)
    pi = np.argmin(np.abs(st.press_bar[None, :]
                          - grid.pressures_bar[:, None]), axis=1)
    sub = np.asarray(st.cube, np.float64)[np.ix_(ti, pi)]
    xs, ys = [], []
    for k in range(len(edges) - 1):
        m = (wav > edges[k]) & (wav <= edges[k + 1])
        if not m.any():
            continue
        w = wav[m]
        assert m.sum() >= 2, "oracle requires >=2 samples per bin"
        integral = np.trapezoid(sub[..., m], w, axis=-1)
        xs.append(w.mean())
        ys.append(integral / (w.max() - w.min()))
    xs = np.asarray(xs)
    ys = np.stack(ys, axis=-1)          # (LT, LP, n_nonempty)
    out = np.empty(ys.shape[:-1] + (len(lam),))
    for j, t in enumerate(lam):
        i = min(max(int(np.searchsorted(xs, t)) - 1, 0), len(xs) - 2)
        f = (t - xs[i]) / (xs[i + 1] - xs[i])
        out[..., j] = ys[..., i] * (1 - f) + ys[..., i + 1] * f
    return out


def test_exact_rebin_matches_transcription(cache_env):
    """groupies=False engine vs the float64 oracle, including empty
    bins (filled by the linear resampling) and out-of-range bin centers
    (linear extrapolation)."""
    store_dir = cache_env / "cache" / "opacities"
    store_dir.mkdir(parents=True)
    # narrow-range store: the run grid's outer bins are empty -> the
    # resampling must extrapolate to cover them
    p = make_synthetic_store(store_dir / "1H2-16O__synthetic.ftop",
                             n_hr=60_000, lam_range_um=(0.8, 7.0))
    st = OpacityStore(p)
    grid = make_rt_grid(n_wl_bins=48, n_layers=6, T_ref=2400.0)
    t = binned_opacity_tables(grid, cache=False, groupies=False)
    want = _exact_rebin_oracle(st, grid)
    np.testing.assert_allclose(t["1H2-16O"][0], want,
                               rtol=5e-5, atol=1e-10)


def test_exact_vs_groupies_scaling(cache_env):
    """The two semantics differ by ~integral-vs-average scaling: for a
    constant-opacity cube, exact gives back the constant while groupies
    gives width^2 x 1e-3 x constant (integral x width x 1e-3)."""
    store_dir = cache_env / "cache" / "opacities"
    store_dir.mkdir(parents=True)
    p = make_synthetic_store(store_dir / "1H2-16O__synthetic.ftop",
                             n_hr=50_000)
    st = OpacityStore(p)
    const_cube = np.full_like(np.asarray(st.cube), 3.5)
    np.save(p / "cube.npy", const_cube)
    st = OpacityStore(p)
    grid = make_rt_grid(n_wl_bins=32, n_layers=4)
    t_exact = binned_opacity_tables(grid, cache=False, groupies=False)
    np.testing.assert_allclose(t_exact["1H2-16O"][0], 3.5, rtol=1e-5)
    t_grp = binned_opacity_tables(grid, cache=False, groupies=True)
    assert not np.allclose(t_grp["1H2-16O"][0], 3.5, rtol=1e-3)


def test_exact_engines_agree(cache_env):
    store_dir = cache_env / "cache" / "opacities"
    store_dir.mkdir(parents=True)
    make_synthetic_store(store_dir / "1H2-16O__synthetic.ftop",
                         n_hr=20000)
    grid = make_rt_grid(n_wl_bins=32, n_layers=4)
    t_xla = binned_opacity_tables(grid, engine="xla", cache=False,
                                  groupies=False)
    engines = ["matmul"]
    if native_available():
        engines.append("native")
    for eng in engines:
        t = binned_opacity_tables(grid, engine=eng, cache=False,
                                  groupies=False)
        np.testing.assert_allclose(
            t["1H2-16O"][0], t_xla["1H2-16O"][0], rtol=2e-4, atol=1e-8)


def test_grid_load_opacities_exact_path_solves(cache_env):
    from frei_tpu import Grid, Planet

    make_synthetic_store(cache_env / "1H2-16O__syn.ftop", n_hr=30_000)
    grid = Grid(Planet.from_hot_jupiter(), n_wl_bins=32, n_layers=6,
                T_ref=2400.0, dtype=jnp.float64)
    grid.load_opacities(path=str(cache_env / "*.ftop"), groupies=False)
    spec, *_ = grid.emission_spectrum(n_timesteps=1)
    assert np.all(np.isfinite(spec.flux_cgs)) and np.max(spec.flux_cgs) > 0


def test_grid_load_opacities_from_store_path(cache_env):
    """The Grid-level species loading flow: on-disk stores -> rebin ->
    solve (the reference's `grid.load_opacities()` + `~/.frei` cache
    path, `core.py:198-231`)."""
    from frei_tpu import Grid, Planet
    from frei_tpu.opacity import make_synthetic_store

    make_synthetic_store(cache_env / "1H2-16O__syn.ftop",
                         isotopologue="1H2-16O", n_hr=30_000)
    make_synthetic_store(cache_env / "23Na__syn.ftop",
                         isotopologue="23Na", n_hr=30_000, seed=9)
    planet = Planet.from_hot_jupiter()
    grid = Grid(planet, n_wl_bins=32, n_layers=6, T_ref=2400.0,
                dtype=jnp.float64)
    stack = grid.load_opacities(species=["H2O"],
                                path=str(cache_env / "*.ftop"))
    assert stack.species == ("1H2-16O",)       # species filter applied
    spec, *_ = grid.emission_spectrum(n_timesteps=1)
    assert np.all(np.isfinite(spec.flux_cgs))


def test_emission_before_load_raises():
    from frei_tpu import Grid, Planet

    grid = Grid(Planet.from_hot_jupiter(), n_wl_bins=16, n_layers=4)
    with pytest.raises(ValueError, match="load opacities"):
        grid.emission_spectrum()
    with pytest.raises(ValueError, match="load opacities"):
        grid.emission_spectra(np.zeros((2, 4)))


@pytest.mark.slow
def test_streaming_ingest_bounded_rss(cache_env):
    """Production-scale claim (VERDICT round-1 item 7): rebinning a
    cube much larger than the row chunk must stream through bounded
    memory, not load the cube.

    Generation and measurement run in SEPARATE subprocesses: an
    earlier version generated the cube in the measuring process, so
    the VmHWM baseline already contained the whole cube and the
    "bounded" assertion was vacuous (caught by the round-5 5 GB
    measurement, tools/etl_volume.py: peak RSS equalled the store
    size until `_rebin_store` learned to madvise(DONTNEED) processed
    chunks away).  The bound here is a small multiple of the chunk
    slab, NOT a fraction of the cube."""
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    gen = r"""
import numpy as np, sys
from frei_tpu.opacity.etl import make_synthetic_store
make_synthetic_store(sys.argv[1] + "/big.ftop", n_hr=1_500_000,
                     temps=tuple(np.linspace(500, 4000, 8)),
                     press_bar=tuple(np.logspace(-6, 2, 8)))
"""
    meas = r"""
import numpy as np, sys

def hwm_kb():
    for line in open("/proc/self/status"):
        if line.startswith("VmHWM"):
            return int(line.split()[1])
    raise RuntimeError

from frei_tpu.grids import make_rt_grid
from frei_tpu.opacity.etl import OpacityStore, _rebin_store

st = OpacityStore(sys.argv[1] + "/big.ftop")
cube_mb = st.cube.size * 4 / 1e6        # 8*8*1.5e6*4 = 384 MB
grid = make_rt_grid(n_wl_bins=200, n_layers=10)
import gc; gc.collect()
before = hwm_kb()
_rebin_store(st, grid, "native", row_chunk=4)
delta_mb = (hwm_kb() - before) / 1e3
print(f"CUBE_MB={cube_mb:.0f} DELTA_MB={delta_mb:.0f}")
# chunk slab = 4 rows x 1.5e6 x 4 B = 24 MB; allow kernel buffers +
# page-cache slack, but stay far below any store-sized residency
assert delta_mb < 120, (delta_mb, cube_mb)
"""
    from frei_tpu.native import native_available
    if not native_available():
        pytest.skip("no C++ toolchain for the native ETL engine")
    env = {**os.environ, "PYTHONPATH": str(repo), "JAX_PLATFORMS": "cpu"}
    for script in (gen, meas):
        r = subprocess.run(
            [sys.executable, "-c", script, str(cache_env)],
            capture_output=True, text=True, timeout=600,
            env=env, cwd=str(repo))
        assert r.returncode == 0, r.stdout + r.stderr
    assert "DELTA_MB" in r.stdout
