"""ETL at reference data volume: wall-clock + peak RSS at ~5 GB.

The reference's real line lists are multi-GB per species (H2O 6.5 GB,
TiO 4.8 GB, VO 5.6 GB — `/root/reference/docs/frei/opacities.rst`).
The round-4 streamed-ETL measurement used a 0.4 GB store; this tool
generates an H2O-SIZED synthetic store (default 28 T x 23 P x 2e6
wavelength samples = 5.15 GB float32, the DACE layout), then measures
the full public `binned_opacity_stack` path on it in a FRESH child
process, reporting wall-clock and the child's peak RSS (VmHWM).

Generation is chunked (one temperature row at a time through an
open_memmap), so building the store is itself RSS-bounded.
Measurement runs in a clean child so the baseline RSS cannot hide the
streaming behavior (a previous in-process measurement did exactly
that).

Usage:
  python tools/etl_volume.py                  # 5.15 GB single store
  python tools/etl_volume.py --two-species    # + a 1.1 GB Na-sized store
  python tools/etl_volume.py --n-hr 200000    # smoke-test size
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def generate_store(out_path, isotopologue, n_hr, temps, press_bar,
                   seed=7):
    """Row-chunked synthetic store (RSS-bounded generation lives in
    the library: `frei_tpu.opacity.etl.make_synthetic_store`)."""
    from frei_tpu.opacity.etl import make_synthetic_store

    return make_synthetic_store(
        out_path, isotopologue=isotopologue, n_hr=n_hr, temps=temps,
        press_bar=press_bar, seed=seed, linelist="synthetic-volume")


_MEASURE = r"""
import sys, time
def hwm_kb():
    for line in open("/proc/self/status"):
        if line.startswith("VmHWM"):
            return int(line.split()[1])
    raise RuntimeError("no VmHWM")

store_dir, engine = sys.argv[1], sys.argv[2]
base = hwm_kb()
# ETL is host-side: keep the tiny final device_put on the CPU, so the
# measurement never opens an accelerator
import jax
jax.config.update("jax_platforms", "cpu")
from frei_tpu.grids import make_rt_grid
from frei_tpu.opacity.etl import binned_opacity_stack
grid = make_rt_grid(n_wl_bins=500, n_layers=30)
after_import = hwm_kb()
t0 = time.perf_counter()
stack = binned_opacity_stack(grid, path=store_dir, engine=engine,
                             cache=False)
wall = time.perf_counter() - t0
import numpy as np
vals = np.asarray(stack.values)
assert np.all(np.isfinite(vals)), "non-finite binned opacity"
print(f"MEASURE wall_s={wall:.3f} hwm_mb={hwm_kb()/1e3:.0f} "
      f"import_mb={after_import/1e3:.0f} base_mb={base/1e3:.0f} "
      f"species={vals.shape[0]}")
"""


def measure(store_dir, engine, drop_caches=False):
    if drop_caches:
        try:
            subprocess.run(["sync"], check=True)
            Path("/proc/sys/vm/drop_caches").write_text("3")
            note = "cold page cache"
        except (PermissionError, OSError):
            note = "page cache NOT dropped (no permission)"
    else:
        note = "warm page cache"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", _MEASURE,
                        str(store_dir), engine],
                       capture_output=True, text=True, env=env,
                       timeout=3600)
    total = time.perf_counter() - t0
    if r.returncode != 0:
        print(r.stdout + r.stderr, file=sys.stderr)
        raise RuntimeError(f"measurement child failed rc={r.returncode}")
    line = [ln for ln in r.stdout.splitlines()
            if ln.startswith("MEASURE")][0]
    print(f"[etl_volume] engine={engine} {note}: {line} "
          f"(child total {total:.1f}s incl. imports)")
    return line


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="/tmp/frei_etl_volume")
    ap.add_argument("--n-hr", type=int, default=2_000_000)
    ap.add_argument("--nT", type=int, default=28)
    ap.add_argument("--nP", type=int, default=23)
    ap.add_argument("--engine", default="native")
    ap.add_argument("--two-species", action="store_true")
    ap.add_argument("--cold", action="store_true",
                    help="drop the page cache before measuring")
    args = ap.parse_args()

    base = Path(args.dir)
    h2o = base / "1H2-16O__volume.ftop"
    gb = args.nT * args.nP * args.n_hr * 4 / 1e9
    if not (h2o / "cube.npy").exists():
        print(f"[etl_volume] generating {gb:.2f} GB store at {h2o} ...")
        t0 = time.perf_counter()
        generate_store(h2o, "1H2-16O", args.n_hr,
                       tuple(np.linspace(100.0, 3500.0, args.nT)),
                       tuple(np.logspace(-8.0, 3.0, args.nP)))
        print(f"[etl_volume] generated in {time.perf_counter()-t0:.1f}s")
    if args.two_species:
        na = base / "23Na__volume.ftop"
        if not (na / "cube.npy").exists():
            # Na-sized (~300 MB-1 GB): fewer T points, same resolution
            generate_store(na, "23Na", args.n_hr,
                           tuple(np.linspace(1000.0, 3000.0, 6)),
                           tuple(np.logspace(-8.0, 3.0, args.nP)),
                           seed=11)
    print(f"[etl_volume] store bytes: "
          f"{sum(p.stat().st_size for p in base.rglob('*.npy'))/1e9:.2f}"
          " GB total")
    measure(base, args.engine, drop_caches=args.cold)


if __name__ == "__main__":
    main()
