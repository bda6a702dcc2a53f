"""Sharded batched radiative-convective solves.

Runs the per-column solver (`frei_tpu.rt.solver.solve_rc`) over an
ensemble of atmospheric columns on a ('columns', 'bins') device mesh.
Sharding is declarative: inputs are placed with NamedShardings and the
vmapped solve is jitted once — XLA GSPMD partitions every sweep and
inserts the single per-sweep psum that the bolometric quadrature
requires across the bins axis (see frei_tpu.parallel.mesh).

Multi-host: call :func:`initialize_distributed` first (wraps
``jax.distributed.initialize``), then build the mesh over
``jax.devices()`` as usual — data placement and collectives are
identical, with cross-host traffic only for the bins axis if it spans
hosts (keep bins shards within a host: columns-major mesh order does
this by construction).
"""

from __future__ import annotations

import logging
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..opacity.tables import OpacityStack
from ..rt.physics import PhysicsParams
from ..rt.solver import RTConstants, RTResult, SolverConfig, solve_rc
from .mesh import BINS, COLUMNS, make_mesh

__all__ = ["initialize_distributed", "reuse_cache_stats",
           "shard_solver_inputs", "solve_ensemble", "solve_population"]

_log = logging.getLogger("frei_tpu.parallel")


def _flatten(x):
    if isinstance(x, tuple):
        for item in x:
            yield from _flatten(item)
    else:
        yield x


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Bring up the jax distributed runtime for multi-host pods.

    No-op on a single process.  Replaces the reference's vestigial
    dask-distributed backend (`core.py:22-31`).
    """
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def shard_solver_inputs(mesh: Mesh, consts: RTConstants,
                        stack: OpacityStack):
    """Place the per-configuration constants on the mesh.

    Wavelength-indexed vectors and the opacity table's wavelength axis
    are sharded across 'bins'; everything else is replicated.  For
    production-size tables (multi-GB per species, see
    `docs/frei/opacities.rst`) this is what makes the (species, T, P,
    wavelength) grid fit: each device holds only its spectral shard.
    """
    bins_vec = NamedSharding(mesh, P(BINS))
    repl = NamedSharding(mesh, P())
    stack_sh = NamedSharding(mesh, P(None, None, None, BINS))
    consts = RTConstants(
        lam_cm=jax.device_put(consts.lam_cm, bins_vec),
        trapz_w=jax.device_put(consts.trapz_w, bins_vec),
        pressures=jax.device_put(consts.pressures, repl),
        sigma_scat=jax.device_put(consts.sigma_scat, bins_vec),
        F_toa=jax.device_put(consts.F_toa, bins_vec),
    )
    stack = stack._replace(
        values=jax.device_put(stack.values, stack_sh),
        temps=jax.device_put(stack.temps, repl),
        press_cgs=jax.device_put(stack.press_cgs, repl),
    )
    return consts, stack


class _ReuseCache:
    """Identity-keyed reuse cache for the jitted sharded solvers.

    ``jax.jit`` keys its executable cache on the function OBJECT:
    rebuilding the ``shard_map`` closure on every call would retrace
    and recompile the whole sharded solve per invocation — in a
    retrieval / phase-curve loop that is minutes of XLA work per
    likelihood evaluation.  Entries are keyed on the caller-visible
    argument identities (``is`` for array-carrying objects: passing
    the SAME consts / stack / chem / params objects is exactly what
    makes reuse sound, since closure-captured arrays are baked into
    the trace) with ``==`` for hashable value objects (cfg, mesh,
    scalars).  Strong references are held, so a stored id cannot be
    recycled by the allocator; ``maxlen`` bounds retention.

    The failure mode of identity keying is SILENT: a loop that
    rebuilds ``Grid`` / ``RTConstants`` per step misses every time and
    pays a full XLA compile per iteration.  A miss
    whose value-keyed parts (cfg/mesh) AND array shapes equal a
    cached entry — the caller rebuilt equal input objects — logs a
    WARNING naming the reuse contract; hit/miss counters are exposed
    via :func:`reuse_cache_stats`.
    """

    _EQ_TYPES = (SolverConfig, Mesh, float, int, str, bool, type(None))

    def __init__(self, name: str = "solver", maxlen: int = 4):
        self._entries = []
        self._maxlen = maxlen
        self.name = name
        self.hits = 0
        self.misses = 0

    @classmethod
    def _match(cls, k1, k2):
        return len(k1) == len(k2) and all(
            (a is b) or (isinstance(a, cls._EQ_TYPES)
                         and type(a) is type(b) and a == b)
            for a, b in zip(k1, k2))

    def get(self, key):
        for k, v in self._entries:
            if self._match(k, key):
                self.hits += 1
                return v
        self.misses += 1
        sig = self._shape_sig(key)
        informative = any(s is not None for s in _flatten(sig))
        if informative and any(
                self._value_parts_equal(k, key)
                and self._shape_sig(k) == sig
                for k, _ in self._entries):
            # The footgun signature: a cached solver exists whose
            # value-keyed parts (cfg, mesh, scalars) are EQUAL and
            # whose array inputs have the SAME shapes, so the only
            # difference is object identity — the caller rebuilt
            # equal input objects between calls and is recompiling
            # work it meant to reuse.  Deliberately different
            # cfg/mesh/problem-size legs stay silent, and a key whose
            # shape signature carries no information (no
            # array-bearing components) never warns — the heuristic
            # cannot tell rebuilt-equal from genuinely-different
            # there.
            _log.warning(
                "%s reuse-cache MISS #%d (hits=%d): same cfg/mesh "
                "and input shapes as a cached solver, but the "
                "identity-keyed input objects are not the SAME "
                "objects — recompiling the sharded solve. Build the "
                "inputs once outside the loop and "
                "pass the same objects to reuse (docs/retrieval.md).",
                self.name, self.misses, self.hits)
        return None

    @classmethod
    def _value_parts_equal(cls, k1, k2):
        return len(k1) == len(k2) and all(
            (not isinstance(a, cls._EQ_TYPES))
            or (type(a) is type(b) and a == b)
            for a, b in zip(k1, k2))

    @staticmethod
    def _shape_sig(key):
        """Array-shape signature of a key's components (None for
        shapeless objects): two keys with different problem sizes are
        a legitimate recompile, not the rebuilt-inputs footgun."""
        def sig_of(k):
            if hasattr(k, "_fields"):     # NamedTuple of arrays
                return tuple(getattr(getattr(k, f), "shape", None)
                             for f in k._fields)
            # Grid-like driver objects: their problem size lives in
            # the RTConstants they carry (population-cache key)
            consts = getattr(k, "_consts", None)
            if consts is not None and hasattr(consts, "_fields"):
                return sig_of(consts)
            return getattr(k, "shape", None)
        return tuple(sig_of(k) for k in key)

    def put(self, key, value):
        self._entries.append((key, value))
        if len(self._entries) > self._maxlen:
            self._entries.pop(0)
        return value

    def stats(self):
        return {"hits": self.hits, "misses": self.misses,
                "entries": len(self._entries)}


_ENSEMBLE_CACHE = _ReuseCache("solve_ensemble")
_POPULATION_CACHE = _ReuseCache("solve_population")


def reuse_cache_stats() -> dict:
    """Hit/miss/entry counts of the compiled-solver reuse caches.

    A retrieval loop that is unexpectedly slow should check this
    first: ``misses`` growing with the iteration count means the loop
    rebuilds an input object every step and recompiles instead of
    reusing (the identity-key contract, docs/retrieval.md)."""
    return {c.name: c.stats()
            for c in (_ENSEMBLE_CACHE, _POPULATION_CACHE)}


def solve_ensemble(
    init_temps,              # (C, L) per-column initial profiles [K]
    consts: RTConstants,
    params: PhysicsParams,
    stack: OpacityStack,
    chem,
    cfg: SolverConfig = SolverConfig(),
    mesh: Optional[Mesh] = None,
) -> RTResult:
    """Solve an ensemble of columns, sharded over the mesh.

    Returns a batched :class:`RTResult` (leading columns axis on every
    field).  Columns that converge early are frozen in place while the
    rest keep iterating (identical per-column trajectories to
    single-column runs).

    The vmapped per-column solve runs under GSPMD: the columns axis
    needs no collectives, and on a bins-sharded mesh XLA inserts one
    psum per sweep for the bolometric quadrature (the scheme's only
    cross-bin collective).

    Repeat calls with the SAME consts / params / stack / chem objects
    (and equal cfg / mesh) reuse the placed tables and the compiled
    executable (:class:`_ReuseCache`) — a retrieval loop pays the
    sharding + kappa build + XLA compile once, not per likelihood
    evaluation.
    """
    if mesh is None:
        mesh = make_mesh()
    key = (consts, params, stack, chem, cfg, mesh)
    solver = _ENSEMBLE_CACHE.get(key)
    if solver is None:
        solver = _ENSEMBLE_CACHE.put(
            key, _build_ensemble_solver(consts, params, stack, chem,
                                        cfg, mesh))
    return solver(init_temps)


def _build_ensemble_solver(consts, params, stack, chem, cfg, mesh):
    """One-time construction for :func:`solve_ensemble`: input
    placement, hot-loop kappa wiring and the jitted GSPMD entry —
    returns ``solve(init_temps) -> RTResult``."""
    from ..opacity.hotpath import build_kappa_model
    from ..rt.solver import _check_engine

    _check_engine(cfg.engine)
    consts, stack = shard_solver_inputs(mesh, consts, stack)
    # Same shared hot-loop wiring as api.Grid (the chem tables are
    # replicated, so the factored closure is shard-safe).
    kappa_all = build_kappa_model(stack, chem, consts.pressures,
                                  consts.sigma_scat)
    cols = NamedSharding(mesh, P(COLUMNS))
    batched = jax.jit(
        jax.vmap(partial(solve_rc, consts=consts, params=params,
                         kappa_all=kappa_all, cfg=cfg)),
        in_shardings=(cols,),
    )
    return lambda T0: batched(jax.device_put(jnp.asarray(T0), cols))


def solve_population(init_temps, grid, planets,
                     cfg: SolverConfig = SolverConfig(),
                     mesh: Optional[Mesh] = None) -> RTResult:
    """Retrieval/phase-curve population solve: one atmosphere per
    PLANET, each with its own irradiation (T_star, a/R*), gravity and
    mixing-length alpha (the axes a retrieval or phase-curve grid
    varies), sharing the grid, opacities, chemistry and mean
    molecular weight (composition is shared, so sharing m_bar — which
    sets the Rayleigh scattering and MMR scale — is the physically
    consistent choice).

    Parameters
    ----------
    init_temps : (C, L) initial profiles [K], one per planet.
    grid : frei_tpu.api.Grid with opacities loaded.
    planets : sequence of C ``Planet`` objects.

    Returns a batched :class:`RTResult`.  Per-column results equal
    independent single-planet solves (cross-checked in
    tests/test_parallel.py).

    Runs through ``solve_rc_batched`` in per-column mode: per-planet
    F_toa rows and physics scalars are mapped with the sweeps.
    ``mesh`` shards the population over the 'columns' axis.
    """
    from ..rt.solver import solve_rc_batched

    pop_consts, params = _population_inputs(grid, planets)
    consts = grid._consts
    kappa_all = grid._kappa_fn
    dtype = consts.lam_cm.dtype
    init_temps = jnp.asarray(init_temps, dtype)

    if mesh is None:
        return solve_rc_batched(init_temps, pop_consts, params, kappa_all,
                                cfg)

    if mesh.shape[BINS] > 1:
        raise ValueError(
            "solve_population shards the 'columns' axis only; use a "
            "(n_columns, 1) mesh (per-planet F_toa rows are column "
            "state, not spectral constants)")

    # per-planet F_toa / g / alpha are ARGUMENTS of the sharded solve,
    # so the jitted executable is reusable across retrieval steps that
    # vary the planets: cache it on the grid-static closure inputs
    # kappa_all is in the key too: re-running grid.load_opacities()
    # swaps grid._kappa_fn on the SAME grid object
    m_bar = float(params.m_bar)
    key = (grid, kappa_all, m_bar, cfg, mesh)
    jfn = _POPULATION_CACHE.get(key)
    if jfn is None:
        def run(T0, ftoa_c, g_c, alpha_c):
            par = PhysicsParams(g=g_c, m_bar=jnp.asarray(m_bar, dtype),
                                alpha=alpha_c, n_dof=5)
            return solve_rc_batched(T0, consts._replace(F_toa=ftoa_c),
                                    par, kappa_all, cfg)

        from jax import shard_map
        fn = shard_map(
            run, mesh=mesh,
            in_specs=(P(COLUMNS), P(COLUMNS), P(COLUMNS), P(COLUMNS)),
            out_specs=RTResult(*([P(COLUMNS)] * len(RTResult._fields))),
            check_vma=False,
        )
        jfn = _POPULATION_CACHE.put(key, jax.jit(fn))
    cols = NamedSharding(mesh, P(COLUMNS))
    return jfn(*(jax.device_put(x, cols) for x in (
        init_temps, pop_consts.F_toa, params.g, params.alpha)))


def _population_inputs(grid, planets):
    """Per-planet solver inputs of :func:`solve_population`: the grid's
    constants with one F_toa row per planet, and (C,) gravity and
    mixing-length arrays beside the shared m_bar."""
    import numpy as np

    from ..stellar.irradiation import f_toa_np

    consts = grid._consts
    lam_cm = np.asarray(grid.rt_grid.lam_cm)
    dtype = consts.lam_cm.dtype
    f_toa = jnp.asarray(
        np.stack([f_toa_np(lam_cm, p.T_star, p.a_rstar)
                  for p in planets]), dtype)              # (C, W)
    m_bar = planets[0].m_bar
    if any(abs(p.m_bar - m_bar) > 1e-30 for p in planets):
        raise ValueError(
            "solve_population shares composition: all planets must "
            "have the same m_bar (it sets chemistry + Rayleigh); "
            "build separate grids for different compositions")
    params = PhysicsParams(
        g=jnp.asarray([p.g for p in planets], dtype),
        m_bar=jnp.asarray(m_bar, dtype),
        alpha=jnp.asarray([p.alpha for p in planets], dtype), n_dof=5)
    return consts._replace(F_toa=f_toa), params
