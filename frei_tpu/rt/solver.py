"""Radiative-convective fixed-point solver.

Jit-compiled equivalent of the reference driver loop
(`/root/reference/frei/core.py:233-338`): alternate one-timestep
``emit`` / ``absorb`` sweeps, track the temperature history, declare a
layer converged once its temperature trajectory has oscillated (more
than ``n_zero_crossings`` sign changes of consecutive history
differences, `core.py:306-311`) or its last update is below
``convergence_dT``, and finish with one more ``emit`` for the output
spectrum (`core.py:323-333`).

Differences from the reference, by design:

* the whole iteration is a ``lax.while_loop`` under ``jit`` — no
  host-device ping-pong per timestep;
* the zero-crossing test is computed incrementally (running sign +
  flip counter per layer) instead of re-diffing the whole history
  matrix each iteration — algebraically identical for the reference's
  one-sweep-per-call usage;
* chemistry + opacity lookups are evaluated once per sweep for all
  layers (and all batched columns) instead of once per layer
  (`SURVEY.md` section 7, "chemistry hoisting") — numerically identical
  call pattern;
* once a column is converged its state is frozen with ``jnp.where``
  selects, which makes ``vmap`` over a batch of columns reproduce the
  per-column single-run trajectories exactly (the reference stops
  updating on convergence by breaking out of the loop);
* the final ``emit`` uses the configured mixing-length ``alpha``
  (the reference's final call silently falls back to the default
  ``alpha=1``, `core.py:323-333` — indistinguishable for the default
  hot-Jupiter setup).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from .physics import PhysicsParams
from .sweeps import absorb_sweep, emit_dtaus, emit_sweep

__all__ = ["SolverConfig", "RTConstants", "RTResult", "solve_rc",
           "solve_rc_batched"]


class SolverConfig(NamedTuple):
    """Static solver controls (compile-time constants)."""

    n_timesteps: int = 1           # max outer iterations (`core.py:233`)
    n_zero_crossings: int = 2      # oscillation threshold (`core.py:233`)
    convergence_dT: float = 3.0    # [K] (`core.py:233`)
    # Layer-recurrence engine: False = sequential lax.scan (the
    # default for typical layer counts L <~ 100), True =
    # lax.associative_scan (log-depth, for deep grids).  Both
    # orderings are bit-compatible with the reference.
    associative: bool = False
    progress: bool = False         # stream per-iteration telemetry
    # Sweep engine for the BATCHED solver (`solve_rc_batched`): "xla"
    # (vmapped rt.sweeps, the per-column trajectories of
    # vmap(solve_rc)) is the only engine; "auto" means the same thing.
    engine: str = "auto"
    # Reverse-mode differentiable solve (gradient-based retrieval —
    # a capability the reference's numpy + C++-FastChem pipeline
    # cannot offer).  The adaptive early-exit ``lax.while_loop`` has
    # no reverse-mode rule, so this runs the SAME body for a fixed
    # ``n_timesteps`` horizon under ``lax.scan`` with per-iteration
    # rematerialization (``jax.checkpoint``: backward-pass memory is
    # one iteration's state, not the whole unrolled trajectory).
    # Compiled alone it is bit-identical to the while_loop (converged
    # columns freeze through the same ``done`` selects; the loop just
    # keeps running frozen).  Compiled together with its backward pass
    # (``value_and_grad``), XLA may fuse the forward otherwise: float32
    # results then differ by rounding, which unconverged columns can
    # amplify (docs/retrieval.md).
    differentiable: bool = False
    # Iterations per rematerialization chunk of the differentiable
    # scan.  0 = auto (~sqrt(n_timesteps)); 1 = checkpoint every
    # iteration.  The scan saves its carry — two (B, L, W) flux slabs
    # — at every CHECKPOINT boundary for the backward pass, so
    # per-iteration checkpointing stores n_timesteps x ~1 GB at the
    # headline shape (8192 columns).  sqrt-chunking stores
    # n_timesteps/c boundary carries plus one chunk of inner carries
    # transiently (~(T/c + c) slabs, minimized at c ~ sqrt(T)); the
    # same body runs in the same order for every chunk size.
    remat_chunk: int = 0


class RTConstants(NamedTuple):
    """Per-configuration device constants."""

    lam_cm: jnp.ndarray       # (W,)
    trapz_w: jnp.ndarray      # (W,)
    pressures: jnp.ndarray    # (L,) BOA first [barye]
    sigma_scat: jnp.ndarray   # (W,) Rayleigh opacity [cm^2/g]
    F_toa: jnp.ndarray        # (W,) TOA stellar flux [erg/s/cm^3]


class RTResult(NamedTuple):
    flux: jnp.ndarray           # (W,) emergent spectrum F_up[-1]
    final_temps: jnp.ndarray    # (L,) temperatures after the final emit
    temp_history: jnp.ndarray   # (2*n_timesteps, L), zero-padded tail
    n_history: jnp.ndarray      # number of valid history rows
    dtaus: jnp.ndarray          # (L, W) optical depths from the final emit
    F_up: jnp.ndarray           # (L, W)
    F_down: jnp.ndarray         # (L, W)
    n_iterations: jnp.ndarray   # outer iterations actually run
    converged: jnp.ndarray      # per-layer convergence flags (L,) bool
    max_dT_history: jnp.ndarray  # (n_timesteps,) max |dT| per iteration [K]
    # pre-final-emit loop state — the exact resume point (the flux /
    # temps fields above are the FINAL EMIT's outputs; resuming from
    # those would apply emit twice in a row)
    loop_temps: jnp.ndarray     # (L,)
    loop_F_up: jnp.ndarray      # (L, W)
    loop_F_down: jnp.ndarray    # (L, W)


class _ConvState(NamedTuple):
    prev_T: jnp.ndarray      # last history column (L,)
    prev_sign: jnp.ndarray   # sign of last history diff (L,)
    flips: jnp.ndarray       # sign-flip counts (L,) int32
    n_cols: jnp.ndarray      # history columns recorded, int32


def _push_history(T_new, cs: _ConvState) -> _ConvState:
    """Record one temperature-history column and update the incremental
    zero-crossing statistics (equivalent to re-running
    `core.py:306-311` on the full history).

    Shape-generic: works for a single column (scalar ``n_cols``,
    (L,) statistics) and for a batch ((B,) ``n_cols``, (B, L)
    statistics) — the counter tests broadcast against the layer axis.
    """
    diff = T_new - cs.prev_T
    s = jnp.sign(diff)
    can_flip = jnp.expand_dims(cs.n_cols >= 2, -1)  # a previous diff exists
    has_diff = jnp.expand_dims(cs.n_cols >= 1, -1)  # this diff is valid
    flips = cs.flips + jnp.where(can_flip & (s != cs.prev_sign), 1, 0)
    prev_sign = jnp.where(has_diff, s, cs.prev_sign)
    return _ConvState(prev_T=T_new, prev_sign=prev_sign, flips=flips,
                      n_cols=cs.n_cols + 1)


@partial(jax.jit, static_argnames=("kappa_all", "cfg"))
def solve_rc(
    init_temps,
    consts: RTConstants,
    params: PhysicsParams,
    kappa_all: Callable,
    cfg: SolverConfig = SolverConfig(),
) -> RTResult:
    """Run the radiative-convective iteration for one column.

    Parameters
    ----------
    init_temps : (L,) initial temperature profile [K].
    kappa_all : callable ``(temps, pressures) -> (L, W)``
        Hoisted total-opacity lookup (chemistry + table interpolation +
        scattering) for all layers at the given temperatures.  Must be
        jit-traceable; it is re-evaluated before every sweep because the
        reference recomputes kappa with each sweep's temperatures.
    """
    L = init_temps.shape[0]
    W = consts.lam_cm.shape[0]
    dtype = init_temps.dtype
    n_hist = 2 * cfg.n_timesteps

    # Pin the physics scalars to the compute dtype so they do not
    # promote the while-loop carry (python floats arrive as float64
    # when x64 is enabled).
    params = PhysicsParams(
        g=jnp.asarray(params.g, dtype),
        m_bar=jnp.asarray(params.m_bar, dtype),
        alpha=jnp.asarray(params.alpha, dtype),
        n_dof=params.n_dof,
    )

    sweep_kw = dict(
        sigma_scat=consts.sigma_scat, F_toa=consts.F_toa,
        lam_cm=consts.lam_cm, trapz_w=consts.trapz_w,
        pressures=consts.pressures, params=params,
        associative=cfg.associative,
    )

    def body(carry):
        (it, temps, F_up, F_down, cs, hist, maxdT, conv, done) = carry

        k1 = kappa_all(temps, consts.pressures)
        e = emit_sweep(temps, F_up, F_down, k1, **sweep_kw)
        hist1 = hist.at[cs.n_cols].set(e.temps)
        cs1 = _push_history(e.temps, cs)

        k2 = kappa_all(e.temps, consts.pressures)
        a = absorb_sweep(e.temps, e.F_up, e.F_down, k2, **sweep_kw)
        hist2 = hist1.at[cs1.n_cols].set(a.temps)
        cs2 = _push_history(a.temps, cs1)

        conv_layers = ((cs2.flips > cfg.n_zero_crossings)
                       | (jnp.abs(a.dT) < cfg.convergence_dT))
        new_done = jnp.all(conv_layers)
        maxdT2 = maxdT.at[it].set(jnp.max(jnp.abs(a.dT)))
        if cfg.progress:
            from ..diag.telemetry import progress_printer
            jax.debug.callback(progress_printer, it,
                               jnp.max(jnp.abs(a.dT)),
                               jnp.sum(conv_layers), L)

        # Freeze converged columns (no-op for a single column: the
        # while cond exits before a frozen body would run; required for
        # correct batched semantics under vmap).
        def sel(new, old):
            return jnp.where(done, old, new)
        return (
            it + 1,
            sel(a.temps, temps),
            sel(a.F_up, F_up),
            sel(a.F_down, F_down),
            jax.tree.map(sel, cs2, cs),
            sel(hist2, hist),
            sel(maxdT2, maxdT),
            sel(conv_layers, conv),
            done | new_done,
        )

    def cond(carry):
        it = carry[0]
        done = carry[-1]
        return (it < cfg.n_timesteps) & jnp.logical_not(done)

    cs0 = _ConvState(
        prev_T=init_temps,
        prev_sign=jnp.zeros(L, dtype=dtype),
        flips=jnp.zeros(L, dtype=jnp.int32),
        n_cols=jnp.asarray(0, dtype=jnp.int32),
    )
    carry0 = (
        jnp.asarray(0, jnp.int32),
        init_temps,
        jnp.zeros((L, W), dtype=dtype),    # fluxes_up (`core.py:266`)
        jnp.zeros((L, W), dtype=dtype),    # fluxes_down (`core.py:265`)
        cs0,
        jnp.zeros((n_hist, L), dtype=dtype),
        jnp.zeros((cfg.n_timesteps,), dtype=dtype),
        jnp.zeros(L, dtype=bool),
        jnp.asarray(False),
    )
    if cfg.differentiable:
        # reverse-differentiable fixed-horizon form (see SolverConfig)
        _check_differentiable_cfg(cfg)

        def scan_body(carry, _):
            return body(carry), None

        carry_n, _ = lax.scan(jax.checkpoint(scan_body), carry0, None,
                              length=cfg.n_timesteps)
    else:
        carry_n = lax.while_loop(cond, body, carry0)
    (it, temps, F_up, F_down, cs, hist, maxdT, conv_layers, done) = carry_n

    # Final emit for the output spectrum (`core.py:323-333`).
    k = kappa_all(temps, consts.pressures)
    f = emit_sweep(temps, F_up, F_down, k, **sweep_kw)

    return RTResult(
        flux=f.F_up[-1],
        final_temps=f.temps,
        temp_history=hist,
        n_history=cs.n_cols,
        dtaus=f.dtaus,
        F_up=f.F_up,
        F_down=f.F_down,
        # == `it` on the while path (two history pushes per iteration);
        # on the differentiable fixed-horizon path `it` keeps counting
        # after convergence while the history counter stays frozen
        n_iterations=cs.n_cols // 2,
        converged=conv_layers,
        max_dT_history=maxdT,
        loop_temps=temps,
        loop_F_up=F_up,
        loop_F_down=F_down,
    )


def _check_differentiable_cfg(cfg) -> None:
    """Shared progress/autodiff interaction guard for both solvers."""
    if cfg.differentiable and cfg.progress:
        raise ValueError("cfg.progress streams through a debug "
                         "callback with no autodiff rule; disable it "
                         "for differentiable solves")


def _check_engine(engine: str) -> None:
    """Validate ``cfg.engine``: "auto" and "xla" both name the one
    sweep engine on every backend; any other name raises."""
    if engine in ("auto", "xla"):
        return
    if engine.startswith("pallas"):
        raise ValueError(
            f"sweep engine {engine!r} was removed together with the "
            "Pallas sweep kernels; use engine 'auto' or 'xla'")
    raise ValueError(f"unknown sweep engine {engine!r}; use engine "
                     "'auto' or 'xla'")


@partial(jax.jit, static_argnames=("kappa_all", "cfg"))
def solve_rc_batched(init_temps, consts, params, kappa_all,
                     cfg: SolverConfig = SolverConfig(),
                     init_fluxes=None):
    """Batch-native radiative-convective solve over (columns, layers)
    initial profiles.

    Same algorithm and per-column trajectories as
    ``jax.vmap(solve_rc)`` (cross-checked in tests), with the sweeps
    vmapped over the batch inside one ``lax.while_loop``.

    Batched-state notes (vs the per-column ``solve_rc``):

    * history rows are written at the uniform index ``2 it`` /
      ``2 it + 1`` — valid because an unconverged column has pushed
      exactly two rows per iteration, and converged columns' state is
      reverted by the ``done`` select (identical semantics to the
      vmapped per-column scatter);
    * the ``done`` select broadcasts per-column over trailing axes.

    ``init_fluxes``: optional (F_up, F_down) pair — (B, L, W) each —
    to warm-start the flux state (e.g. from a checkpointed
    ``RTResult``): together with the checkpointed temperatures this
    continues the solution trajectory exactly (the convergence
    statistics restart — they only affect the stopping rule).
    """
    B, L = init_temps.shape
    W = consts.lam_cm.shape[0]
    dtype = init_temps.dtype
    n_hist = 2 * cfg.n_timesteps
    _check_engine(cfg.engine)
    _check_differentiable_cfg(cfg)

    # Per-column (population) mode: any physics scalar may be a (B,)
    # array and consts.F_toa may be (B, W) — one planet per column
    # (reference `core.py:48-62`: F_TOA is the only per-planet spectral
    # input; g / alpha / m_bar enter the dtau factors and the timestep
    # physics).  Array fields are normalized to (B, 1) column vectors
    # so the epilogue physics broadcast against (B, L-1) layer arrays.
    # CAVEAT: a per-column m_bar reaches ONLY the dtau/timestep
    # physics — consts.sigma_scat (Rayleigh) and the MMR scale inside
    # kappa_all were built from the grid's single m_bar, so varying
    # composition per column needs per-column kappa/sigma too (use
    # parallel.solve_population, which guards this).
    # Size-1 arrays broadcast to (B, 1) and wrong lengths fail loudly.
    def _cols(x, name):
        x = jnp.asarray(x, dtype)
        if x.ndim == 0:
            return x
        x = x.reshape(-1, 1)
        if x.shape[0] == 1 and B > 1:
            x = jnp.broadcast_to(x, (B, 1))
        elif x.shape[0] != B:
            raise ValueError(
                f"per-column {name} has length {x.shape[0]}, expected "
                f"{B} (one per column) or a scalar")
        return x

    params = PhysicsParams(
        g=_cols(params.g, "params.g"),
        m_bar=_cols(params.m_bar, "params.m_bar"),
        alpha=_cols(params.alpha, "params.alpha"),
        n_dof=params.n_dof,
    )
    if consts.F_toa.ndim == 2:
        if consts.F_toa.shape[0] == 1 and B > 1:
            consts = consts._replace(
                F_toa=jnp.broadcast_to(consts.F_toa, (B, W)))
        elif consts.F_toa.shape[0] != B:
            raise ValueError(
                f"per-column F_toa has {consts.F_toa.shape[0]} rows, "
                f"expected {B} (one per column) or a 1-D shared row")
    per_column = (consts.F_toa.ndim == 2
                  or any(jnp.ndim(f) >= 1
                         for f in (params.g, params.m_bar, params.alpha)))

    common_kw = dict(
        sigma_scat=consts.sigma_scat,
        lam_cm=consts.lam_cm, trapz_w=consts.trapz_w,
        pressures=consts.pressures,
        associative=cfg.associative,
    )
    if per_column:
        # map the sweeps over per-column F_toa rows and physics
        # scalars too — inside the vmap each column sees plain
        # scalars, so per-column results are bit-identical to
        # independent ``solve_rc`` runs with those params
        ftoa_b = (consts.F_toa if consts.F_toa.ndim == 2
                  else jnp.broadcast_to(consts.F_toa, (B, W)))
        g_b = jnp.broadcast_to(jnp.ravel(params.g), (B,))
        m_b = jnp.broadcast_to(jnp.ravel(params.m_bar), (B,))
        a_b = jnp.broadcast_to(jnp.ravel(params.alpha), (B,))

        def _vmapped(sweep):
            def one(t, fu, fd, k, ft, g, m, al):
                par = PhysicsParams(g=g, m_bar=m, alpha=al,
                                    n_dof=params.n_dof)
                r = sweep(t, fu, fd, k, F_toa=ft, params=par,
                          **common_kw)
                return r.F_up, r.F_down, r.temps, r.dT

            def run(T, Fu, Fd, K):
                return jax.vmap(one)(T, Fu, Fd, K, ftoa_b, g_b,
                                     m_b, a_b)
            return run

        emit = _vmapped(emit_sweep)
        absorb = _vmapped(absorb_sweep)
    else:
        sweep_kw = dict(F_toa=consts.F_toa, params=params, **common_kw)

        def emit(T, Fu, Fd, K):
            r = jax.vmap(
                lambda t, fu, fd, k: emit_sweep(t, fu, fd, k, **sweep_kw)
            )(T, Fu, Fd, K)
            return r.F_up, r.F_down, r.temps, r.dT

        def absorb(T, Fu, Fd, K):
            r = jax.vmap(
                lambda t, fu, fd, k: absorb_sweep(t, fu, fd, k,
                                                  **sweep_kw)
            )(T, Fu, Fd, K)
            return r.F_up, r.F_down, r.temps, r.dT

    if cfg.differentiable:
        # per-sweep rematerialization (BOTH the shared-planet and the
        # per-column sweep variants): a sweep's layer scan carries ~10
        # (B, L, W) coupler/Planck intermediates; without this the
        # backward of ONE iteration holds both sweeps' sets at once
        # (docs/retrieval.md)
        emit = jax.checkpoint(emit)
        absorb = jax.checkpoint(absorb)

    def sel_like(done):
        def sel(new, old):
            mask = done.reshape(done.shape + (1,) * (new.ndim - done.ndim))
            return jnp.where(mask, old, new)
        return sel

    def kap_fn(temps):
        return kappa_all(temps, consts.pressures)

    def body(carry):
        (it, n_iters, temps, F_up, F_down, cs, hist, maxdT, conv,
         done) = carry

        k1 = kap_fn(temps)
        Fu1, Fd1, T1, dT1 = emit(temps, F_up, F_down, k1)
        k2 = kap_fn(T1)
        Fu2, Fd2, T2, dT2 = absorb(T1, Fu1, Fd1, k2)
        zero = jnp.asarray(0, it.dtype)
        hist1 = lax.dynamic_update_slice(hist, T1[:, None, :],
                                         (zero, 2 * it, zero))
        cs1 = _push_history(T1, cs)
        hist2 = lax.dynamic_update_slice(hist1, T2[:, None, :],
                                         (zero, 2 * it + 1, zero))
        cs2 = _push_history(T2, cs1)

        conv_layers = ((cs2.flips > cfg.n_zero_crossings)
                       | (jnp.abs(dT2) < cfg.convergence_dT))    # (B, L)
        new_done = jnp.all(conv_layers, axis=-1)                 # (B,)
        max_dT = jnp.max(jnp.abs(dT2), axis=-1)                  # (B,)
        maxdT2 = lax.dynamic_update_slice(maxdT, max_dT[:, None],
                                          (zero, it))
        if cfg.progress:
            from ..diag.telemetry import progress_printer
            jax.debug.callback(progress_printer, it,
                               jnp.max(jnp.abs(dT2)),
                               jnp.sum(jnp.all(conv_layers, 0)), L)

        sel = sel_like(done)
        return (
            it + 1,
            # per-column iteration counts, matching vmap(solve_rc)
            # semantics (a converged column's counter freezes)
            sel(jnp.full((B,), it + 1, jnp.int32), n_iters),
            sel(T2, temps),
            sel(Fu2, F_up),
            sel(Fd2, F_down),
            jax.tree.map(sel, cs2, cs),
            sel(hist2, hist),
            sel(maxdT2, maxdT),
            sel(conv_layers, conv),
            done | new_done,
        )

    def cond(carry):
        it = carry[0]
        done = carry[-1]
        return (it < cfg.n_timesteps) & jnp.logical_not(jnp.all(done))

    cs0 = _ConvState(
        prev_T=init_temps,
        prev_sign=jnp.zeros((B, L), dtype=dtype),
        flips=jnp.zeros((B, L), dtype=jnp.int32),
        n_cols=jnp.zeros((B,), dtype=jnp.int32),
    )
    if init_fluxes is None:
        F_up0 = jnp.zeros((B, L, W), dtype=dtype)
        F_down0 = jnp.zeros((B, L, W), dtype=dtype)
    else:
        F_up0 = jnp.asarray(init_fluxes[0], dtype)
        F_down0 = jnp.asarray(init_fluxes[1], dtype)

    carry0 = (
        jnp.asarray(0, jnp.int32),
        jnp.zeros((B,), jnp.int32),
        init_temps,
        F_up0,
        F_down0,
        cs0,
        jnp.zeros((B, n_hist, L), dtype=dtype),
        jnp.zeros((B, cfg.n_timesteps), dtype=dtype),
        jnp.zeros((B, L), dtype=bool),
        jnp.zeros((B,), dtype=bool),
    )
    if cfg.differentiable:
        # fixed-horizon scan with CHUNKED rematerialization:
        # reverse-differentiable, and the while_loop's body in the same
        # order (converged columns freeze through the same `done`
        # selects; see SolverConfig.differentiable on rounding).
        # Memory: the backward pass keeps the carry — two (B, L, W)
        # flux slabs — per checkpoint boundary, so chunking at
        # ~sqrt(T) iterations turns T slabs into ~2*sqrt(T)
        # (see SolverConfig.remat_chunk).
        T = cfg.n_timesteps
        if cfg.remat_chunk < 0:
            # divmod with a negative chunk would give lax.scan a
            # negative length, which runs ZERO iterations and returns
            # the un-iterated initial state as the "solution" —
            # silently wrong physics.  Refuse loudly.
            raise ValueError(
                f"remat_chunk must be >= 0 (0 = auto), got "
                f"{cfg.remat_chunk}")
        chunk = cfg.remat_chunk or max(1, int(round(T ** 0.5)))
        chunk = min(chunk, T)

        def run_steps(carry, n):
            # the inner body is checkpointed too: an un-checkpointed
            # inner scan's VJP saves every iteration's INTERMEDIATES
            # (~10 (B, L, W) slabs each), not just the carries
            def inner(c2, _):
                return body(c2), None
            return lax.scan(jax.checkpoint(inner), carry, None,
                            length=n)[0]

        n_full, rem = divmod(T, chunk)

        @jax.checkpoint
        def chunk_body(carry, _):
            return run_steps(carry, chunk), None

        carry_n, _ = lax.scan(chunk_body, carry0, None, length=n_full)
        if rem:
            carry_n = jax.checkpoint(
                lambda c2: run_steps(c2, rem))(carry_n)
    else:
        carry_n = lax.while_loop(cond, body, carry0)
    (it, n_iters, temps, F_up, F_down, cs, hist, maxdT, conv_layers,
     done) = carry_n

    # Final emit for the output spectrum (`core.py:323-333`), plus the
    # dtaus diagnostic (one cheap pass, once per solve).
    k_f = kap_fn(temps)
    Fu_f, Fd_f, T_f, _ = emit(temps, F_up, F_down, k_f)
    dtaus = emit_dtaus(k_f, consts.pressures, params)

    return RTResult(
        flux=Fu_f[:, -1],
        final_temps=T_f,
        temp_history=hist,
        n_history=cs.n_cols,
        dtaus=dtaus,
        F_up=Fu_f,
        F_down=Fd_f,
        n_iterations=n_iters,
        converged=conv_layers,
        max_dT_history=maxdT,
        loop_temps=temps,
        loop_F_up=F_up,
        loop_F_down=F_down,
    )
