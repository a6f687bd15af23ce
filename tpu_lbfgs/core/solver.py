"""The L-BFGS solver loop, fully on-device.

Reference counterpart: the CPU loop (sequential-implementation/lbfgs.cpp:72-199)
and the GPU loops (e.g. parallel-implementation/L-BFGS.cu:195-357).  The
reference crosses the host<->device boundary at least four times per iteration
plus once per line-search trial (SURVEY.md §3.2); here the ENTIRE solve —
direction, line search, objective/gradient evaluation, history update,
convergence check — is one jitted ``lax.while_loop``, so the host is touched
exactly twice per solve (dispatch + result fetch).

Iteration semantics mirrored from lbfgs.cpp:
  1. converge when ||g|| < tol                         (:80-84)
  2. d = -H g via two-loop (guards -> -g)              (:86-144)
  3. descent-direction safeguard: g.d >= 0 -> d = -g   (:147-153)
  4. alpha = line_search(x, d)                         (:156)
  5. x_new, f_new; alpha < 1e-10 -> bail with old x    (:159-168)
  6. g_new; store (s, y) only when s.y > 0, ring-capped at m  (:171-195)

Design notes:
  - State is a fixed-shape pytree (types.LBFGSState); the step function is a
    pure ``state -> state`` map, so ``jax.vmap`` batches thousands of
    independent instances per device (done lanes freeze automatically under
    vmapped while_loop) and d-axis sharding partitions huge instances with
    XLA inserting the psums for every dot product.
  - s.y and y.y are computed once, fused with the pair update, and cached in
    the state (sy_hist/yy_hist) — the reference recomputes them inside the
    two-loop every iteration (L-BFGS.cu:219-220,237-244).
  - ||g_new|| is computed fused with the gradient update so the while-loop
    condition reads a cached scalar instead of re-streaming g.
"""
from __future__ import annotations

import os
from functools import lru_cache, partial
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import Array, lax

from ..config import LBFGSConfig
from ..kernels.tail import history_matvecs, pair_scalars
from ..linesearch.strategies import get_line_search
from ..types import Guard, LBFGSState, SolveResult, Status, Trace, hist_block
from .direction import compute_direction_with_aux

HIGHEST = lax.Precision.HIGHEST

ObjFn = Callable[[Array], Array]
ValGradFn = Callable[[Array], Tuple[Array, Array]]

# Measurement-only A/B switch (read at trace time): set
# TPU_LBFGS_NO_GUARD_COUNTERS=1 to drop the per-iteration guard-counter
# stack from the hot loop — used to attribute headline-throughput deltas to
# the round-4 counter addition vs environment (scripts/headline_ab).  Never
# set in production: guards arrive as zeros and the CLI verbose replay goes
# blind.
_COUNT_GUARDS = os.environ.get("TPU_LBFGS_NO_GUARD_COUNTERS", "") != "1"


def resolve_history_dtype(history_dtype, m: int, d: int, dtype,
                          batch: int = 1) -> object:
    """Resolve history_dtype="auto" (see init_state docstring).

    "auto" keeps the ring in the input dtype (None): no size rule for a
    bfloat16 ring has been measured on the GPU yet (ROADMAP S5), so the
    exact choice is the default.  ``m``, ``d`` and ``batch`` (per-device
    vmapped lane count) are the inputs such a rule keys on; callers pass
    them already."""
    if history_dtype != "auto":
        return history_dtype
    return None


def iteration_tail(x: Array, d: Array, alpha: Array, g: Array,
                   g_new: Array, accurate: bool = False):
    """(x_new, s, y, s.y, y.y, ||g_new||^2, d.g_new, g.g_new, y.g_new):
    the pair and convergence scalars of one iteration, as one expression
    XLA fuses into a multi-output reduction (x_new is re-derived, not read
    back).  Replaces the reference's updateSolution + updateVectors kernels
    plus separate cuBLAS Ddots (L-BFGS.cu:55-63,19-31,219-244,345-348).
    ``accurate``: Neumaier-compensated reductions (cfg.accurate_dots)."""
    s = alpha * d
    return (x + s, s) + pair_scalars(s, d, g, g_new, accurate)


def init_state(vg: ValGradFn, x0: Array, m: int,
               history_dtype=None) -> LBFGSState:
    """Build the initial solver state; evaluates f and grad once at x0
    (lbfgs.cpp:29-30).  history_dtype optionally down-casts the (m, d) ring
    storage (cfg.history_dtype, e.g. "bfloat16").

    history_dtype="auto" is resolved by resolve_history_dtype (currently
    the input dtype)."""
    x0 = jnp.asarray(x0)
    dtype = x0.dtype
    history_dtype = resolve_history_dtype(history_dtype, m, x0.shape[-1],
                                          dtype)
    hdtype = jnp.dtype(history_dtype) if history_dtype else dtype
    d = x0.shape[-1]
    R, L = hist_block(d)
    f0, g0 = vg(x0)
    i32 = lambda v: jnp.asarray(v, jnp.int32)
    return LBFGSState(
        x=x0,
        f=f0,
        g=g0,
        g_norm=jnp.sqrt(jnp.vdot(g0, g0)),
        s_hist=jnp.zeros((m, R, L), hdtype),
        y_hist=jnp.zeros((m, R, L), hdtype),
        sy_hist=jnp.ones((m,), dtype),
        yy_hist=jnp.ones((m,), dtype),
        SY=jnp.zeros((m, m), dtype),
        YY=jnp.zeros((m, m), dtype),
        Sg=jnp.zeros((m,), dtype),
        Yg=jnp.zeros((m,), dtype),
        n_pairs=i32(0),
        k=i32(0),
        status=i32(Status.RUNNING),
        alpha=jnp.asarray(0.0, dtype),
        n_fev=i32(1),
        n_gev=i32(1),
        guards=jnp.zeros((Guard.N,), jnp.int32),
    )


def _polyval(coeffs: Array, a: Array) -> Array:
    """Horner evaluation, ascending coefficients, static degree."""
    n = coeffs.shape[0]
    acc = coeffs[n - 1]
    for k in range(n - 2, -1, -1):
        acc = acc * a + coeffs[k]
    return acc


def _polyder(coeffs: Array) -> Array:
    n = coeffs.shape[0]
    return coeffs[1:] * jnp.arange(1, n, dtype=coeffs.dtype)


def make_phi(cfg: LBFGSConfig, f: ObjFn, vg: ValGradFn, x: Array, d: Array,
             dir_poly=None, phi_batch=None, phi_dphi_batch=None):
    """Build the 1-D line-search interface phi / phi_dphi.

    "direct": each trial streams the full vector (trial point fused into the
    objective by XLA).  "polynomial": one fused pass over (x, d) yields the
    phi coefficients; trials are scalar Horner evaluations and phi' is the
    exact derivative polynomial — no gradient evaluations inside the search.

    phi is vector-capable: called with a (K,) alpha batch it returns (K,)
    values — Horner broadcasts natively; direct mode uses ``phi_batch``
    (problems.suite.multi_phi_for: one fused pass evaluates all K trial
    points) when provided, else a vmapped objective.  The speculative line
    search relies on this.
    """
    if cfg.ls_eval == "polynomial":
        if dir_poly is None:
            raise ValueError("ls_eval='polynomial' requires dir_poly "
                             "(see Problem.dir_poly)")
        coeffs = dir_poly(x, d)
        dcoeffs = _polyder(coeffs)

        def phi(a):
            return _polyval(coeffs, a)

        def phi_dphi(a):
            return _polyval(coeffs, a), _polyval(dcoeffs, a)

        return phi, phi_dphi

    def phi(a):
        a = jnp.asarray(a)
        if a.ndim == 0:
            return f(x + a * d)
        if phi_batch is not None:
            return phi_batch(x, d, a)
        return jax.vmap(lambda aa: f(x + aa * d))(a)

    def phi_dphi(a):
        a = jnp.asarray(a)
        if a.ndim == 0:
            f_new, g_new = vg(x + a * d)
            return f_new, jnp.vdot(g_new, d)
        # Vector-capable (K,) trials for the speculative Wolfe searches:
        # one fused pass via kernels.make_multi_phi_dphi when provided.
        if phi_dphi_batch is not None:
            return phi_dphi_batch(x, d, a)

        def one(aa):
            f_new, g_new = vg(x + aa * d)
            return f_new, jnp.vdot(g_new, d)

        return jax.vmap(one)(a)

    return phi, phi_dphi


def iterate(cfg: LBFGSConfig, f: ObjFn, vg: ValGradFn,
            state: LBFGSState, dir_poly=None, fused_tail=None,
            phi_batch=None, phi_dphi_batch=None) -> LBFGSState:
    """One unconditional L-BFGS iteration (assumes status == RUNNING).

    fused_tail: optional single-stream post-line-search tail (see
    problems.suite.fused_tail_for / kernels.make_fused_tail); when given it
    replaces the x_new + vg + iteration_tail + history-matvec chain with one
    kernel.  Under cfg.accurate_dots the tail must have been built with
    accurate_dots=True (in-kernel Neumaier compensation); a plain tail is
    rejected rather than silently dropping the compensation.
    phi_batch: optional batched trial evaluator (problems.suite.multi_phi_for)
    used by the speculative line search under ls_eval="direct".
    """
    if cfg.accurate_dots and fused_tail is not None \
            and not getattr(fused_tail, "accurate_dots", False):
        # The compensated kernels exist (kernels.make_fused_tail
        # accurate_dots=True / fused_tail_for(..., accurate_dots=True)) —
        # but silently running a PLAIN tail under cfg.accurate_dots would
        # drop the requested Neumaier compensation exactly where it was
        # asked for (giant-d f32).
        raise ValueError(
            "cfg.accurate_dots requires a fused tail built with "
            "accurate_dots=True (fused_tail_for(..., accurate_dots=True))")
    m = state.s_hist.shape[0]
    x, g = state.x, state.g

    # --- search direction with descent safeguard (lbfgs.cpp:147-153) ---------
    d, aux, dir_fallback = compute_direction_with_aux(cfg, state)
    # Compact paths derive phi'(0) from the direction coefficients in O(m)
    # scalar work (DirAux.g_dot_d) instead of a 2-pass full-vector reduction.
    g_dot_d = jnp.vdot(g, d) if aux is None else aux.g_dot_d
    not_descent = g_dot_d >= 0
    d = jnp.where(not_descent, -g, d)
    g_dot_d = jnp.where(not_descent, -state.g_norm * state.g_norm, g_dot_d)

    # --- line search ----------------------------------------------------------
    phi, phi_dphi = make_phi(cfg, f, vg, x, d, dir_poly, phi_batch,
                             phi_dphi_batch)
    line_search = get_line_search(cfg.line_search)
    ls = line_search(cfg, phi, phi_dphi, state.f, g_dot_d)
    alpha = ls.alpha

    # --- trial point & failure bail (lbfgs.cpp:159-168) ----------------------
    step_failed = alpha < cfg.step_fail_tol
    hdtype = state.s_hist.dtype
    t1_pre = t2_pre = None
    damp_fired = jnp.bool_(False)
    theta = one_m = None
    if fused_tail is not None:
        # Single HBM stream: x_new, f_new, g_new, ring rows (history dtype),
        # all pair/convergence scalars, and the pre-update history matvecs
        # against the RAW y_new (the kernel computes y = g_new - g; damping
        # blends post-kernel below).
        (x_new, f_new, g_new, s_h, y_h, sy, yy, gg_new, dgn, ggn, ygn,
         t1_pre, t2_pre) = fused_tail(x, d, alpha, g,
                                      state.s_hist, state.y_hist)
        # s.s for the damping threshold: alpha^2 * d.d — one extra pass over
        # d, only when damping is configured (XLA fuses it with d's other
        # consumers).
        ss = alpha * alpha * jnp.vdot(d, d) if cfg.damping is not None \
            else None
        y_raw_h = y_h
    else:
        x_new = x + alpha * d
        f_new, g_new = vg(x_new)

        # --- curvature pair, fused scalars (lbfgs.cpp:174-181) ---------------
        x_new, s, y, sy, yy, gg_new, dgn, ggn, ygn = iteration_tail(
            x, d, alpha, g, g_new, accurate=cfg.accurate_dots)
        if cfg.damping is None:
            ss = None
        elif cfg.accurate_dots:
            from ..utils.accurate import compensated_dot
            ss = compensated_dot(s, s)
        else:
            ss = jnp.vdot(s, s, precision=HIGHEST)
        s_h = s.astype(hdtype)
        y_h = y_raw_h = y.astype(hdtype)

    if cfg.damping is not None:
        # Powell damping with B0 = I/gamma (config.py docstring): blend
        # y_bar = theta*y + (1-theta)*s/gamma when s.y < mu * s.s/gamma.
        # Runs uniformly AFTER either tail (plain, fused, sharded):
        # the blended scalars follow algebraically from the raw tail
        # reductions —
        #   s.y_bar     = theta*sy  + (1-theta)*ss/gamma
        #   y_bar.y_bar = theta^2*yy + 2 theta(1-theta) sy/gamma
        #                 + ((1-theta)/gamma)^2 ss
        #   y_bar.g_new = theta*ygn + (1-theta)*(s.g_new)/gamma,
        #   s.g_new = alpha * dgn
        # — and the only array work is the (R, L) ring-row blend.  The RAW
        # ygn/u1/u2 stay available for the incremental Sg/Yg advance (whose
        # invariant is over the raw gradient difference g_new = g + y_raw).
        from .direction import _gamma

        gamma_p = _gamma(state, m)         # 1.0 before the first pair
        sBs = ss / gamma_p
        mu = jnp.asarray(cfg.damping, sy.dtype)
        damp_fired = sy < mu * sBs
        denom = sBs - sy
        theta = jnp.where(damp_fired & (denom > 0) & jnp.isfinite(denom),
                          (1.0 - mu) * sBs / jnp.where(denom > 0, denom,
                                                       1.0),
                          1.0)
        one_m = (1.0 - theta) / gamma_p
        if fused_tail is None:
            # Raw f32/f64 s, y still live: blend at full precision, then
            # cast once.
            y_h = (theta * y + one_m * s).astype(hdtype)
        else:
            # Fused path: blend the kernel's history-dtype rows (one row
            # read + write; the stored row is hdtype-rounded either way).
            fdt = x.dtype
            y_h = (theta * y_h.astype(fdt)
                   + one_m * s_h.astype(fdt)).astype(hdtype)
        ygn = theta * ygn + one_m * (alpha * dgn)
        yy = theta * theta * yy + 2.0 * theta * one_m * sy \
            + one_m * one_m * ss
        sy = theta * sy + one_m * ss
        damp_fired = damp_fired & (theta < 1.0)
    # Non-finite trial rejection: under ls_eval="polynomial" the acceptance
    # decisions use the closed-form phi, whose f32 evaluation can misjudge a
    # knife-edge step that sends the TRUE f to inf/nan (observed on ~4/4096
    # vmapped Rosenbrock lanes); under fidelity="reference" the sign-flipped
    # Armijo (line_search.cpp:24) can accept genuine increases.  The C++
    # reference would silently continue on garbage; here the lane freezes at
    # its last finite state with LINE_SEARCH_FAILED.
    # ``~RUNNING`` folds into the freeze so finished lanes are frozen even if
    # their recomputation were somehow non-deterministic (see the idempotence
    # note at the guard-counter block below).
    failed = (step_failed | ~jnp.isfinite(f_new) | ~jnp.isfinite(gg_new)
              | (state.status != Status.RUNNING))
    store = ~failed & (sy > cfg.curvature_threshold)

    slot = (state.n_pairs % m).astype(jnp.int32)
    # Row-masked ring update: only slot's (R, L) block moves, and only when
    # storing.  (An out-of-bounds + mode="drop" formulation that skips the
    # old-row read was measured: ~equal runtime, but it ballooned XLA
    # compile from ~15 s to 140-515 s on the batched program — rejected;
    # batch_opt_results.json ring cells.)
    blk = state.s_hist.shape[1:]
    s_row = jnp.where(store, s_h.reshape(blk), state.s_hist[slot])
    y_row = jnp.where(store, y_h.reshape(blk), state.y_hist[slot])
    s_hist = state.s_hist.at[slot].set(s_row)
    y_hist = state.y_hist.at[slot].set(y_row)
    # Small per-slot scalars: iota==slot selects, not scatters (a batched
    # (m,) scatter lowers to a slow scatter op; the select is pure vector
    # arithmetic — scripts/batch_opt.py old_small cell).
    iota_m = jnp.arange(m, dtype=jnp.int32)
    sel = (iota_m == slot) & store
    sy_hist = jnp.where(sel, sy, state.sy_hist)
    yy_hist = jnp.where(sel, yy, state.yy_hist)

    # --- incremental history products (direction="compact_incremental") -----
    # Maintains SY = S.Y', YY = Y.Y', Sg = S.g, Yg = Y.g across iterations so
    # the direction never re-contracts the (m, d) history against g; the one
    # fresh contraction per iteration is against the new curvature pair
    # (u1 = S@y_new, u2 = Y@y_new).  An earlier formulation built s_i.y_new
    # as (S@g_new) - (S@g): catastrophic cancellation when ||y|| << ||g||,
    # observed as degenerate directions on ~1/1000 f32 Rosenbrock lanes.
    if cfg.direction == "compact_incremental":
        if t1_pre is not None:
            # From the fused tail, contracted over the PRE-update rows: rows
            # other than slot are unchanged by the ring write, and the slot
            # entries are overwritten from scalars below — identical result.
            u1, u2 = t1_pre, t2_pre
        else:
            # One fresh contraction per iteration, against the new pair's
            # RAW y (u1 = S @ y_raw, u2 = Y @ y_raw over the (R, L) row
            # blocks): the Sg/Yg advance below requires the raw gradient
            # difference (g_new = g + y_raw), NOT the damped y_bar — using
            # the damped row here silently corrupted every off-slot Sg/Yg
            # entry on damped iterations (round-4 advisor finding).
            # y stays in history dtype so the operands match (bf16 x bf16 ->
            # f32 accumulate); HIGHEST keeps f32 products out of TF32.
            u1, u2 = history_matvecs(state.s_hist, state.y_hist, y_raw_h,
                                     g.dtype)
        # Sg/Yg advance additively: s_i.g_new = s_i.g + s_i.y_raw; the slot
        # entries come from the exact tail reductions (Yg[slot] is the
        # STORED row's dot, i.e. the damped y_bar.g_new when damping fired).
        # ``sel`` = (iota==slot & store): select-based slot patch.
        Sg_next = jnp.where(sel, alpha * dgn, state.Sg + u1)
        Yg_next = jnp.where(sel, ygn, state.Yg + u2)

        # New column of SY / YY: s_i . y_new / y_i . y_new over the STORED
        # y_new row.  Undamped, that is exactly u1/u2; when damping fired,
        # the stored row is y_bar = theta*y_raw + one_m*s_new, so the column
        # blends u1/u2 with the two extra contractions S@s_new / Y@s_new
        # (cfg.damping is static: the contractions exist only in damped
        # programs).  Diagonals from the exact tail scalars.  SY[slot, :]
        # (s_new . y_older) lies strictly below the diagonal in logical
        # order and is never read by the compact algebra (R = triu) — left
        # stale by design.
        if cfg.damping is not None:
            us1, us2 = history_matvecs(state.s_hist, state.y_hist, s_h,
                                       g.dtype)
            col1 = theta * u1 + one_m * us1
            col2 = theta * u2 + one_m * us2
        else:
            col1, col2 = u1, u2
        # Column/row writes as iota==slot selects (same reasoning as the
        # per-slot scalars above).
        is_slot = iota_m == slot
        sy_col = jnp.where(is_slot, sy, col1)
        yy_col = jnp.where(is_slot, yy, col2)
        SY_next = jnp.where(is_slot[None, :], sy_col[:, None], state.SY)
        YY_next = jnp.where(is_slot[None, :], yy_col[:, None], state.YY)
        YY_next = jnp.where(is_slot[:, None], yy_col[None, :], YY_next)

        SY_next = jnp.where(store, SY_next, state.SY)
        YY_next = jnp.where(store, YY_next, state.YY)
        # Freeze everything on line-search failure (g does not advance).
        SY_next = jnp.where(failed, state.SY, SY_next)
        YY_next = jnp.where(failed, state.YY, YY_next)
        Sg_next = jnp.where(failed, state.Sg, Sg_next)
        Yg_next = jnp.where(failed, state.Yg, Yg_next)

        # Drift refresh is NOT done here: solve_from_state splits the run
        # into while_loop segments and recomputes the products BETWEEN
        # segments (cfg.refresh_interval), so no in-loop conditional sits
        # on the per-iteration path (ROADMAP D3 queues an A/B against an
        # in-loop lax.cond on the GPU).
    else:
        SY_next, YY_next = state.SY, state.YY
        Sg_next, Yg_next = state.Sg, state.Yg

    # --- safeguard-activation counters (types.Guard): the device-side
    # replacement for the reference's per-event warnings (lbfgs.cpp:105,121,
    # 150,194; parallel line_search.cpp:38-41) --------------------------------
    # ``active`` gates every scalar-counter advance: a lane whose status is
    # already terminal re-freezes its x/f/g/history deterministically when
    # iterate runs again (the same failing search repeats), so gating the
    # counters makes iterate IDEMPOTENT on finished lanes — which lets
    # bounded (cond-free) batch loops skip the vmapped while_loop's
    # per-iteration full-state masking (batch.vmapped lockstep="bounded").
    # In the single-instance while_loop path active is always True.
    active = state.status == Status.RUNNING
    b2i = lambda b: jnp.asarray(b & active, jnp.int32)
    guards = state.guards if not _COUNT_GUARDS else state.guards + jnp.stack([
        # Empty-history steepest descent is the normal start, not a warning
        # event (the reference warns only on invalid rho/gamma,
        # lbfgs.cpp:105,121).
        b2i(dir_fallback & (state.hist_len > 0)),
        b2i(not_descent),
        b2i(~failed & (sy <= cfg.curvature_threshold)),
        jnp.asarray(ls.rescued, jnp.int32) * active.astype(jnp.int32),
        b2i(failed),
        b2i(damp_fired & ~failed),
    ])

    # --- advance (freeze x/g/f on line-search failure: the reference returns
    # the pre-step iterate, lbfgs.cpp:167) ------------------------------------
    g_norm_new = jnp.sqrt(gg_new)
    return LBFGSState(
        x=jnp.where(failed, x, x_new),
        f=jnp.where(failed, state.f, f_new),
        g=jnp.where(failed, g, g_new),
        g_norm=jnp.where(failed, state.g_norm, g_norm_new),
        s_hist=s_hist,
        y_hist=y_hist,
        sy_hist=sy_hist,
        yy_hist=yy_hist,
        SY=SY_next,
        YY=YY_next,
        Sg=Sg_next,
        Yg=Yg_next,
        n_pairs=state.n_pairs + store.astype(jnp.int32),
        k=state.k + active.astype(jnp.int32),
        status=jnp.where(active,
                         jnp.where(failed, Status.LINE_SEARCH_FAILED,
                                   Status.RUNNING),
                         state.status).astype(jnp.int32),
        alpha=jnp.where(active, alpha, state.alpha),
        # The reference evaluates f once more after the search (lbfgs.cpp:161)
        # and grad once (lbfgs.cpp:171); our fused vg counts one of each.
        # In polynomial mode the search's trials are O(1) scalar evaluations,
        # not objective/gradient evaluations — only the single dir_poly
        # coefficient pass (~1 f-eval of memory traffic) is charged.
        n_fev=state.n_fev + active.astype(jnp.int32)
        * (1 + (ls.n_fev if cfg.ls_eval == "direct" else 1)),
        n_gev=state.n_gev + active.astype(jnp.int32)
        * (1 + (ls.n_gev if cfg.ls_eval == "direct" else 0)),
        guards=guards,
    )


def _finalize_status(cfg: LBFGSConfig, state: LBFGSState) -> Array:
    # g_norm < tol wins over every other status, INCLUDING
    # LINE_SEARCH_FAILED: under solve_bounded a lane that reaches tol keeps
    # iterating (no per-iteration convergence cond), and a later
    # near-optimum line-search underflow freezes it with FAILED — but the
    # lane froze AT a point satisfying tol, which the 'while' formulation
    # reports as CONVERGED.  For the while_loop path this ordering is a
    # no-op: a failed lane froze its g BEFORE reaching tol (the loop never
    # iterates a lane whose g_norm is already < tol), so its g_norm is
    # still >= tol here.
    return jnp.where(
        state.g_norm < cfg.tol, Status.CONVERGED,
        jnp.where(state.status != Status.RUNNING, state.status,
                  Status.MAX_ITERS)).astype(jnp.int32)


def _running(cfg: LBFGSConfig, state: LBFGSState) -> Array:
    return ((state.status == Status.RUNNING)
            & (state.g_norm >= cfg.tol)
            & (state.k < cfg.max_iters))


def refresh_products(state: LBFGSState) -> LBFGSState:
    """Recompute the incremental history products SY/YY/Sg/Yg from the
    stored (m, R, L) rows and the current gradient — exactly the ``compact``
    path's contractions — zeroing the additive f32 drift that
    ``compact_incremental`` accumulates in the off-diagonal entries.  The
    curvature-critical diagonals are restored from the per-slot EXACT tail
    scalars (sy_hist/yy_hist), which are strictly more accurate than a
    re-contraction (especially with a bfloat16 history).

    Called between solve segments (solve_from_state with
    cfg.refresh_interval), never inside the hot loop.
    """
    from .direction import history_products
    SY, YY, Sg, Yg = history_products(state)
    m = SY.shape[0]
    idx = jnp.arange(m)
    SY = SY.at[idx, idx].set(state.sy_hist)
    YY = YY.at[idx, idx].set(state.yy_hist)
    return state._replace(SY=SY, YY=YY, Sg=Sg, Yg=Yg)


def solve_from_state(cfg: LBFGSConfig, f: ObjFn, vg: ValGradFn,
                     state: LBFGSState, dir_poly=None,
                     fused_tail=None, phi_batch=None,
                     phi_dphi_batch=None) -> LBFGSState:
    """Run the while_loop from an arbitrary state (also used for resume from
    checkpoint).  Returns the terminal state with status finalized.

    With cfg.refresh_interval set (compact_incremental only), the run is
    split into nested while_loops: an inner loop of up to refresh_interval
    iterations, an outer loop that recomputes the history products between
    segments (refresh_products).  The contractions therefore run once per
    SEGMENT — amortized to ~(2m passes / interval) extra traffic.
    """
    if cfg.record_trace:
        return _solve_traced(cfg, f, vg, state, dir_poly, fused_tail,
                             phi_batch, phi_dphi_batch)[0]
    body = lambda s: iterate(cfg, f, vg, s, dir_poly, fused_tail, phi_batch,
                             phi_dphi_batch)
    if cfg.refresh_interval is not None \
            and cfg.direction == "compact_incremental":
        chunk = jnp.asarray(cfg.refresh_interval, jnp.int32)

        def segment(s: LBFGSState) -> LBFGSState:
            k_cap = jnp.minimum(s.k + chunk, cfg.max_iters)
            s = lax.while_loop(
                lambda t: _running(cfg, t) & (t.k < k_cap), body, s)
            return refresh_products(s)

        out = lax.while_loop(partial(_running, cfg), segment, state)
    else:
        out = lax.while_loop(partial(_running, cfg), body, state)
    return out._replace(status=_finalize_status(cfg, out))


def solve_bounded(cfg: LBFGSConfig, f: ObjFn, vg: ValGradFn,
                  state: LBFGSState, dir_poly=None, fused_tail=None,
                  phi_batch=None, phi_dphi_batch=None) -> LBFGSState:
    """Cond-free fixed-budget solve: exactly ``cfg.max_iters`` lockstep
    iterations with NO per-iteration convergence condition.

    Under ``jax.vmap`` this is the fast batch formulation: a vmapped
    ``lax.while_loop`` pays a full-state select on every leaf every
    iteration to freeze finished lanes (+27% measured at B=4096 x d=1024),
    which a bounded loop skips entirely — safe because ``iterate`` is
    idempotent on terminal lanes (failed lanes re-freeze deterministically
    and every counter advance is gated on RUNNING).

    Semantics vs the while_loop solve: line-search-failed lanes produce
    IDENTICAL results; lanes that would have converged early keep
    iterating to the budget (their f only improves past tol) — use this for
    fixed-budget workloads (tol=0 benches, lockstep sweeps) or when extra
    polish is acceptable.  cfg.refresh_interval is honored via nested fori
    segments.

    NOTE resume semantics: the budget is RELATIVE to the given state — this
    runs exactly cfg.max_iters MORE iterations (fori length is static; it
    cannot subtract a traced state.k), so a state resumed at k=k0 finishes
    at k0 + max_iters and its refresh boundaries land at k0-relative
    multiples.  For checkpoint resume that must respect the global cap and
    the absolute refresh schedule, use solve_from_state.
    """
    body = lambda _, s: iterate(cfg, f, vg, s, dir_poly, fused_tail,
                                phi_batch, phi_dphi_batch)
    interval = (cfg.refresh_interval
                if (cfg.refresh_interval is not None
                    and cfg.direction == "compact_incremental") else None)
    if interval is None or interval >= cfg.max_iters:
        out = lax.fori_loop(0, cfg.max_iters, body, state)
    else:
        # Nested fori (NOT a Python chunk loop — 15000/250 would unroll 60
        # segment bodies into the program): n_full segments with a refresh
        # after each, then the remainder.
        n_full, rem = divmod(cfg.max_iters, interval)

        def segment(_, s):
            s = lax.fori_loop(0, interval, body, s)
            return refresh_products(s)

        out = lax.fori_loop(0, n_full, segment, state)
        if rem:
            out = lax.fori_loop(0, rem, body, out)
    return out._replace(status=_finalize_status(cfg, out))


def make_solve_segment(cfg: LBFGSConfig, f: ObjFn, grad=None,
                       value_and_grad=None, iters: Optional[int] = None,
                       dir_poly=None, fused_tail=None, phi_batch=None,
                       phi_dphi_batch=None, donate: bool = True):
    """Compiled ``state -> state`` running up to ``iters`` iterations (or to
    convergence), for host-driven segmented solves: periodic checkpointing
    (io.checkpoint.save_state between segments), host-side monitoring, or
    very long runs.

    The input state's buffers are DONATED (types.py design note): at giant d
    the state is multi-GB (6.7 GB at d=2^26, m=10, f32) and double-buffering
    it across segment boundaries doubles the device footprint; donation lets
    XLA alias the output into the input buffers.  The caller must not reuse
    the passed-in state afterwards (jax enforces this).

    Segments do NOT finalize status (a segment ending at its cap is still
    RUNNING); call ``finalize_result`` after the last segment.  With
    cfg.refresh_interval set (compact_incremental), the history products are
    refreshed at each segment boundary — the reference point for the
    in-segment drift bound tested in tests/test_refresh.py.
    """
    vg = make_value_and_grad(f, grad, value_and_grad)
    seg_iters = iters if iters is not None \
        else (cfg.refresh_interval if cfg.refresh_interval is not None
              else cfg.max_iters)
    body = lambda s: iterate(cfg, f, vg, s, dir_poly, fused_tail, phi_batch,
                             phi_dphi_batch)

    def segment(state: LBFGSState) -> LBFGSState:
        k_cap = jnp.minimum(state.k + seg_iters, cfg.max_iters)
        out = lax.while_loop(
            lambda t: _running(cfg, t) & (t.k < k_cap), body, state)
        if cfg.direction == "compact_incremental" \
                and cfg.refresh_interval is not None:
            out = refresh_products(out)
        return out

    return jax.jit(segment, donate_argnums=0 if donate else ())


def finalize_result(cfg: LBFGSConfig, state: LBFGSState) -> SolveResult:
    """Resolve RUNNING status to CONVERGED/MAX_ITERS and package a
    SolveResult — the closing step of a make_solve_segment driver loop."""
    return _state_to_result(
        state._replace(status=_finalize_status(cfg, state)), None)


def _solve_traced(cfg: LBFGSConfig, f: ObjFn, vg: ValGradFn,
                  state: LBFGSState, dir_poly=None,
                  fused_tail=None, phi_batch=None,
                  phi_dphi_batch=None) -> Tuple[LBFGSState, Trace]:
    """Bounded lax.scan variant that records per-iteration metrics — the
    device-side replacement for the reference's per-iteration host logging
    (lbfgs.cpp:76-78), which forces a sync every step.

    cfg.refresh_interval (compact_incremental) is honored by segmenting the
    scan: an outer scan over ceil(max_iters / interval) segments, each an
    inner scan of ``interval`` iterations, with refresh_products between —
    the same refresh points as the untraced chunked while_loop, so tracing a
    long run no longer silently disables the drift bound it is used to
    diagnose.  The refresh runs unconditionally per segment; on an
    already-finished frozen state it merely recomputes the products, which
    nothing downstream reads.
    """

    def body(s: LBFGSState, _):
        s_next = lax.cond(_running(cfg, s),
                          lambda t: iterate(cfg, f, vg, t, dir_poly,
                                            fused_tail, phi_batch,
                                            phi_dphi_batch),
                          lambda t: t, s)
        emit = (s_next.f, s_next.g_norm, s_next.alpha, s_next.n_fev,
                s_next.n_gev, s_next.guards)
        return s_next, emit

    interval = (cfg.refresh_interval
                if (cfg.refresh_interval is not None
                    and cfg.direction == "compact_incremental") else None)
    if interval is None or interval >= cfg.max_iters:
        out, emits = lax.scan(body, state, None, length=cfg.max_iters)
    else:
        n_seg = -(-cfg.max_iters // interval)

        def segment(s: LBFGSState, _):
            s2, seg_emits = lax.scan(body, s, None, length=interval)
            return refresh_products(s2), seg_emits

        out, blocks = lax.scan(segment, state, None, length=n_seg)
        # (n_seg, interval, ...) -> (n_seg * interval, ...) trimmed to the
        # trace contract's max_iters rows.  Rows past max_iters are frozen
        # copies (the guarded body never iterates past the cap), so the trim
        # drops only padding.
        emits = jax.tree.map(
            lambda a: a.reshape((n_seg * interval,) + a.shape[2:])
            [:cfg.max_iters], blocks)
    fs, gns, alphas, nfs, ngs, gds = emits
    out = out._replace(status=_finalize_status(cfg, out))
    return out, Trace(f=fs, g_norm=gns, alpha=alphas, n_fev=nfs, n_gev=ngs,
                      guards=gds)


def _state_to_result(state: LBFGSState, trace: Optional[Trace]) -> SolveResult:
    return SolveResult(
        x=state.x, f=state.f, g_norm=state.g_norm, iterations=state.k,
        status=state.status, n_fev=state.n_fev, n_gev=state.n_gev,
        trace=trace, guards=state.guards)


def make_value_and_grad(f: ObjFn, grad=None, value_and_grad=None) -> ValGradFn:
    """Resolve the objective interface: analytic gradient if provided (the
    reference ships analytic grads, functions.cpp:16-49), else jax.grad —
    which the reference cannot do at all."""
    if value_and_grad is not None:
        return value_and_grad
    if grad is not None:
        return lambda x: (f(x), grad(x))
    return jax.value_and_grad(f)


@lru_cache(maxsize=128)
def _compiled_run(cfg: LBFGSConfig, f, grad, value_and_grad, dir_poly,
                  fused_tail, phi_batch, phi_dphi_batch=None):
    """Jitted solve factory, cached on the (hashable) configuration and the
    callables' identities: repeated minimize() calls with the same setup hit
    jax's compilation cache instead of rebuilding a fresh closure (and
    therefore retracing) every call."""
    vg = make_value_and_grad(f, grad, value_and_grad)

    @jax.jit
    def run(x0):
        state = init_state(vg, x0, cfg.m, cfg.history_dtype)
        if cfg.record_trace:
            out, trace = _solve_traced(cfg, f, vg, state, dir_poly,
                                       fused_tail, phi_batch, phi_dphi_batch)
            return _state_to_result(out, trace)
        out = solve_from_state(cfg, f, vg, state, dir_poly, fused_tail,
                               phi_batch, phi_dphi_batch)
        return _state_to_result(out, None)

    return run


def minimize(f: ObjFn, x0: Array, cfg: LBFGSConfig = LBFGSConfig(),
             grad=None, value_and_grad=None, dir_poly=None,
             fused_tail=None, phi_batch=None,
             phi_dphi_batch=None) -> SolveResult:
    """Jit-compiled single-instance solve.  The public entry point matching
    the reference's ``LBFGS(f, grad, x0, line_search_method, ...)``
    (lbfgs.cpp:17-25) — but returning a structured result instead of printing.

    dir_poly: optional directional-polynomial coefficients fn for
    cfg.ls_eval="polynomial" (see problems.suite.Problem.dir_poly).
    fused_tail: optional single-stream iteration tail
    (problems.suite.fused_tail_for) — the fastest path for suite problems.

    Repeat calls with the same cfg and the same callable objects reuse the
    compiled program (pass stable function references, not fresh lambdas,
    to benefit).
    """
    run = _compiled_run(cfg, f, grad, value_and_grad, dir_poly,
                        fused_tail, phi_batch, phi_dphi_batch)
    return run(jnp.asarray(x0))
