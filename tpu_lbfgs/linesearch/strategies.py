"""The four line-search strategies as masked ``lax.while_loop``s.

Reference counterparts (all data-dependent host loops there; SURVEY.md §2
items 2, 13-17):

  backtracking             sequential-implementation/line_search.cpp:19-30,
                           parallel-implementation/line_search.cpp:25-43,
                           GPU-inlined L-BFGS-Backtracking.cu:295-341
  backtracking_wolfe       sequential line_search.cpp:33-55 (shrink 0.5 / grow 1.1)
  backtracking_wolfe_bisect parallel line_search.cpp:45-154 and
                           L-BFGS-Backtracking_Wolfe.cu:266-380 (bisection on
                           [alpha_lo, alpha_hi]; the C++ memoization cache only
                           avoids recomputation and never changes the alpha
                           sequence, so it is intentionally not replicated)
  armijo_interpolation     line_search.cpp:57-121 / parallel :156-228
  wolfe_interpolation      line_search.cpp:125-189 / parallel :298-369 and the
                           GPU-inlined zoom in L-BFGS-Wolfe.cu:260-349

Device-side restructuring: every trial evaluates f (and grad, for Wolfe
variants) *on device* inside the jitted loop — the reference round-trips
x_trial to the host for every single evaluation (L-BFGS-Backtracking.cu:322-327).
Early `continue`/`return` become carry flags; accepted lanes freeze their carry
so the same code vmaps over instance batches and shards over the d axis
unchanged.

Fidelity notes (SURVEY.md §7 fidelity traps, replicated under
``cfg.fidelity == "reference"``):
  1. The sequential backtracking Armijo test is sign-flipped vs textbook
     (line_search.cpp:24): it shrinks while ``f(x) - f(x+ad) < c1*a*g.d`` —
     since g.d < 0 this *accepts* small increases.  ``fidelity="fixed"`` uses
     the textbook rule ``f_new <= f_x + c1*a*g.d``.
  2. ``armijo_interpolation`` sets ``alpha_prev = alpha`` *after* alpha was
     already replaced by the interpolated value (line_search.cpp:116), so from
     the second failed trial on, ``delta_alpha == 0`` and the search degrades
     to plain halving.  Replicated under "reference"; "fixed" keeps the
     previous trial point.
  3. The parallel backtracking/interp searches rescue underflowed steps with
     ``return 0.5`` (parallel line_search.cpp:38-41,223-227) — enabled via
     ``cfg.alpha_rescue_floor``.
  4. ``cubicInterpolate`` (line_search.cpp:8-12) anchors the Nocedal-Wright
     minimizer formula at alpha0 without flipping d2's sign, selecting the
     cubic's MAXIMIZER root (on phi(a)=a^3/3-a through (0, 3) it returns
     -1, the maximizer; the minimizer is +1) — the safeguard bands then
     degrade the search toward halving/bisection.  "fixed" uses the
     textbook eq. 3.59 (interpolate.cubic_interpolate_fixed).
  5. ``quadraticInterpolate`` is called with phi0 at the TRIAL point but
     dphi0 at 0 (line_search.cpp:110), returning a step LARGER than the
     failed trial (1.5x on phi(a)=a^2-a) that the band rejects to plain
     halving.  "fixed" uses the one-point textbook minimizer
     (interpolate.quadratic_interpolate_fixed).
"""
from __future__ import annotations

from typing import Callable, Tuple

import jax
import jax.numpy as jnp
from jax import Array, lax

from ..config import LBFGSConfig
from ..types import LineSearchResult
from .interpolate import (
    cubic_interpolate,
    cubic_interpolate_fixed,
    quadratic_interpolate,
    quadratic_interpolate_fixed,
    safe_cubic_interpolate,
)

# The searches are purely one-dimensional: they see the objective only
# through phi(alpha) = f(x + alpha*d) and phi_dphi(alpha) = (phi, phi'),
# where phi'(alpha) = grad f(x + alpha*d) . d.  The solver provides either
# direct evaluations (exact reference semantics, cfg.ls_eval = "direct") or
# closed-form directional-polynomial coefficients computed in one fused pass
# over (x, d) (cfg.ls_eval = "polynomial"; problems.suite dir_poly) — then
# every trial is O(1) scalar work and the Wolfe searches need no gradient
# evaluations at all, something the reference's host-round-trip design could
# never do (L-BFGS-Backtracking.cu:322-327).
PhiFn = Callable[[Array], Array]
PhiDphiFn = Callable[[Array], Tuple[Array, Array]]


def _i32(v) -> Array:
    return jnp.asarray(v, jnp.int32)


def _apply_rescue(cfg: LBFGSConfig, alpha: Array) -> Tuple[Array, Array]:
    """Parallel-fidelity floor rescue: alpha < floor -> rescue value.
    Returns (alpha, fired) so the solver can count Guard.LS_RESCUE — the
    reference's equivalent of this branch silently changes the trajectory
    (parallel line_search.cpp:38-41)."""
    if cfg.alpha_rescue_floor is None:
        return alpha, _i32(0)
    hit = alpha < cfg.alpha_rescue_floor
    return jnp.where(hit, jnp.asarray(cfg.alpha_rescue_value, alpha.dtype),
                     alpha), hit.astype(jnp.int32)


def _armijo_accept(cfg: LBFGSConfig, f_x, f_new, alpha, g_dot_d) -> Array:
    if cfg.fidelity == "reference":
        # Reference rule (line_search.cpp:24): shrink while
        # f_x - f_new < c1*alpha*g.d  =>  accept when f_x - f_new >= c1*alpha*g.d.
        return (f_x - f_new) >= cfg.c1 * alpha * g_dot_d
    # Textbook sufficient decrease.
    return f_new <= f_x + cfg.c1 * alpha * g_dot_d


# -----------------------------------------------------------------------------
# 1. Armijo backtracking
# -----------------------------------------------------------------------------

def backtracking(cfg: LBFGSConfig, phi: PhiFn, phi_dphi: PhiDphiFn,
                 f_x: Array, g_dot_d: Array) -> LineSearchResult:
    """C++ control flow: test alpha; accept -> exit; else alpha *= shrink and
    exit untested once alpha underflows backtracking_tol."""
    del phi_dphi
    dtype = f_x.dtype
    alpha0 = jnp.asarray(cfg.initial_step, dtype)

    def cond(carry):
        _, accepted, broke, _ = carry
        return ~(accepted | broke)

    def body(carry):
        alpha, _, _, n_fev = carry
        f_new = phi(alpha)
        accept = _armijo_accept(cfg, f_x, f_new, alpha, g_dot_d)
        alpha_next = jnp.where(accept, alpha, alpha * cfg.shrink)
        broke = ~accept & (alpha_next < cfg.backtracking_tol)
        return alpha_next, accept, broke, n_fev + 1

    alpha, _, broke, n_fev = lax.while_loop(
        cond, body, (alpha0, jnp.bool_(False), jnp.bool_(False), _i32(0)))
    if cfg.fidelity == "fixed" and cfg.alpha_rescue_floor is None:
        # Textbook semantics: a search that never satisfied Armijo FAILS
        # (alpha=0 -> solver bails) instead of stepping on the untested
        # underflowed alpha the reference returns (line_search.cpp:29) —
        # which, on a degenerate direction (e.g. a near-zero-curvature pair
        # making rho explode), applies a garbage step and diverges.
        alpha = jnp.where(broke, jnp.zeros_like(alpha), alpha)
    alpha, rescued = _apply_rescue(cfg, alpha)
    return LineSearchResult(alpha, n_fev, _i32(0), rescued)


# -----------------------------------------------------------------------------
# 1b. Speculative (batched-candidate) Armijo backtracking
# -----------------------------------------------------------------------------

def backtracking_speculative(cfg: LBFGSConfig, phi: PhiFn,
                             phi_dphi: PhiDphiFn, f_x: Array,
                             g_dot_d: Array) -> LineSearchResult:
    """Armijo backtracking with the candidate ladder evaluated in parallel.

    The reference's paper proposes evaluating "multiple step sizes in
    parallel" but every shipped loop is serial over alpha
    (L-BFGS-Backtracking.cu:314-341).  Here each round evaluates the whole
    ladder alpha_base * shrink^[0..K) with ONE vector phi call — under
    ls_eval="polynomial" that is K Horner evaluations; under "direct" it is
    one batched (vmapped) objective evaluation over (x, d).

    The returned alpha is exactly sequential backtracking's: the first
    ladder index that passes Armijo wins; the sequential loop's underflow
    exit (shrunken alpha dips below backtracking_tol after a failed trial)
    is reproduced per-candidate.  n_fev counts phi evaluations actually
    performed (K per round), not the sequential-equivalent trial count.

    Requires a vector-capable phi (solver.make_phi provides one in both
    eval modes).
    """
    del phi_dphi
    K = cfg.spec_width
    dtype = f_x.dtype
    alpha0 = jnp.asarray(cfg.initial_step, dtype)
    shrink = jnp.asarray(cfg.shrink, dtype)

    def _ladder(base):
        # Iterated multiply (the sequential loop's exact rounding chain):
        # base, base*s, (base*s)*s, ...  A pow-based base * s**k ladder
        # rounds differently for non-power-of-two shrink factors and can
        # flip a knife-edge Armijo acceptance.
        def mul(c, _):
            return c * shrink, c

        _, alphas = lax.scan(mul, base, None, length=K)
        return alphas

    def cond(carry):
        _, done, _, _, _ = carry
        return ~done

    def body(carry):
        base, _, _, _, n_fev = carry
        alphas = _ladder(base)                       # (K,)
        fs = phi(alphas)                             # one batched pass
        accepts = _armijo_accept(cfg, f_x, fs, alphas, g_dot_d)
        nexts = alphas * cfg.shrink
        breaks = ~accepts & (nexts < cfg.backtracking_tol)
        stop = accepts | breaks
        any_stop = jnp.any(stop)
        idx = jnp.argmax(stop)                       # first stop index
        res = jnp.where(accepts[idx], alphas[idx], nexts[idx])
        return (nexts[K - 1], any_stop, res, ~accepts[idx], n_fev + K)

    _, _, alpha, broke, n_fev = lax.while_loop(
        cond, body,
        (alpha0, jnp.bool_(False), alpha0, jnp.bool_(False), _i32(0)))
    if cfg.fidelity == "fixed" and cfg.alpha_rescue_floor is None:
        # Same textbook break-means-fail semantics as `backtracking`.
        alpha = jnp.where(broke, jnp.zeros_like(alpha), alpha)
    alpha, rescued = _apply_rescue(cfg, alpha)
    return LineSearchResult(alpha, n_fev, _i32(0), rescued)


# -----------------------------------------------------------------------------
# 2. Backtracking-Wolfe (multiplicative shrink/grow)
# -----------------------------------------------------------------------------

def backtracking_wolfe(cfg: LBFGSConfig, phi: PhiFn, phi_dphi: PhiDphiFn,
                       f_x: Array, g_dot_d: Array) -> LineSearchResult:
    """Armijo fail -> alpha *= shrink; curvature fail -> alpha *= grow; the
    reference loop has no iteration cap (line_search.cpp:39-52), so a safety
    cap (cfg.ls_safety_cap) bounds the jitted loop."""
    del phi
    dtype = f_x.dtype
    alpha0 = jnp.asarray(cfg.initial_step, dtype)

    def cond(carry):
        _, done, it, _, _ = carry
        return ~done & (it < cfg.ls_safety_cap)

    def body(carry):
        alpha, _, it, n_fev, n_gev = carry
        f_new, dphi_new = phi_dphi(alpha)
        armijo_fail = f_new > f_x + cfg.c1 * alpha * g_dot_d
        curv_fail = dphi_new < cfg.c2 * g_dot_d
        alpha_next = jnp.where(
            armijo_fail, alpha * cfg.shrink,
            jnp.where(curv_fail, alpha * cfg.grow, alpha))
        accepted = ~armijo_fail & ~curv_fail
        done = accepted | (alpha_next < cfg.backtracking_tol)
        return alpha_next, done, it + 1, n_fev + 1, n_gev + 1

    alpha, _, _, n_fev, n_gev = lax.while_loop(
        cond, body, (alpha0, jnp.bool_(False), _i32(0), _i32(0), _i32(0)))
    return LineSearchResult(alpha, n_fev, n_gev)


# -----------------------------------------------------------------------------
# 3. Backtracking-Wolfe via bisection (the parallel implementation's variant)
# -----------------------------------------------------------------------------

def backtracking_wolfe_bisect(cfg: LBFGSConfig, phi: PhiFn,
                              phi_dphi: PhiDphiFn, f_x: Array,
                              g_dot_d: Array) -> LineSearchResult:
    """Bisection on [alpha_lo, alpha_hi]; doubles while no upper bound exists.

    NOTE: the reference function locally hardcodes C2 = 0.9 even though
    constants.h sets 0.7 (parallel line_search.cpp:54 — SURVEY.md fidelity
    trap 3); pass cfg.c2 = 0.9 for exact parity with that code path.
    """
    del phi
    dtype = f_x.dtype
    big = jnp.asarray(jnp.finfo(dtype).max, dtype)

    def cond(carry):
        _, _, _, done, it, _, _ = carry
        return ~done & (it < cfg.ls_max_iters)

    def body(carry):
        alpha, lo, hi, _, it, n_fev, n_gev = carry
        f_new, gnd = phi_dphi(alpha)
        armijo_ok = f_new <= f_x + cfg.c1 * alpha * g_dot_d
        curv_ok = gnd >= cfg.c2 * g_dot_d
        accepted = armijo_ok & curv_ok
        lo = jnp.where(armijo_ok & ~curv_ok, alpha, lo)
        hi = jnp.where(~armijo_ok, alpha, hi)
        alpha_next = jnp.where(hi < big, (lo + hi) * 0.5, 2.0 * lo)
        alpha_next = jnp.where(accepted, alpha, alpha_next)
        done = accepted | (alpha_next < cfg.bisect_tol)
        # The reference evaluates grad only when Armijo passes
        # (line_search.cpp:116-118); count faithfully.
        return (alpha_next, lo, hi, done, it + 1,
                n_fev + 1, n_gev + armijo_ok.astype(jnp.int32))

    alpha, *_rest = lax.while_loop(
        cond, body,
        (jnp.asarray(cfg.initial_step, dtype), jnp.asarray(0.0, dtype), big,
         jnp.bool_(False), _i32(0), _i32(0), _i32(0)))
    _, _, _, _, n_fev, n_gev = _rest
    return LineSearchResult(alpha, n_fev, n_gev)


# -----------------------------------------------------------------------------
# 4. Armijo with quadratic-then-cubic interpolation
# -----------------------------------------------------------------------------

def armijo_interpolation(cfg: LBFGSConfig, phi: PhiFn, phi_dphi: PhiDphiFn,
                         f_x: Array, g_dot_d: Array) -> LineSearchResult:
    del phi_dphi
    dtype = f_x.dtype
    alpha0 = jnp.asarray(cfg.initial_step, dtype)

    def cond(carry):
        _, _, _, done, _, it, _ = carry
        return ~done & (it < cfg.ls_max_iters)

    def body(carry):
        alpha, alpha_prev, f_prev, _, result, it, n_fev = carry
        f_new = phi(alpha)
        accept = f_new <= f_x + cfg.c1 * alpha * g_dot_d
        floor_hit = ~accept & (alpha < cfg.interp_min)

        # --- cubic branch (have a previous trial) ---
        delta = alpha - alpha_prev
        degenerate = jnp.abs(delta) < 1e-10
        grad_alpha = (f_new - f_x - g_dot_d * alpha) / (alpha * alpha)
        # Traps #4/#5: the reference's cubic returns the maximizer root and
        # its quadratic a larger-than-alpha step; "fixed" uses the textbook
        # minimizers (same safeguard bands either way).
        if cfg.fidelity == "fixed":
            a_cubic = cubic_interpolate_fixed(alpha_prev, alpha, f_prev,
                                              g_dot_d, f_new, grad_alpha)
        else:
            a_cubic = cubic_interpolate(alpha_prev, alpha, f_prev, g_dot_d,
                                        f_new, grad_alpha)
        # Safeguard band is relative to alpha_prev (line_search.cpp:103);
        # NaN comparisons are False in C++ and JAX alike, so NaN survives.
        out_of_band = (a_cubic < 0.1 * alpha_prev) | (a_cubic > 0.9 * alpha_prev)
        a_cubic = jnp.where(out_of_band, alpha_prev * 0.5, a_cubic)
        a_from_cubic = jnp.where(degenerate, alpha * 0.5, a_cubic)

        # --- quadratic branch (first failed trial) ---
        if cfg.fidelity == "fixed":
            a_quad = quadratic_interpolate_fixed(alpha, f_x, g_dot_d, f_new)
        else:
            a_quad = quadratic_interpolate(alpha, jnp.asarray(0.0, dtype),
                                           f_new, g_dot_d, f_x)
        out_q = (a_quad < 0.1 * cfg.initial_step) | (a_quad > 0.9 * cfg.initial_step)
        a_quad = jnp.where(out_q, cfg.initial_step * 0.5, a_quad)

        alpha_next = jnp.where(alpha_prev > 0, a_from_cubic, a_quad)

        if cfg.fidelity == "reference":
            # Quirk (line_search.cpp:116): alpha_prev tracks the NEW alpha, so
            # delta collapses to 0 next round -> pure halving thereafter.
            alpha_prev_next = alpha_next
        else:
            alpha_prev_next = alpha

        done = accept | floor_hit
        result = jnp.where(
            accept, alpha,
            jnp.where(floor_hit, jnp.asarray(cfg.interp_min, dtype), alpha_next))
        return (alpha_next, alpha_prev_next, f_new, done, result, it + 1,
                n_fev + 1)

    carry = (alpha0, jnp.asarray(0.0, dtype), f_x, jnp.bool_(False), alpha0,
             _i32(0), _i32(0))
    alpha, _, _, done, result, _, n_fev = lax.while_loop(cond, body, carry)
    # On cap exhaustion the reference returns the current alpha
    # (line_search.cpp:120); only that path goes through the parallel
    # implementation's floor rescue (parallel line_search.cpp:223-227) —
    # in-loop accepts return alpha directly.
    rescued_alpha, hit = _apply_rescue(cfg, alpha)
    alpha_out = jnp.where(done, result, rescued_alpha)
    return LineSearchResult(alpha_out, n_fev, _i32(0),
                            jnp.where(done, _i32(0), hit))


# -----------------------------------------------------------------------------
# 5. Strong-Wolfe with cubic interpolation (zoom)
# -----------------------------------------------------------------------------

def _wolfe_interp_fn(cfg: LBFGSConfig):
    if cfg.safe_cubic:
        _fixed = cfg.fidelity == "fixed"
        return lambda *a: safe_cubic_interpolate(*a, fixed=_fixed)
    if cfg.fidelity == "fixed":
        return cubic_interpolate_fixed         # trap #4: minimizer root
    return cubic_interpolate


def _make_wolfe_zoom(cfg: LBFGSConfig, phi_dphi: PhiDphiFn, f_x: Array,
                     g_dot_d: Array, interp):
    """(cond, body) of the strong-Wolfe zoom while_loop — the SINGLE source
    of the sequential branch rules, shared by ``wolfe_interpolation`` and
    the speculative variant's Phase B (their parity contract would otherwise
    live in two copies that could drift)."""
    dtype = f_x.dtype

    def cond(carry):
        return ~carry[5] & (carry[7] < cfg.ls_max_iters)

    def body(carry):
        (alpha, lo, hi, f_lo, dphi_lo, _, result, it, n_fev, n_gev) = carry
        f_new, dphi_new = phi_dphi(alpha)
        # Branch 1: Armijo violated, or not an improvement over the lo point.
        branch1 = (f_new > f_x + cfg.c1 * alpha * g_dot_d) | \
                  ((f_new >= f_lo) & (it > 0))
        grad_alpha = (f_new - f_x - g_dot_d * alpha) / (alpha * alpha)
        a_b1 = interp(lo, alpha, f_lo, dphi_lo, f_new, grad_alpha)
        accepted = ~branch1 & (jnp.abs(dphi_new) <= -cfg.c2 * g_dot_d)

        # Branch 2: curvature sign flipped -> alpha becomes the new hi.
        branch2 = ~branch1 & ~accepted & (dphi_new >= 0)
        a_b2 = interp(lo, alpha, f_lo, dphi_lo, f_new, dphi_new)

        # Branch 3: still descending -> alpha becomes the new lo; double when
        # unbounded above, else interpolate against hi.  Matches the reference
        # exactly: the interpolation uses the *updated* lo/f_lo/dphi_lo
        # (line_search.cpp:171-180).
        branch3 = ~branch1 & ~accepted & ~branch2
        a_b3 = jnp.where(jnp.isinf(hi), alpha * 2.0,
                         interp(alpha, hi, f_new, dphi_new, f_new, dphi_new))

        hi_next = jnp.where(branch1 | branch2, alpha, hi)
        lo_next = jnp.where(branch3, alpha, lo)
        f_lo_next = jnp.where(branch3, f_new, f_lo)
        dphi_lo_next = jnp.where(branch3, dphi_new, dphi_lo)

        alpha_next = jnp.where(branch1, a_b1,
                               jnp.where(branch2, a_b2,
                                         jnp.where(branch3, a_b3, alpha)))
        # interp_min floor check is skipped on branch 1 (the `continue` at
        # line_search.cpp:156 bypasses it).
        floor_hit = ~branch1 & ~accepted & (alpha_next < cfg.interp_min)

        done = accepted | floor_hit
        result = jnp.where(
            accepted, alpha,
            jnp.where(floor_hit, jnp.asarray(cfg.interp_min, dtype), result))
        # Reference evaluates grad only when branch 1 is not taken.
        return (alpha_next, lo_next, hi_next, f_lo_next, dphi_lo_next, done,
                result, it + 1, n_fev + 1, n_gev + (~branch1).astype(jnp.int32))

    return cond, body


def wolfe_interpolation(cfg: LBFGSConfig, phi: PhiFn, phi_dphi: PhiDphiFn,
                        f_x: Array, g_dot_d: Array) -> LineSearchResult:
    dtype = f_x.dtype
    interp = _wolfe_interp_fn(cfg)
    cond, body = _make_wolfe_zoom(cfg, phi_dphi, f_x, g_dot_d, interp)
    carry = (jnp.asarray(cfg.initial_step, dtype), jnp.asarray(0.0, dtype),
             jnp.asarray(jnp.inf, dtype), f_x, g_dot_d, jnp.bool_(False),
             jnp.asarray(cfg.initial_step, dtype), _i32(0), _i32(0), _i32(0))
    alpha, _, _, _, _, done, result, _, n_fev, n_gev = lax.while_loop(
        cond, body, carry)
    return LineSearchResult(jnp.where(done, result, alpha), n_fev, n_gev)


# -----------------------------------------------------------------------------
# 5b. Speculative strong-Wolfe: K-wide bracketing ladder + sequential zoom
# -----------------------------------------------------------------------------

def wolfe_interpolation_speculative(cfg: LBFGSConfig, phi: PhiFn,
                                    phi_dphi: PhiDphiFn, f_x: Array,
                                    g_dot_d: Array) -> LineSearchResult:
    """Strong-Wolfe with the BRACKETING phase speculated K trials at a time.

    The sequential search's bracketing phase is a pure-doubling walk (branch
    3 with hi = inf doubles alpha, line_search.cpp:171-180 /
    strategies.wolfe_interpolation branch 3) — a fixed ladder alpha0 *
    2^[0..K) whose (phi, phi') values batch into ONE fused pass
    (kernels.make_multi_phi_dphi; the solver's phi_dphi is vector-capable).
    The ladder is resolved on scalars with the exact sequential branch
    rules, so the produced bracket, zoom entry state, and final alpha are
    IDENTICAL to ``wolfe_interpolation``'s; the data-dependent zoom then
    proceeds one (also exact) trial at a time.  This completes the paper's
    "multiple step sizes in parallel" idea (cuda_lbfgs.pdf §II) for the
    Wolfe search it motivated — the reference's own Wolfe loop evaluates
    one host-round-trip trial per step (L-BFGS-Wolfe.cu:276-349).

    n_fev/n_gev count evaluations PERFORMED (K per bracketing pass), not the
    sequential-equivalent trial count — same accounting as
    ``backtracking_speculative``.
    """
    dtype = f_x.dtype
    K = cfg.spec_width
    cap = cfg.ls_max_iters
    interp = _wolfe_interp_fn(cfg)
    inf = jnp.asarray(jnp.inf, dtype)
    alpha0 = jnp.asarray(cfg.initial_step, dtype)

    def _ladder(base):
        # Iterated doubling (exact in fp: *2 scales the exponent), matching
        # the sequential walk's values bit-for-bit.
        def mul(c, _):
            return c * 2.0, c

        _, als = lax.scan(mul, base, None, length=K)
        return als

    # --- Phase A: speculative bracketing -------------------------------------
    # carry: (base, bracketing, done, result, alpha_z, lo, hi, f_lo, dphi_lo,
    #         it, n_fev, n_gev)
    def condA(c):
        base, bracketing, done = c[0], c[1], c[2]
        it = c[9]
        return bracketing & ~done & (it < cap)

    def bodyA(c):
        (base, bracketing, done, result, alpha_z, lo, hi, f_lo, dphi_lo,
         it, n_fev, n_gev) = c
        alphas = _ladder(base)                    # (K,)
        fs, dphis = phi_dphi(alphas)              # ONE fused K-trial pass
        t_idx = jnp.arange(K, dtype=it.dtype)
        it_t = it + t_idx
        # Previous-node state per ladder position (node t-1's values; node 0
        # sees the entering lo state).
        f_prev = jnp.concatenate([f_lo[None], fs[:-1]])
        dphi_prev = jnp.concatenate([dphi_lo[None], dphis[:-1]])
        lo_prev = jnp.concatenate([lo[None], alphas[:-1]])

        branch1 = (fs > f_x + cfg.c1 * alphas * g_dot_d) | \
                  ((fs >= f_prev) & (it_t > 0))
        accepted = ~branch1 & (jnp.abs(dphis) <= -cfg.c2 * g_dot_d)
        branch2 = ~branch1 & ~accepted & (dphis >= 0)
        # Branch-3 floor: the sequential loop checks alpha_next (= 2*alpha in
        # the doubling phase) against interp_min on EVERY non-branch-1 step;
        # with a sub-floor initial_step the doubling itself can floor out, so
        # those nodes must stop the ladder too (missing this returned a
        # wildly different alpha for initial_step < interp_min).
        b3_floor = (~branch1 & ~accepted & ~branch2
                    & (alphas * 2.0 < cfg.interp_min))
        cap_hit = it_t >= cap                     # sequential loop would have
        #                                           exited before this trial
        stop = branch1 | accepted | branch2 | b3_floor | cap_hit
        any_stop = jnp.any(stop)
        t = jnp.argmax(stop)                      # first stop index

        a_t, f_t, dphi_t = alphas[t], fs[t], dphis[t]
        lo_t, f_lo_t, dphi_lo_t = lo_prev[t], f_prev[t], dphi_prev[t]

        # Outcomes at the stop node (cap_hit first: those trials never ran).
        capped = cap_hit[t]
        acc = ~capped & accepted[t]
        b1 = ~capped & branch1[t]
        b2 = ~capped & branch2[t]
        b3f = ~capped & b3_floor[t]

        grad_alpha = (f_t - f_x - g_dot_d * a_t) / (a_t * a_t)
        a_b1 = interp(lo_t, a_t, f_lo_t, dphi_lo_t, f_t, grad_alpha)
        a_b2 = interp(lo_t, a_t, f_lo_t, dphi_lo_t, f_t, dphi_t)
        alpha_next = jnp.where(b1, a_b1, jnp.where(b2, a_b2, a_t))
        # Floor check skipped on branch 1 (the reference's `continue`).
        floor_hit = (b2 & (alpha_next < cfg.interp_min)) | b3f

        done_now = any_stop & (acc | floor_hit | capped)
        result_now = jnp.where(
            acc, a_t,
            jnp.where(floor_hit, jnp.asarray(cfg.interp_min, dtype),
                      jnp.where(capped, a_t, result)))
        enter_zoom = any_stop & (b1 | b2) & ~floor_hit

        # No stop: the whole ladder was branch 3 — advance the walk by K.
        tail_a, tail_f, tail_d = alphas[K - 1], fs[K - 1], dphis[K - 1]
        base_next = jnp.where(any_stop, base, tail_a * 2.0)
        lo_next = jnp.where(any_stop, jnp.where(enter_zoom, lo_t, lo), tail_a)
        f_lo_next = jnp.where(any_stop,
                              jnp.where(enter_zoom, f_lo_t, f_lo), tail_f)
        dphi_lo_next = jnp.where(any_stop,
                                 jnp.where(enter_zoom, dphi_lo_t, dphi_lo),
                                 tail_d)
        hi_next = jnp.where(enter_zoom, a_t, hi)
        it_next = jnp.where(any_stop, jnp.minimum(it_t[t] + 1, cap), it + K)
        it_next = jnp.where(capped, cap, it_next)
        return (base_next, bracketing & ~any_stop, done_now, result_now,
                jnp.where(enter_zoom, alpha_next, base_next), lo_next,
                hi_next, f_lo_next, dphi_lo_next,
                it_next.astype(it.dtype), n_fev + K, n_gev + K)

    cA = (alpha0, jnp.bool_(True), jnp.bool_(False), alpha0, alpha0,
          jnp.asarray(0.0, dtype), inf, f_x, g_dot_d, _i32(0), _i32(0),
          _i32(0))
    (base, bracketing, done, result, alpha_z, lo, hi, f_lo, dphi_lo, it,
     n_fev, n_gev) = lax.while_loop(condA, bodyA, cA)

    # --- Phase B: the exact sequential zoom from the speculated bracket ------
    # Same (cond, body) as wolfe_interpolation — one source of the branch
    # rules, entered from the Phase-A carry instead of the fresh one.
    condB, bodyB = _make_wolfe_zoom(cfg, phi_dphi, f_x, g_dot_d, interp)
    cB = (alpha_z, lo, hi, f_lo, dphi_lo, done, result, it, n_fev, n_gev)
    alpha, _, _, _, _, done, result, _, n_fev, n_gev = lax.while_loop(
        condB, bodyB, cB)
    return LineSearchResult(jnp.where(done, result, alpha), n_fev, n_gev)


# -----------------------------------------------------------------------------
# 2b. Speculative backtracking-Wolfe: shrink/grow walk speculated as a tree
# -----------------------------------------------------------------------------

def backtracking_wolfe_speculative(cfg: LBFGSConfig, phi: PhiFn,
                                   phi_dphi: PhiDphiFn, f_x: Array,
                                   g_dot_d: Array) -> LineSearchResult:
    """``backtracking_wolfe`` with its multiplicative walk speculated.

    The sequential walk moves alpha -> alpha*shrink (Armijo fail) or
    alpha*grow (curvature fail) or accepts: after R steps the reachable
    states are exactly base * shrink^i * grow^j with i + j <= R — a
    triangular tree of (R+1)(R+2)/2 nodes whose (phi, phi') values batch
    into ONE fused pass.  The walk is then resolved on scalars with the
    sequential rules, advancing up to R real steps per pass with exact
    alpha parity (fp too: multiplying by a power-of-two shrink is exact, so
    the product's rounding sequence is interleaving-independent).

    The fp-parity argument REQUIRES a power-of-two ``cfg.shrink`` (the
    default 0.5): for any other shrink, different shrink/grow interleavings
    to the same (i, j) node round differently, so the tree cannot represent
    the walk's values exactly — this function then delegates to the
    sequential ``backtracking_wolfe`` rather than silently breaking the
    parity contract.

    R = cfg.spec_width - 1 kept small (default 8 -> 36 trials; pass
    spec_width=4 for 10 trials if VPU-bound at small d).
    """
    import math

    if math.frexp(cfg.shrink)[0] != 0.5:       # not a power of two
        return backtracking_wolfe(cfg, phi, phi_dphi, f_x, g_dot_d)
    dtype = f_x.dtype
    R = max(1, cfg.spec_width - 1)
    cap = cfg.ls_safety_cap
    # Triangular node table in walk order; flat index of (i shrinks, j grows).
    pairs = [(i, j) for i in range(R + 1) for j in range(R + 1 - i)]
    flat = {p: t for t, p in enumerate(pairs)}
    K = len(pairs)
    idx_shrink = jnp.asarray([flat.get((i + 1, j), 0) for i, j in pairs],
                             jnp.int32)
    idx_grow = jnp.asarray([flat.get((i, j + 1), 0) for i, j in pairs],
                           jnp.int32)
    can_shrink = jnp.asarray([(i + 1, j) in flat for i, j in pairs])
    can_grow = jnp.asarray([(i, j + 1) in flat for i, j in pairs])

    def _tree(base):
        # alphas[flat(i, j)] = base * shrink^i * grow^j with the sequential
        # walk's exact rounding chain.  The grow chain MUST be a lax.scan:
        # an unrolled (base*1.1)*1.1 chain gets constant-folded by XLA into
        # base*(1.1*1.1) — a 1-ulp difference that breaks bit parity with
        # the sequential loop (measured; same reason _ladder above scans).
        # The shrink halvings are exact (*0.5 scales the exponent) and
        # interleave-invariant, so applying them after the grows reproduces
        # any shrink/grow path's value bit-for-bit.
        def mul(c, _):
            return c * cfg.grow, c

        _, grows = lax.scan(mul, base, None, length=R + 1)
        vals = []
        for i, j in pairs:
            v = grows[j]
            for _ in range(i):
                v = v * cfg.shrink
            vals.append(v)
        return jnp.stack(vals)

    def cond(c):
        done, it = c[1], c[2]
        return ~done & (it < cap)

    def body(c):
        base, _, it, alpha_cur, n_fev, n_gev = c
        alphas = _tree(base)                       # (K,)
        fs, dphis = phi_dphi(alphas)               # ONE fused K-trial pass
        armijo_fail = fs > f_x + cfg.c1 * alphas * g_dot_d
        curv_fail = dphis < cfg.c2 * g_dot_d

        # Resolve the walk on scalars: each live step replays one sequential
        # iteration exactly; `repass` marks a move whose child lies outside
        # the evaluated tree (resume from its value next pass).
        def step(s, _):
            t, done, it_s, alpha_s, repass, base_n = s
            live = ~done & ~repass & (it_s < cap)
            af, cf = armijo_fail[t], curv_fail[t]
            acc = ~af & ~cf
            a_here = alphas[t]
            move_shrink = af
            move_grow = ~af & cf
            a_next = jnp.where(
                move_shrink, a_here * cfg.shrink,
                jnp.where(move_grow, a_here * cfg.grow, a_here))
            underflow = ~acc & (a_next < cfg.backtracking_tol)
            new_done = acc | underflow
            child_in = jnp.where(move_shrink, can_shrink[t],
                                 jnp.where(move_grow, can_grow[t],
                                           jnp.bool_(False)))
            t_next = jnp.where(move_shrink, idx_shrink[t],
                               jnp.where(move_grow, idx_grow[t], t))
            return (jnp.where(live & ~new_done & child_in,
                              t_next, t).astype(jnp.int32),
                    jnp.where(live, new_done, done),
                    it_s + live.astype(it_s.dtype),
                    jnp.where(live, a_next, alpha_s),
                    repass | (live & ~new_done & ~child_in),
                    jnp.where(live & ~new_done, a_next, base_n)), None

        init = (_i32(0), jnp.bool_(False), it, alpha_cur, jnp.bool_(False),
                base)
        (t_end, done_w, it_end, alpha_end, repass, base_next), _ = lax.scan(
            step, init, None, length=R + 1)
        return (base_next, done_w, it_end, alpha_end, n_fev + K, n_gev + K)

    alpha0 = jnp.asarray(cfg.initial_step, dtype)
    base, done, it, alpha, n_fev, n_gev = lax.while_loop(
        cond, body, (alpha0, jnp.bool_(False), _i32(0), alpha0, _i32(0),
                     _i32(0)))
    return LineSearchResult(alpha, n_fev, n_gev)


_STRATEGIES = {
    "backtracking": backtracking,
    "backtracking_speculative": backtracking_speculative,
    "backtracking_wolfe": backtracking_wolfe,
    "backtracking_wolfe_speculative": backtracking_wolfe_speculative,
    "backtracking_wolfe_bisect": backtracking_wolfe_bisect,
    "armijo_interpolation": armijo_interpolation,
    "wolfe_interpolation": wolfe_interpolation,
    "wolfe_interpolation_speculative": wolfe_interpolation_speculative,
}


def get_line_search(name: str):
    return _STRATEGIES[name]


# --- measured speculative-selection rule (round-4/5) ----------------------------
# The speculative Wolfe twins win only when the search performs many trials
# per iteration (the whole candidate ladder then shares one fused (x, d)
# stream); in well-scaled regimes (~1-2 trials/iter) the sequential search
# wins because the ladder evaluates candidates the sequential search never
# visits.  Measured boundary (bench_results.json speculative_wolfe_cells:
# sequential wins at ~1.1-2 trials/iter; speculative +6.9% at the ~12
# trials/iter hard-scaling cell):
SPECULATIVE_TRIALS_THRESHOLD = 8.0
SPECULATIVE_TWINS = {
    "wolfe_interpolation": "wolfe_interpolation_speculative",
    "backtracking_wolfe": "backtracking_wolfe_speculative",
}


def resolve_speculative_auto(cfg, probe_result):
    """Make the measured speculative-Wolfe guidance EXECUTABLE: given a
    completed probe solve (a short run with the sequential search — e.g.
    ``cfg.replace(max_iters=50)``), return ``cfg`` with the line search
    switched to its speculative twin exactly when the probe's observed
    line-search trials/iteration crosses SPECULATIVE_TRIALS_THRESHOLD
    (same pattern as history_dtype="auto": a static pre-compile decision
    keyed on a measured quantity, since the program cannot switch strategy
    mid-jit).

    The trials/iteration estimate is ``n_fev / iterations - 1`` (iterate
    charges one post-search evaluation per iteration on top of the
    search's own trials).  Only the Wolfe searches have a regime where the
    twin loses; cfgs with other strategies are returned unchanged.
    """
    twin = SPECULATIVE_TWINS.get(cfg.line_search)
    if twin is None:
        return cfg
    iters = max(int(probe_result.iterations), 1)
    trials_per_iter = int(probe_result.n_fev) / iters - 1.0
    if trials_per_iter >= SPECULATIVE_TRIALS_THRESHOLD:
        return cfg.replace(line_search=twin)
    return cfg
