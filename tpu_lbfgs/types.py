"""Core state / result containers.

The reference keeps solver state in loose locals plus two ``std::deque``s of
vectors (lbfgs.cpp:32) on CPU, or ``m`` separately-allocated device buffers
indexed ``k % m`` on GPU (L-BFGS.cu:160-172,216-235).  This design uses one
fixed-shape pytree: the history is a dense ``(m, d)`` ring buffer so
every iteration is a statically-shaped XLA program (no dynamic shapes, no
reallocation), sharding annotations apply uniformly, and the whole state can be
donated between iterations.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax.numpy as jnp
from jax import Array

#: Minor dimension of the history ring's (R, LANES) per-pair rows.
LANES = 128


def hist_block(d: int) -> Tuple[int, int]:
    """(R, L) with R*L = d: the per-pair storage shape of the history ring.

    The ring is an (m, R, 128) array: each pair's row is one contiguous
    block of d elements, so a row write and every per-row contraction
    stream contiguous memory, and d-axis sharding splits R.  The layout is
    a leftover of the design's first target, whose memory tiling padded an
    (m, d) matrix; on the GPU it is contiguous either way and costs
    nothing (ROADMAP S5 queues the question of keeping it).  Falls back to
    (1, d) when d is not a multiple of 128.
    """
    if d % LANES == 0 and d >= LANES:
        return d // LANES, LANES
    return 1, d


class Status:
    """Solver status codes (carried on-device as int32)."""

    RUNNING = 0
    CONVERGED = 1        # ||g|| < tol                       (lbfgs.cpp:80-84)
    LINE_SEARCH_FAILED = 2  # alpha < step_fail_tol          (lbfgs.cpp:164-168)
    MAX_ITERS = 3        # iteration cap                     (lbfgs.cpp:201)

    NAMES = {0: "running", 1: "converged", 2: "line_search_failed", 3: "max_iters"}


class Guard:
    """Indices into the ``guards`` counter vector: how often each algorithmic
    safeguard fired during the solve.

    The reference WARNS at every activation (lbfgs.cpp:105,121 invalid
    rho/gamma, :150 non-descent direction, :194 curvature skip; the parallel
    alpha-floor rescue at parallel-implementation/line_search.cpp:38-41) —
    host printing the branchless device loop cannot do.  These int32
    counters, carried in the state and surfaced in SolveResult/Trace and the
    CLI verbose replay, restore that diagnostic parity without any device
    sync."""

    DIR_FALLBACK = 0   # invalid rho/gamma/non-finite -> d = -g (lbfgs.cpp:103-124)
    NOT_DESCENT = 1    # g.d >= 0 safeguard -> d = -g          (lbfgs.cpp:147-153)
    PAIR_REJECT = 2    # curvature pair rejected, ring frozen   (lbfgs.cpp:192-195)
    LS_RESCUE = 3      # alpha floor rescue fired   (parallel line_search.cpp:38-41)
    LANE_FREEZE = 4    # non-finite/underflow step froze the lane (solver.iterate)
    DAMPED = 5         # Powell damping blended a low-curvature pair
    #                    (cfg.damping — an extension; the reference can only
    #                    skip such pairs)
    N = 6

    NAMES = ("dir_fallback", "not_descent", "pair_reject", "ls_rescue",
             "lane_freeze", "damped")


class LBFGSState(NamedTuple):
    """Full solver state; a pytree, so it vmaps/shards/checkpoints directly.

    Ring-buffer semantics: pair number ``p`` (0-based, over *accepted* pairs)
    lives in physical slot ``p % m``.  ``n_pairs`` counts accepted pairs ever;
    ``hist_len = min(n_pairs, m)``.  Logical (chronological) index
    ``j in [0, hist_len)`` with 0 = oldest maps to physical slot
    ``(n_pairs - hist_len + j) % m``.
    """

    x: Array          # (d,)   current iterate
    f: Array          # ()     f(x)
    g: Array          # (d,)   grad f(x)
    g_norm: Array     # ()     ||g||_2, computed fused with the gradient update
                      #        so the loop condition never re-reads g
    s_hist: Array     # (m, R, L) s_p = x_{p+1} - x_p, ring-indexed; (R, L) =
                      #          hist_block(d) — lane-tiled row storage
    y_hist: Array     # (m, R, L) y_p = g_{p+1} - g_p, ring-indexed
    sy_hist: Array    # (m,)   s_p . y_p (rho denominators, precomputed on store)
    yy_hist: Array    # (m,)   y_p . y_p (gamma denominators, precomputed on store)
    # Incrementally-maintained history products (direction="compact_incremental"):
    # all in physical slot order; zeros when unused by the active direction.
    SY: Array         # (m, m) s_i . y_j
    YY: Array         # (m, m) y_i . y_j
    Sg: Array         # (m,)   s_i . g   (g = the CURRENT gradient)
    Yg: Array         # (m,)   y_i . g
    n_pairs: Array    # ()     int32, accepted pairs ever stored
    k: Array          # ()     int32, iteration counter
    status: Array     # ()     int32, Status code
    alpha: Array      # ()     last accepted step size
    n_fev: Array      # ()     int32, objective evaluations
    n_gev: Array      # ()     int32, gradient evaluations
    # (Guard.N,) int32 safeguard-activation counters (class Guard).  Default
    # None only for hand-built partial states in direction-level tests; every
    # solver-constructed state carries real zeros.
    guards: Array = None

    @property
    def hist_len(self) -> Array:
        return jnp.minimum(self.n_pairs, self.s_hist.shape[0])


class LineSearchResult(NamedTuple):
    alpha: Array      # ()     accepted (or last) step size
    n_fev: Array      # ()     int32, objective evals performed by the search
    n_gev: Array      # ()     int32, gradient evals performed by the search
    # () int32 1 when the parallel-fidelity alpha-floor rescue replaced an
    # underflowed step (parallel line_search.cpp:38-41); feeds
    # Guard.LS_RESCUE.
    rescued: Array = 0


class Trace(NamedTuple):
    """Per-iteration metrics recorded by the bounded solver.

    Replaces the reference's per-iteration host ``cout`` logging
    (lbfgs.cpp:76-78, L-BFGS.cu:307,350-351) — which forces a device sync every
    iteration — with arrays carried in the scan and read out once at the end.
    Entries at indices >= the final ``k`` are frozen copies of the last state.
    """

    f: Array          # (max_iters,)
    g_norm: Array     # (max_iters,)
    alpha: Array      # (max_iters,)
    n_fev: Array      # (max_iters,) cumulative
    n_gev: Array      # (max_iters,) cumulative
    guards: Array = None  # (max_iters, Guard.N) cumulative safeguard counters


class SolveResult(NamedTuple):
    x: Array
    f: Array
    g_norm: Array
    iterations: Array   # ()   int32
    status: Array       # ()   int32 (Status)
    n_fev: Array
    n_gev: Array
    trace: Optional[Trace] = None
    guards: Array = None  # (Guard.N,) int32 final safeguard counters (Guard)
