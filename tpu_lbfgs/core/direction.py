"""Search-direction computation: d = -H_k g via the limited-memory history.

Two interchangeable formulations (algebraically identical for the same
history; verified against each other in tests/test_direction.py):

``two_loop``
    The classic two-loop recursion as a ``lax.scan`` over the (m, d) ring
    buffer, mirroring the reference's semantics: CPU loop
    (sequential-implementation/lbfgs.cpp:94-143) and the GPU ring-indexed
    cuBLAS version (parallel-implementation/L-BFGS.cu:216-276).  Guards are
    reproduced branchlessly: non-finite rho or non-positive/non-finite gamma
    fall back to steepest descent (lbfgs.cpp:103-107,117-124); per-pair
    sy <= threshold skip replicates the GPU path (L-BFGS.cu:222-223) when
    ``cfg.pair_skip_threshold`` is set.

``compact``
    The Byrd–Nocedal–Schnabel compact representation (Byrd, Nocedal, Schnabel,
    "Representations of quasi-Newton matrices...", Math. Prog. 63, 1994,
    Eq. 7.24 in Nocedal & Wright):

        H g = gamma*g + [S, gamma*Y] * W * [S'g; gamma*Y'g]
        W   = [[R^{-T} (D + gamma*Y'Y) R^{-1},  -R^{-T}],
               [-R^{-1},                         0      ]]

    which collapses the 2m *sequential* dot+axpy passes of the two-loop into
    TWO large contraction passes over the history plus O(m^2) work on tiny
    matrices: the (2m, d) contraction is one streaming pass, and under
    d-axis sharding the whole direction costs ONE psum of a (2m, m+1) block
    instead of the 2m+3 sequential scalar reductions per iteration the
    two-loop needs (SURVEY.md §7 "sharded two-loop" hard part).

Ring-buffer bookkeeping: pair p lives in slot p % m; logical order is
reconstructed by permuting the small (m,) / (m, m) quantities only — the big
(m, d) history arrays are never gathered or rolled.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax import Array, lax

from ..config import LBFGSConfig
from ..types import LBFGSState

import os
# Measurement-only A/B switch: TPU_LBFGS_PERM=gather restores the index-
# gather small-matrix reordering (ROADMAP S6 queues the A/B on the GPU).
_ONEHOT = os.environ.get("TPU_LBFGS_PERM", "onehot") == "onehot"

HIGHEST = lax.Precision.HIGHEST


def _ring_logical_slots(n_pairs: Array, m: int) -> Tuple[Array, Array]:
    """Physical slot of each logical index j (0 = oldest), and validity mask."""
    hist_len = jnp.minimum(n_pairs, m)
    j = jnp.arange(m, dtype=n_pairs.dtype)
    slots = (n_pairs - hist_len + j) % m
    valid = j < hist_len
    return slots, valid


def _perm_onehot(slots: Array, m: int, dtype) -> Array:
    """One-hot permutation matrix P with P[l, p] = 1 iff slots[l] == p, so
    P @ v_phys gathers into logical order and P.T @ v_log scatters back.

    The small-matrix reorderings run as these (m, m) products rather than
    ``A[slots][:, slots]`` index gathers, which under ``vmap`` lower to
    per-lane XLA gather ops.  The products are exact reorderings only at
    full precision, so every product with P states HIGHEST."""
    return (slots[..., :, None]
            == jnp.arange(m, dtype=slots.dtype)).astype(dtype)


def _newest_scalars(state: LBFGSState, m: int) -> Tuple[Array, Array]:
    """(s.y, y.y) of the newest pair via a one-hot select-and-sum (a
    batched 1-element gather is still a gather op)."""
    newest = (state.n_pairs - 1) % m
    oh = (jnp.arange(m, dtype=newest.dtype) == newest)
    dt = state.sy_hist.dtype
    return (jnp.sum(state.sy_hist * oh.astype(dt)),
            jnp.sum(state.yy_hist * oh.astype(dt)))


def _gamma(state: LBFGSState, m: int) -> Array:
    """Initial Hessian scaling gamma = s'y / y'y of the newest pair
    (lbfgs.cpp:117-118), from the precomputed per-slot scalars."""
    if _ONEHOT:
        sy_n, yy_n = _newest_scalars(state, m)
        return sy_n / yy_n
    newest = (state.n_pairs - 1) % m
    return state.sy_hist[newest] / state.yy_hist[newest]




def two_loop_direction(cfg: LBFGSConfig, state: LBFGSState) -> Array:
    """d = -H g via lax.scan two-loop over the ring buffer."""
    return _two_loop_core(cfg, state)[0]


def combine_direction(g: Array, s_hist: Array, y_hist: Array, v: Array,
                      u: Array, gamma: Array) -> Array:
    """r = gamma*g + v@S - gamma*(u@Y): the compact representation's second
    pass over the (m, R, L) history, as one fused contraction.  The
    coefficient vectors are cast to the history dtype so the operands match
    (bf16 x bf16 -> f32 accumulate; identical to the f32 path when the
    history is f32)."""
    hdtype = s_hist.dtype
    dn = (((0,), (0,)), ((), ()))           # (m,) x (m, R, L) -> (R, L)
    dot = partial(lax.dot_general, precision=HIGHEST,
                  preferred_element_type=g.dtype)
    vs = dot(v.astype(hdtype), s_hist, dn)
    uy = dot(u.astype(hdtype), y_hist, dn)
    r3 = gamma * g.reshape(s_hist.shape[1:]) + vs - gamma * uy
    return r3.reshape(g.shape)


def _two_loop_core(cfg: LBFGSConfig, state: LBFGSState):
    """(direction, fallback_fired): the bool records the steepest-descent
    fallback for the Guard.DIR_FALLBACK counter (the reference warns at
    lbfgs.cpp:105,121)."""
    m = state.s_hist.shape[0]
    g = state.g
    slots, valid = _ring_logical_slots(state.n_pairs, m)
    sy = state.sy_hist[slots]                      # logical order
    rho = 1.0 / sy

    if cfg.pair_skip_threshold is not None:
        # GPU semantics: individually skip low-curvature pairs
        # (L-BFGS.cu:222-223), never global-fallback on rho.
        use = valid & (sy > cfg.pair_skip_threshold)
        bad_rho = jnp.bool_(False)
    else:
        # CPU semantics: any non-finite rho among stored pairs aborts to
        # steepest descent (lbfgs.cpp:102-107).
        use = valid
        bad_rho = jnp.any(valid & ~jnp.isfinite(rho))

    blk = state.s_hist.shape[1:]                   # history rows are (R, L)

    # First loop: newest -> oldest.
    def first(q, idx):
        slot, r, u = idx
        s_i = state.s_hist[slot]
        y_i = state.y_hist[slot]
        a = jnp.where(u, r * jnp.vdot(s_i, q), 0.0)
        return q - a * y_i, a

    rev = (slots[::-1], rho[::-1], use[::-1])
    q, alphas_rev = lax.scan(first, g.reshape(blk), rev)
    alphas = alphas_rev[::-1]

    gamma = _gamma(state, m)
    bad_gamma = (gamma <= 0) | ~jnp.isfinite(gamma)
    r_vec = gamma * q

    # Second loop: oldest -> newest.
    def second(r_acc, idx):
        slot, r, u, a = idx
        s_i = state.s_hist[slot]
        y_i = state.y_hist[slot]
        b = jnp.where(u, r * jnp.vdot(y_i, r_acc), 0.0)
        coeff = jnp.where(u, a - b, 0.0)
        return r_acc + coeff * s_i, None

    r_vec, _ = lax.scan(second, r_vec, (slots, rho, use, alphas))
    r_flat = r_vec.reshape(g.shape)

    fallback = bad_rho | bad_gamma | (state.hist_len == 0)
    return jnp.where(fallback, -g, -r_flat), fallback


def compact_direction(cfg: LBFGSConfig, state: LBFGSState) -> Array:
    """d = -H g via the compact representation (module docstring)."""
    return compact_direction_with_aux(cfg, state)[0]


class DirAux(NamedTuple):
    """Coefficients with d = -(gamma*g + v@S - gamma*(u@Y)).

    On any fallback (empty history, bad rho/gamma, non-finite result) the
    triple is (1, 0, 0) — i.e. d = -g — so downstream small-matrix identities
    (e.g. Y @ d for the incremental updates) remain valid.

    g_dot_d is the directional derivative phi'(0) = g.d computed from the
    SAME coefficients by the O(m) identity
        g.d = -(gamma*||g||^2 + v.(S g) - gamma * u.(Y g))
    so the solver never spends a (2d)-element HBM pass on jnp.vdot(g, d);
    the reference instead re-reduces the full vectors every iteration
    (lbfgs.cpp:147, L-BFGS-Backtracking.cu:295-306)."""
    gamma: Array
    v_phys: Array
    u_phys: Array
    g_dot_d: Array


def _compact_core(cfg: LBFGSConfig, state: LBFGSState, SY_p: Array,
                  YY_p: Array, Sg_p: Array, Yg_p: Array):
    """Shared small-matrix algebra: physical-order products -> (d, DirAux).

    The whole small-matrix head (logical-order reorder, masked R build,
    the two triangular solves, scatter-back, gamma, phi'(0)) lives in
    kernels.chain: unbatched calls trace the plain jnp formulation
    documented there, and under ``vmap`` the custom_vmap rule runs the
    chain as ONE Triton kernel over lane blocks on the GPU.
    """
    from ..kernels.chain import make_compact_chain

    m = state.s_hist.shape[0]
    g = state.g
    dtype = g.dtype

    chain = make_compact_chain(m, cfg.pair_skip_threshold)
    v_phys, u_phys, gamma, g_dot_d, fb_pre = chain(
        SY_p, YY_p, Sg_p, Yg_p, state.sy_hist, state.yy_hist,
        state.n_pairs, state.g_norm)

    # --- second pass over the history: r = gamma*g + S'v - gamma * Y'u -------
    r_vec = combine_direction(g, state.s_hist, state.y_hist, v_phys, u_phys,
                              gamma)

    fallback = fb_pre | ~jnp.all(jnp.isfinite(r_vec))

    # phi'(0) from the small quantities only (see DirAux docstring); the
    # fallback coefficients (1, 0, 0) make the same formula yield -||g||^2.
    gg = state.g_norm * state.g_norm
    one = jnp.asarray(1.0, dtype)
    zero_m = jnp.zeros((m,), dtype)
    aux = DirAux(jnp.where(fallback, one, gamma),
                 jnp.where(fallback, zero_m, v_phys),
                 jnp.where(fallback, zero_m, u_phys),
                 jnp.where(fallback, -gg, g_dot_d))
    return jnp.where(fallback, -g, -r_vec), aux, fallback


def history_products(state: LBFGSState):
    """The four history contractions (SY, YY, Sg, Yg) from the (m, R, L)
    buffers and the current gradient — shared by the ``compact`` direction
    and solver.refresh_products (which is specified to reproduce exactly
    these contractions as the incremental path's drift reference).

    Expressed as d-axis contractions directly on the (m, R, L) buffers — no
    concatenated copy and no materialized transpose; XLA shares the S/Y
    streams across the four contractions.  Under d-axis sharding this whole
    group is ONE fused all-reduce of ~(2m+2)m scalars.
    """
    dtype = state.g.dtype
    dn_mm = (((1, 2), (1, 2)), ((), ()))   # (m,R,L) x (m,R,L) -> (m,m)
    dn_mv = (((1, 2), (0, 1)), ((), ()))   # (m,R,L) x (R,L)   -> (m,)
    g3 = state.g.reshape(state.s_hist.shape[1:])
    dot = partial(lax.dot_general, precision=HIGHEST,
                  preferred_element_type=dtype)
    SY = dot(state.s_hist, state.y_hist, dn_mm)
    YY = dot(state.y_hist, state.y_hist, dn_mm)
    Sg = dot(state.s_hist, g3, dn_mv)
    Yg = dot(state.y_hist, g3, dn_mv)
    return SY, YY, Sg, Yg


def compact_direction_with_aux(cfg: LBFGSConfig, state: LBFGSState):
    """Products recomputed from the (m, R, L) history every iteration."""
    return _compact_core(cfg, state, *history_products(state))


def compact_incremental_direction_with_aux(cfg: LBFGSConfig,
                                           state: LBFGSState):
    """Products read from the incrementally-maintained state (solver.iterate
    keeps state.SY/YY/Sg/Yg current — see _update_products): the direction's
    only large-array work is the 2m-pass combine, roughly halving history
    traffic vs recomputation.  fp caveat: the SY/YY entries built from
    gradient differences accumulate rounding over iterations; the
    curvature-critical diagonals (sy, yy) are always the directly-computed
    tail reductions."""
    return _compact_core(cfg, state, state.SY, state.YY, state.Sg, state.Yg)


def compute_direction_with_aux(cfg: LBFGSConfig, state: LBFGSState):
    """(direction, DirAux-or-None, fallback_fired)."""
    if cfg.direction == "compact":
        return compact_direction_with_aux(cfg, state)
    if cfg.direction == "compact_incremental":
        return compact_incremental_direction_with_aux(cfg, state)
    d, fallback = _two_loop_core(cfg, state)
    return d, None, fallback


def compute_direction(cfg: LBFGSConfig, state: LBFGSState) -> Array:
    return compute_direction_with_aux(cfg, state)[0]
