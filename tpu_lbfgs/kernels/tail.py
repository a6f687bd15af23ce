"""The fused post-line-search iteration tail, as one Triton kernel.

One pass over x, d, g (and optionally the (m, d) history ring) emits
everything the solver needs after the line search: the trial point
x_new = x + alpha*d, f and the analytic gradient at x_new, the (s, y) ring
rows already in history dtype, the seven pair/convergence scalars
(f, s.y, y.y, g_new.g_new, d.g_new, g.g_new, y.g_new) and, with
``with_matvec``, the history matvecs S@y_new and Y@y_new.

Reference counterpart: updateSolution + host f/grad evaluation +
updateVectors + three cuBLAS Ddots + two more for the products, each a
separate kernel launch with host syncs (L-BFGS.cu:309-348).

Kernel design (Pallas through Triton): each program owns one contiguous
1-D block of ``block`` elements and runs independently of every other
block, so there is no carry between programs.  The chain objectives'
neighbours x_new[i-1] and x_new[i+1] are rebuilt from masked loads of
x[i+-1] and d[i+-1] (they hit the cache lines the block already reads).
Each program writes its seven scalar partials (and its m matvec partials)
to a per-block row of a small output; one XLA reduction over the blocks
finishes them.  No atomics, so every sum is deterministic.

``fused_tail_jnp`` is the plain-XLA twin with identical semantics; tests
and chip_smoke.py compare the two.
"""
from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax import Array, lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..types import hist_block

HIGHEST = lax.Precision.HIGHEST

# Elements per program and warps per program, without and with the history
# matvecs (whose (m, block) tiles need smaller blocks).  Chosen on the card
# (PERF.md, "Kernels on the H100"); any power of two is legal.
BLOCK = 1024
NUM_WARPS = 4
BLOCK_MATVEC = 512
NUM_WARPS_MATVEC = 8

# Width of the per-block scalar-partials row: 7 scalars, padded to a power
# of two as Triton blocks must be.
_NSCAL = 8


# --- per-problem value+gradient bodies -------------------------------------
# Signature: (xv, xp, xf, gidx, n) -> (f_blk, g_blk) where xp/xf are the
# chain neighbours xv[i-1]/xv[i+1] (ignored by separable problems), gidx the
# global element index and n the global unpadded length; terms and gradient
# entries outside [0, n) are masked to zero.  Shared by the Triton kernel
# and usable from plain jnp.

def _body_quadratic(xv, xp, xf, gidx, n):
    valid = gidx < n
    r = jnp.where(valid, xv - 1.0, 0.0)
    return r * r, 2.0 * r


def _body_rosenbrock(xv, xp, xf, gidx, n):
    is_term = gidx < (n - 1)            # owns forward term i
    is_valid = gidx < n
    t = jnp.where(is_term, xf - xv * xv, 0.0)
    e = jnp.where(is_term, 1.0 - xv, 0.0)
    f_blk = 100.0 * t * t + e * e
    # Inbound contribution from term i-1: 200*(x[i] - x[i-1]^2), 1 <= i <= n-1.
    t_prev = jnp.where((gidx >= 1) & is_valid, xv - xp * xp, 0.0)
    g_blk = jnp.where(is_term, 2.0 * (xv - 1.0) - 400.0 * xv * t, 0.0) \
        + 200.0 * t_prev
    return f_blk, g_blk


def _body_coupled(xv, xp, xf, gidx, n):
    coeff = 1000.0
    is_term = gidx < (n - 1)
    is_valid = gidx < n
    xval = jnp.where(is_valid, xv, 0.0)
    cross = jnp.where(is_term, xv * xf, 0.0)
    f_blk = coeff * xval * xval + (coeff / 10.0) * cross
    g_blk = 2.0 * coeff * xval \
        + jnp.where(is_term, (coeff / 10.0) * xf, 0.0) \
        + jnp.where((gidx >= 1) & is_valid, (coeff / 10.0) * xp, 0.0)
    return f_blk, g_blk


# (body, needs_halo): halo-free bodies never read xp/xf.
TAIL_BODIES = {
    "quadratic": (_body_quadratic, False),
    "rosenbrock": (_body_rosenbrock, True),
    "coupled_quadratic": (_body_coupled, True),
}


def _hist3(s_hist: Array) -> Array:
    """Normalize a history buffer to (m, R, L) (2-D (m, d) inputs accepted;
    the solver stores 3-D natively — see types.hist_block)."""
    if s_hist.ndim == 2:
        m, d = s_hist.shape
        return s_hist.reshape(m, *hist_block(d))
    return s_hist


def pair_scalars(s, d, g, g_new, accurate: bool = False):
    """(y, s.y, y.y, g_new.g_new, d.g_new, g.g_new, y.g_new) with
    y = g_new - g, as plain ops XLA fuses into one multi-output reduction;
    ``accurate`` uses Neumaier-compensated reductions."""
    if accurate:
        from ..utils.accurate import compensated_dot as dot
    else:
        dot = functools.partial(jnp.vdot, precision=HIGHEST)
    y = g_new - g
    return (y, dot(s, y), dot(y, y), dot(g_new, g_new), dot(d, g_new),
            dot(g, g_new), dot(y, g_new))


def history_matvecs(s_hist, y_hist, v, dtype=None):
    """(S@v, Y@v) over the (m, R, L) ring rows, at full f32 precision,
    accumulated in ``dtype`` (default v's)."""
    s3, y3 = _hist3(s_hist), _hist3(y_hist)
    v3 = v.reshape(s3.shape[1:])
    dot = functools.partial(lax.dot_general,
                            dimension_numbers=(((1, 2), (0, 1)), ((), ())),
                            precision=HIGHEST,
                            preferred_element_type=dtype or v.dtype)
    return dot(s3, v3), dot(y3, v3)


def fused_tail_jnp(vg_fn, x, d, alpha, g, s_hist, y_hist,
                   with_matvec: bool, accurate: bool = False):
    """The tail as plain ops, which XLA fuses.  ``accurate`` uses Neumaier-
    compensated reductions for the seven scalars."""
    hdtype = s_hist.dtype
    s = alpha * d
    x_new = x + s
    f_new, g_new = vg_fn(x_new)
    y, *scal = pair_scalars(s, d, g, g_new, accurate)
    t1, t2 = (history_matvecs(s_hist, y_hist, y) if with_matvec
              else (None, None))
    return (x_new, f_new, g_new, s.astype(hdtype), y.astype(hdtype),
            *scal, t1, t2)


# --- the Triton kernel ------------------------------------------------------

def _tail_kernel(ns_ref, sc_ref, x_ref, d_ref, g_ref, *refs, body,
                 needs_halo: bool, with_matvec: bool, m: int, mp: int,
                 block: int):
    if with_matvec:
        sh_ref, yh_ref = refs[:2]
        refs = refs[2:]
    xnew_ref, gnew_ref, srow_ref, yrow_ref, part_ref = refs[:5]
    if with_matvec:
        t1_ref, t2_ref = refs[5:7]

    f32 = jnp.float32
    pid = pl.program_id(0)
    n_local = x_ref.shape[0]
    idx = pid * block + jnp.arange(block, dtype=jnp.int32)
    inb = idx < n_local
    n = ns_ref[0]                       # global unpadded length
    start = ns_ref[1]                   # this shard's global offset
    alpha = sc_ref[0]

    def ld(ref, i, mask):
        return plgpu.load(ref.at[i], mask=mask, other=0.0)

    x = ld(x_ref, idx, inb)
    dv = ld(d_ref, idx, inb)
    g = ld(g_ref, idx, inb)
    s = alpha * dv
    xn = x + s
    if needs_halo:
        # Trial-point neighbours from masked neighbour loads; past the
        # local ends, the neighbouring shards' boundary elements
        # sc = [alpha, prev_x, prev_d, next_x, next_d] (zeros unsharded,
        # where the bodies' global-index masks discard them).
        has_next = idx + 1 < n_local
        xf = ld(x_ref, idx + 1, has_next) + alpha * ld(d_ref, idx + 1,
                                                       has_next)
        xf = jnp.where(has_next, xf, sc_ref[3] + alpha * sc_ref[4])
        has_prev = idx >= 1
        xp = ld(x_ref, idx - 1, has_prev) + alpha * ld(d_ref, idx - 1,
                                                       has_prev)
        xp = jnp.where(has_prev, xp, sc_ref[1] + alpha * sc_ref[2])
    else:
        xf = xp = xn
    f_blk, g_new = body(xn, xp, xf, start + idx, n)
    # Lanes past the local end may still be below the global n on a shard
    # that is not the last: mask them out explicitly.
    f_blk = jnp.where(inb, f_blk, 0.0)
    g_new = jnp.where(inb, g_new, 0.0)
    y = g_new - g

    plgpu.store(xnew_ref.at[idx], xn, mask=inb)
    plgpu.store(gnew_ref.at[idx], g_new, mask=inb)
    plgpu.store(srow_ref.at[idx], s.astype(srow_ref.dtype), mask=inb)
    plgpu.store(yrow_ref.at[idx], y.astype(yrow_ref.dtype), mask=inb)

    lane = jnp.arange(_NSCAL, dtype=jnp.int32)
    part = jnp.zeros((_NSCAL,), f32)
    for i, v in enumerate((f_blk, s * y, y * y, g_new * g_new, dv * g_new,
                           g * g_new, y * g_new)):
        part = jnp.where(lane == i, jnp.sum(v), part)
    plgpu.store(part_ref.at[pid * _NSCAL + lane], part)

    if with_matvec:
        # Contract against the NEW pair's y (no-cancellation incremental
        # updates; see the solver): one (mp, block) tile of each history
        # ring, rows flat at i * n_local, reduced along the block at once.
        rows = jnp.arange(mp, dtype=jnp.int32)[:, None]
        off = rows * n_local + idx[None, :]
        tmask = (rows < m) & inb[None, :]
        sh = ld(sh_ref, off, tmask).astype(f32)
        yh = ld(yh_ref, off, tmask).astype(f32)
        lm = jnp.arange(mp, dtype=jnp.int32)
        plgpu.store(t1_ref.at[pid * mp + lm], jnp.sum(sh * y[None, :], axis=1))
        plgpu.store(t2_ref.at[pid * mp + lm], jnp.sum(yh * y[None, :], axis=1))


def _finish(parts: Array, accurate: bool) -> Array:
    """Sum per-block partial rows (n_blocks, k) over the blocks."""
    if accurate:
        from ..utils.accurate import compensated_sum
        return compensated_sum(parts)
    return jnp.sum(parts, axis=0)


def fused_tail_triton(problem: str, x, d, alpha, g, s_hist, y_hist,
                      with_matvec: bool, n: Optional[int] = None, start=0,
                      edges: Optional[Array] = None, accurate: bool = False,
                      block: Optional[int] = None,
                      num_warps: Optional[int] = None,
                      interpret: bool = False):
    """The fused tail over (a shard of) x/d/g/history.

    ``n`` is the GLOBAL unpadded length (default len(x)), ``start`` this
    shard's global offset (may be traced: axis_index * d_local), ``edges``
    the neighbouring shards' boundary elements [prev_x, prev_d, next_x,
    next_d] (zeros unsharded).  Any d works: lanes past the end are masked,
    nothing is padded.  ``interpret`` runs the kernel in the Pallas
    interpreter (tests only); otherwise it compiles for the GPU.
    """
    body, needs_halo = TAIL_BODIES[problem]
    s_hist, y_hist = _hist3(s_hist), _hist3(y_hist)
    if block is None:
        block = BLOCK_MATVEC if with_matvec else BLOCK
    if num_warps is None:
        num_warps = NUM_WARPS_MATVEC if with_matvec else NUM_WARPS
    f32 = jnp.float32
    dd = x.shape[0]
    n = dd if n is None else n
    m = s_hist.shape[0]
    if not _offsets_fit(m, dd):
        raise ValueError(f"a ring of m={m} x d={dd} needs offsets past "
                         f"int32; use the XLA tail (fused_tail_jnp)")
    mp = pl.next_power_of_2(m)
    hdtype = s_hist.dtype
    nb = pl.cdiv(dd, block)
    if edges is None:
        edges = jnp.zeros((4,), f32)
    ns = jnp.stack([jnp.asarray(n, jnp.int32), jnp.asarray(start, jnp.int32)])
    sc = jnp.concatenate([jnp.reshape(alpha.astype(f32), (1,)),
                          edges.astype(f32)])

    args = [ns, sc, x, d, g]
    if with_matvec:
        args += [s_hist.reshape(-1), y_hist.reshape(-1)]
    out_shape = [jax.ShapeDtypeStruct((dd,), f32),
                 jax.ShapeDtypeStruct((dd,), f32),
                 jax.ShapeDtypeStruct((dd,), hdtype),
                 jax.ShapeDtypeStruct((dd,), hdtype),
                 jax.ShapeDtypeStruct((nb * _NSCAL,), f32)]
    if with_matvec:
        out_shape += [jax.ShapeDtypeStruct((nb * mp,), f32)] * 2

    outs = pl.pallas_call(
        functools.partial(_tail_kernel, body=body, needs_halo=needs_halo,
                          with_matvec=with_matvec, m=m, mp=mp, block=block),
        out_shape=tuple(out_shape),
        grid=(nb,),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=interpret,
        name=f"fused_tail_{problem}",
    )(*args)

    xnew, gnew, srow, yrow = outs[:4]
    scal = _finish(outs[4].reshape(nb, _NSCAL), accurate)
    f_new, sy, yy, gg, dgn, ggn, ygn = (scal[i] for i in range(7))
    if with_matvec:
        t1 = jnp.sum(outs[5].reshape(nb, mp), axis=0)[:m]
        t2 = jnp.sum(outs[6].reshape(nb, mp), axis=0)[:m]
    else:
        t1 = t2 = None
    return xnew, f_new, gnew, srow, yrow, sy, yy, gg, dgn, ggn, ygn, t1, t2


def _offsets_fit(m: int, d: int) -> bool:
    """The kernel addresses the flat (m, d) ring with int32 offsets."""
    return pl.next_power_of_2(m) * d < 2 ** 31


def tail_kernel_ok(problem: str, x: Array, s_hist: Array) -> bool:
    """Static eligibility of the Triton tail: a suite body, f32 vectors,
    an f32 or bf16 history ring, and a ring small enough for int32
    offsets."""
    return (problem in TAIL_BODIES and x.dtype == jnp.float32
            and s_hist.dtype in (jnp.float32, jnp.bfloat16)
            and _offsets_fit(s_hist.shape[0], x.shape[-1]))


def make_fused_tail(problem: str, vg_fallback, with_matvec: bool = True,
                    accurate_dots: bool = False, interpret: bool = False):
    """Build the fused post-line-search tail for a suite problem.

    Returns ``tail(x, d, alpha, g, s_hist, y_hist) -> (x_new, f_new, g_new,
    s_row, y_row, sy, yy, gg, dgn, ggn, ygn, t1, t2)`` with s_row/y_row
    already in history dtype and t1/t2 = S@y_new, Y@y_new over the
    *pre-update* history (the slot entries are patched from exact scalars by
    the solver).

    The Triton kernel runs where the program is compiled for CUDA; on any
    other platform the same call lowers to ``fused_tail_jnp`` (chosen at
    lowering by ``lax.platform_dependent``, not by the default backend).
    ``interpret=True`` runs the kernel in the Pallas interpreter instead —
    the tests' way to execute it on the CPU.

    accurate_dots: Neumaier-compensate the scalar reductions — pass True
    when cfg.accurate_dots is set; the solver checks the returned callable's
    ``accurate_dots`` attribute to reject a mismatched pairing.
    """
    def jnp_tail(x, d, alpha, g, s_hist, y_hist):
        return fused_tail_jnp(vg_fallback, x, d, alpha, g, s_hist, y_hist,
                              with_matvec, accurate=accurate_dots)

    def kernel_tail(x, d, alpha, g, s_hist, y_hist):
        return fused_tail_triton(problem, x, d, alpha, g, s_hist, y_hist,
                                 with_matvec, accurate=accurate_dots,
                                 interpret=interpret)

    def tail(x, d, alpha, g, s_hist, y_hist):
        if not tail_kernel_ok(problem, x, s_hist):
            return jnp_tail(x, d, alpha, g, s_hist, y_hist)
        if interpret:
            return kernel_tail(x, d, alpha, g, s_hist, y_hist)
        return lax.platform_dependent(x, d, alpha, g, s_hist, y_hist,
                                      cuda=kernel_tail, default=jnp_tail)

    tail.accurate_dots = accurate_dots
    return tail

