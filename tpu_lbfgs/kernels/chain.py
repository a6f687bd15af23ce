"""The compact direction's batched small-matrix chain.

The compact representation's per-iteration small-matrix work — reorder the
physical-slot products into logical order, build the masked triangular R,
two triangular solves, scatter the coefficients back — is arithmetically
trivial (~m^3 flops per instance on kilobytes of operands).  Vmapped, XLA
turns it into batched 10x10 products, batched triangular solves and many
small fusions: one kernel launch each, inside the solver's while loop.
This module runs the WHOLE chain as one Triton kernel over blocks of lanes,
wired in through ``jax.custom_batching.custom_vmap``: the unbatched call
(single-instance solves, the sharded single-instance path) traces the
plain jnp formulation, and under ``vmap`` the batched rule runs the kernel
across all lanes at once in programs compiled for CUDA (the vmapped jnp
formulation everywhere else).

Reference counterpart: none — the reference's two-loop has no small-matrix
phase; this is the price of the compact formulation (direction.py module
docstring), paid once per iteration at one kernel launch.
"""
from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
from jax import Array, lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

HIGHEST = lax.Precision.HIGHEST

# Instances per program and warps per program.  Chosen on the card
# (PERF.md, "Kernels on the H100"); any power of two is legal.
LANES_PER_PROGRAM = 32
NUM_WARPS = 1


# --- unbatched jnp implementation (the former _compact_core head) ----------------

def chain_jnp(SY_p: Array, YY_p: Array, Sg_p: Array, Yg_p: Array,
              sy_hist: Array, yy_hist: Array, n_pairs: Array, g_norm: Array,
              m: int, skip_thr):
    """(v_phys, u_phys, gamma, g_dot_d, fallback_pre) for ONE instance —
    exactly the small-matrix head of direction._compact_core (which now
    calls this through the custom_vmap wrapper); see that module's
    docstring for the algebra and provenance."""
    from ..core.direction import (
        _ONEHOT,
        _perm_onehot,
        _ring_logical_slots,
    )

    dtype = SY_p.dtype
    slots, valid = _ring_logical_slots(n_pairs, m)
    if _ONEHOT:
        P = _perm_onehot(slots, m, dtype)
        # One-hot products are exact reorderings only at full f32
        # precision (TF32 would round the entries).
        mat = partial(jnp.matmul, precision=HIGHEST)
        SY = mat(mat(P, SY_p), P.T)
        YY = mat(mat(P, YY_p), P.T)
    else:
        SY = SY_p[slots][:, slots]
        YY = YY_p[slots][:, slots]
    if skip_thr is not None:
        valid = valid & (jnp.diagonal(SY) > skip_thr)
    if _ONEHOT:
        p1 = jnp.where(valid, mat(P, Sg_p), 0.0)
        p2 = jnp.where(valid, mat(P, Yg_p), 0.0)
    else:
        p1 = jnp.where(valid, Sg_p[slots], 0.0)
        p2 = jnp.where(valid, Yg_p[slots], 0.0)

    vmask2 = valid[:, None] & valid[None, :]
    d_diag = jnp.where(valid, jnp.diagonal(SY), 1.0)
    eye = jnp.eye(m, dtype=dtype)
    R = jnp.where(vmask2, jnp.triu(SY), 0.0) \
        + jnp.where(valid, 0.0, 1.0) * eye
    YYm = jnp.where(vmask2, YY, 0.0)

    newest = (n_pairs - 1) % m
    oh = (jnp.arange(m, dtype=newest.dtype) == newest).astype(sy_hist.dtype)
    gamma = jnp.sum(sy_hist * oh) / jnp.sum(yy_hist * oh)

    solve = jax.scipy.linalg.solve_triangular
    u = solve(R, p1, lower=False)
    t = d_diag * u + gamma * jnp.matmul(YYm, u, precision=HIGHEST) \
        - gamma * p2
    v = solve(R.T, t, lower=True)

    if _ONEHOT:
        v_phys = mat(P.T, jnp.where(valid, v, 0.0))
        u_phys = mat(P.T, jnp.where(valid, u, 0.0))
    else:
        v_phys = jnp.zeros((m,), dtype).at[slots].set(
            jnp.where(valid, v, 0.0))
        u_phys = jnp.zeros((m,), dtype).at[slots].set(
            jnp.where(valid, u, 0.0))

    bad_gamma = (gamma <= 0) | ~jnp.isfinite(gamma)
    bad_rho = jnp.any(valid & ~jnp.isfinite(
        1.0 / jnp.where(valid, jnp.diagonal(SY), 1.0)))
    small_ok = jnp.all(jnp.isfinite(v_phys)) & jnp.all(jnp.isfinite(u_phys))
    hist_len = jnp.minimum(n_pairs, m)
    fallback = bad_rho | bad_gamma | (hist_len == 0) | ~small_ok

    gg = g_norm * g_norm
    g_dot_d = -(gamma * gg + jnp.vdot(v, p1, precision=HIGHEST)
                - gamma * jnp.vdot(u, p2, precision=HIGHEST))
    return v_phys, u_phys, gamma, g_dot_d, fallback


# --- the Triton kernel -----------------------------------------------------------

def _chain_kernel(syp_ref, yyp_ref, sgp_ref, ygp_ref, syh_ref, yyh_ref,
                  np_ref, gn_ref, vphys_ref, uphys_ref, gamma_ref, gdd_ref,
                  fb_ref, *, m: int, skip_thr, lanes: int):
    """One program solves ``lanes`` instances, one per thread lane.  The
    logical->physical slot map of every lane is a cyclic rotation
    (slot(l) = (base + l) % m), so reordering is a per-lane gather load and
    the scatter back a per-lane store — no permutation products, no
    gathers of the (m, m) blocks beyond the entries each step reads."""
    f32 = jnp.float32
    B = np_ref.shape[0]
    lane = pl.program_id(0) * lanes + jnp.arange(lanes, dtype=jnp.int32)
    ok = lane < B
    mm = lane * (m * m)
    mv = lane * m

    def ld(ref, off):
        return plgpu.load(ref.at[off], mask=ok, other=0.0)

    npi = plgpu.load(np_ref.at[lane], mask=ok, other=0)
    mi = jnp.int32(m)
    hist = jnp.minimum(npi, mi)
    base = lax.rem(npi - hist, mi)
    slot = [lax.rem(base + jnp.int32(l), mi) for l in range(m)]

    def sy_at(l, q):                      # SY in logical order
        return ld(syp_ref, mm + slot[l] * m + slot[q])

    def yy_at(l, q):
        return ld(yyp_ref, mm + slot[l] * m + slot[q])

    diag = [sy_at(l, l) for l in range(m)]
    valid = [jnp.int32(l) < hist for l in range(m)]
    if skip_thr is not None:
        valid = [valid[l] & (diag[l] > skip_thr) for l in range(m)]
    zero = jnp.zeros((lanes,), f32)
    one = jnp.ones((lanes,), f32)
    p1 = [jnp.where(valid[l], ld(sgp_ref, mv + slot[l]), zero)
          for l in range(m)]
    p2 = [jnp.where(valid[l], ld(ygp_ref, mv + slot[l]), zero)
          for l in range(m)]
    pivot = [jnp.where(valid[l], diag[l], one) for l in range(m)]

    def r_at(l, q):                       # R upper-triangular, q > l
        return jnp.where(valid[l] & valid[q], sy_at(l, q), zero)

    # gamma from the newest pair's exact scalars
    newest = lax.rem(npi + jnp.int32(m - 1), mi)
    gamma = ld(syh_ref, mv + newest) / ld(yyh_ref, mv + newest)

    # back substitution: R u = p1
    u = [None] * m
    for i in range(m - 1, -1, -1):
        acc = p1[i]
        for j in range(i + 1, m):
            acc = acc - r_at(i, j) * u[j]
        u[i] = acc / pivot[i]
    # t = D u + gamma * (YYm @ u) - gamma * p2
    t = [None] * m
    for i in range(m):
        acc = zero
        for q in range(m):
            acc = acc + jnp.where(valid[i] & valid[q], yy_at(i, q),
                                  zero) * u[q]
        t[i] = pivot[i] * u[i] + gamma * acc - gamma * p2[i]
    # forward substitution: R^T v = t
    v = [None] * m
    for i in range(m):
        acc = t[i]
        for j in range(i):
            acc = acc - r_at(j, i) * v[j]
        v[i] = acc / pivot[i]

    # scatter back: logical l lives in physical slot(l)
    small_ok = ok
    bad_rho = jnp.zeros((lanes,), jnp.bool_)
    for l in range(m):
        vz = jnp.where(valid[l], v[l], zero)
        uz = jnp.where(valid[l], u[l], zero)
        plgpu.store(vphys_ref.at[mv + slot[l]], vz, mask=ok)
        plgpu.store(uphys_ref.at[mv + slot[l]], uz, mask=ok)
        small_ok = small_ok & jnp.isfinite(vz) & jnp.isfinite(uz)
        bad_rho = bad_rho | (valid[l] & ~jnp.isfinite(1.0 / pivot[l]))
    bad_gamma = (gamma <= 0) | ~jnp.isfinite(gamma)
    fb = bad_rho | bad_gamma | (hist == 0) | ~small_ok

    gn = ld(gn_ref, lane)
    vdp1 = v[0] * p1[0]
    udp2 = u[0] * p2[0]
    for l in range(1, m):
        vdp1 = vdp1 + v[l] * p1[l]
        udp2 = udp2 + u[l] * p2[l]
    plgpu.store(gamma_ref.at[lane], gamma, mask=ok)
    plgpu.store(gdd_ref.at[lane], -(gamma * (gn * gn) + vdp1 - gamma * udp2),
                mask=ok)
    plgpu.store(fb_ref.at[lane], fb.astype(jnp.int32), mask=ok)


def chain_triton(SY_p, YY_p, Sg_p, Yg_p, sy_hist, yy_hist, n_pairs, g_norm,
                 m: int, skip_thr, lanes: int = LANES_PER_PROGRAM,
                 num_warps: int = NUM_WARPS, interpret: bool = False):
    """Batched chain, one Triton program per ``lanes`` instances.  Inputs
    (B, m, m) / (B, m) / (B,) f32 in their natural layout (no transposes);
    any B.  Returns batched (B, ...) outputs like ``jax.vmap(chain_jnp)``.
    ``interpret`` runs the Pallas interpreter (tests only)."""
    B = SY_p.shape[0]
    f32 = jnp.float32
    flat = lambda a: a.astype(f32).reshape(-1)
    outs = pl.pallas_call(
        partial(_chain_kernel, m=m, skip_thr=skip_thr,
                          lanes=lanes),
        out_shape=(jax.ShapeDtypeStruct((B * m,), f32),
                   jax.ShapeDtypeStruct((B * m,), f32),
                   jax.ShapeDtypeStruct((B,), f32),
                   jax.ShapeDtypeStruct((B,), f32),
                   jax.ShapeDtypeStruct((B,), jnp.int32)),
        grid=(pl.cdiv(B, lanes),),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=interpret,
        name="compact_chain",
    )(flat(SY_p), flat(YY_p), flat(Sg_p), flat(Yg_p), flat(sy_hist),
      flat(yy_hist), n_pairs.astype(jnp.int32), g_norm.astype(f32))
    v, u, gamma, gdd, fb = outs
    return v.reshape(B, m), u.reshape(B, m), gamma, gdd, fb != 0


@lru_cache(maxsize=32)
def make_compact_chain(m: int, skip_thr, interpret: bool = False):
    """The compact direction's small-matrix chain as a custom-vmapped
    callable: unbatched calls trace chain_jnp verbatim; a vmapped call with
    f32 operands runs the Triton kernel in programs compiled for CUDA and
    the vmapped jnp formulation elsewhere (chosen at lowering by
    ``lax.platform_dependent``).  Other dtypes and nested batches always
    take the vmapped jnp formulation.  ``interpret=True`` runs the kernel in
    the Pallas interpreter on any platform (tests).

    Cached on its arguments so repeated jits see the same callable object.

    Caveat (2-D mesh): under ``vmap(..., spmd_axis_name=...)`` with the
    batch axis sharded, the opaque pallas_call forces the small operands to
    replicate around it — correct, and cheap for these KB-scale arrays, but
    it is the single-device kernel running per replica, not a partitioned
    kernel.
    """
    from jax.custom_batching import custom_vmap

    impl = partial(chain_jnp, m=m, skip_thr=skip_thr)

    @custom_vmap
    def chain(SY_p, YY_p, Sg_p, Yg_p, sy_hist, yy_hist, n_pairs, g_norm):
        return impl(SY_p, YY_p, Sg_p, Yg_p, sy_hist, yy_hist, n_pairs,
                    g_norm)

    @chain.def_vmap
    def _rule(axis_size, in_batched, *args):
        args = [a if b else
                jnp.broadcast_to(a, (axis_size,) + jnp.shape(a))
                for a, b in zip(args, jax.tree.leaves(in_batched))]
        SY_p = args[0]
        plain = jax.vmap(impl)
        if SY_p.ndim != 3 or SY_p.dtype != jnp.float32:
            outs = plain(*args)
        else:
            kernel = partial(chain_triton, m=m, skip_thr=skip_thr,
                             interpret=interpret)
            outs = kernel(*args) if interpret else \
                lax.platform_dependent(*args, cuda=kernel, default=plain)
        return outs, (True,) * 5

    return chain
