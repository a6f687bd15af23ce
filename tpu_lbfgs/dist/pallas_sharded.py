"""The fused iteration tail composed with sharding: the per-device kernel
inside ``shard_map``, boundary elements exchanged by one-element
``ppermute`` halos, scalars finished with a single ``psum``.

This is SURVEY.md §2 native-code census item 2 ("reduction kernels feeding
``jax.lax.psum`` across shards"): the reference's analogue is the
shared-memory reduction kernel whose per-block partials are finished on the
host (parallel-implementation/L-BFGS-Backtracking.cu:117-137,302-306); here
the per-SHARD partials are finished by a collective with no host
involvement.

Design: each device runs the single-device tail (kernels.tail) on its local
block, with three extra inputs that make it location-aware:
  - ``start``  — the shard's global element offset (axis_index * d_local),
                 so the global-index masking (term ownership, padding) is
                 exact;
  - ``edges``  — the neighbouring shards' boundary elements of x and d,
                 obtained with one ppermute each way;
  - ``n``      — the GLOBAL unpadded problem size: the masking then
                 implements the zero-padded-tail semantics natively, so the
                 sharded solve needs no objective wrapper.

In programs compiled for CUDA the per-shard tail is the Triton kernel;
elsewhere it is ``local_tail_jnp``, the same algebra in plain ops.  The
value-and-gradient (``shardmap_fused_vg``) is plain ops everywhere: XLA
fuses it.

Communication per call: 2 (or 4) boundary scalars each way plus ONE psum of
the packed reduction vector — the minimum the chain coupling allows.
Halo-free problems (quadratic: no neighbour terms) skip the ppermutes
entirely and pay only the psum.
"""
from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ..kernels.tail import (
    TAIL_BODIES,
    fused_tail_triton,
    history_matvecs,
    pair_scalars,
)

# Problems with a shard-composable fused tail.
SHARDED_PALLAS_PROBLEMS = frozenset(TAIL_BODIES)


def _needs_halo(problem: str) -> bool:
    """Whether the problem reads neighbour elements (chain terms).
    Halo-free problems ignore their edge inputs, so the ppermutes would be
    pure dead latency on the per-iteration critical path."""
    return TAIL_BODIES[problem][1]


def _edge_pair(v_local, axis: str):
    """(prev shard's last element, next shard's first element) via one
    ppermute each way; wraparound values at the global boundary are discarded
    by the global-index masks."""
    n = lax.axis_size(axis)
    fwd = [(i, (i + 1) % n) for i in range(n)]   # my last -> right neighbour
    bwd = [(i, (i - 1) % n) for i in range(n)]   # my first -> left neighbour
    prev_last = lax.ppermute(v_local[-1:], axis, fwd)[0]
    next_first = lax.ppermute(v_local[:1], axis, bwd)[0]
    return prev_last, next_first


def _local_vg(problem: str, x, n: int, start, prev_last, next_first):
    """f partial and gradient block of one shard from the kernel bodies."""
    body, _ = TAIL_BODIES[problem]
    xf = jnp.concatenate([x[1:], next_first[None]])
    xp = jnp.concatenate([prev_last[None], x[:-1]])
    gidx = start + jnp.arange(x.shape[0], dtype=jnp.int32)
    f_blk, g = body(x, xp, xf, gidx, n)
    return jnp.sum(f_blk), g


def local_tail_jnp(problem: str, x, d, alpha, g, s_hist, y_hist,
                   with_matvec: bool, n: int, start, edges,
                   accurate: bool = False):
    """The per-shard tail in plain ops, with the Triton kernel's contract:
    ``edges`` = [prev_x, prev_d, next_x, next_d]; the scalars and matvecs
    are this shard's partials (the caller psums them)."""
    hdtype = s_hist.dtype
    s = alpha * d
    xn = x + s
    f_part, g_new = _local_vg(problem, xn, n, start,
                              edges[0] + alpha * edges[1],
                              edges[2] + alpha * edges[3])
    y, *scal = pair_scalars(s, d, g, g_new, accurate)
    t1, t2 = (history_matvecs(s_hist, y_hist, y) if with_matvec
              else (None, None))
    return (xn, f_part, g_new, s.astype(hdtype), y.astype(hdtype),
            *scal, t1, t2)


def shardmap_fused_vg(problem: str, mesh: Mesh, n: int,
                      d_axis: str = "d") -> Callable:
    """vg(x) with x sharded on ``d_axis``: each device evaluates its local
    block with one-element halos, one psum for the value.  ``n`` is the
    global UNPADDED length (global-index masking handles any zero-padded
    tail)."""

    def impl(x_local):
        x_local = x_local.reshape(-1)
        start = lax.axis_index(d_axis) * x_local.shape[0]
        if _needs_halo(problem):
            prev_last, next_first = _edge_pair(x_local, d_axis)
        else:
            prev_last = next_first = jnp.zeros((), x_local.dtype)
        f_part, g_local = _local_vg(problem, x_local, n, start, prev_last,
                                    next_first)
        return lax.psum(f_part, d_axis), g_local

    # check_vma=False: under vmap(spmd_axis_name=...) the batch axis joins
    # the varying axes of some operands only, which the checker rejects.
    return jax.shard_map(impl, mesh=mesh, in_specs=P(d_axis),
                         out_specs=(P(), P(d_axis)), check_vma=False)


def shardmap_fused_tail(problem: str, mesh: Mesh, n: int,
                        d_axis: str = "d",
                        with_matvec: bool = False,
                        accurate_dots: bool = False,
                        interpret: bool = False) -> Callable:
    """The fused post-line-search tail (kernels.make_fused_tail) running
    per-shard inside shard_map.

    Returns ``tail(x, d, alpha, g, s_hist, y_hist)`` with the solver's exact
    contract: vectors stay sharded, the 7 reduction scalars (and the history
    matvecs when with_matvec) are finished with ONE packed psum.

    accurate_dots: per-shard compensated reductions (cfg.accurate_dots); the
    cross-shard psum is a tree over n_shards partials — negligible extra
    rounding next to the per-shard streams.
    interpret: run the per-shard Triton kernel in the Pallas interpreter
    (tests); otherwise the kernel runs where the program is compiled for
    CUDA and ``local_tail_jnp`` elsewhere.
    """

    def impl(x_l, d_l, alpha, g_l, s_h_l, y_h_l):
        x_l, d_l, g_l = (v.reshape(-1) for v in (x_l, d_l, g_l))
        start = lax.axis_index(d_axis) * x_l.shape[0]
        if _needs_halo(problem):
            px, nx = _edge_pair(x_l, d_axis)
            pd, nd = _edge_pair(d_l, d_axis)
            edges = jnp.stack([px, pd, nx, nd])
        else:
            edges = jnp.zeros((4,), x_l.dtype)
        args = (x_l, d_l, alpha, g_l, s_h_l, y_h_l, start, edges)

        def kernel(x_l, d_l, alpha, g_l, s_h_l, y_h_l, start, edges):
            return fused_tail_triton(problem, x_l, d_l, alpha, g_l, s_h_l,
                                     y_h_l, with_matvec, n=n, start=start,
                                     edges=edges, accurate=accurate_dots,
                                     interpret=interpret)

        def plain(x_l, d_l, alpha, g_l, s_h_l, y_h_l, start, edges):
            return local_tail_jnp(problem, x_l, d_l, alpha, g_l, s_h_l,
                                  y_h_l, with_matvec, n, start, edges,
                                  accurate=accurate_dots)

        if interpret:
            outs = kernel(*args)
        else:
            outs = lax.platform_dependent(*args, cuda=kernel, default=plain)
        (xnew, f_new, gnew, srow, yrow, sy, yy, gg, dgn, ggn, ygn,
         t1, t2) = outs
        scal = jnp.stack([f_new, sy, yy, gg, dgn, ggn, ygn])
        if with_matvec:
            packed = lax.psum(jnp.concatenate([scal, t1, t2]), d_axis)
            m = t1.shape[0]
            scal, t1, t2 = packed[:7], packed[7:7 + m], packed[7 + m:]
            return (xnew, scal[0], gnew, srow, yrow, scal[1], scal[2],
                    scal[3], scal[4], scal[5], scal[6], t1, t2)
        scal = lax.psum(scal, d_axis)
        return (xnew, scal[0], gnew, srow, yrow, scal[1], scal[2],
                scal[3], scal[4], scal[5], scal[6])

    vec, rep = P(d_axis), P()
    hist = P(None, d_axis, None)
    out_specs = (vec, rep, vec, vec, vec) + (rep,) * 6
    if with_matvec:
        out_specs = out_specs + (rep, rep)
    # check_vma=False: pallas_call out_shapes don't carry varying-mesh-axis
    # metadata, so shard_map's replication checker can't type them.
    smapped = jax.shard_map(
        impl, mesh=mesh,
        in_specs=(vec, vec, rep, vec, hist, hist),
        out_specs=out_specs, check_vma=False)

    def tail(x, d, alpha, g, s_hist, y_hist):
        outs = smapped(x, d, alpha, g, s_hist, y_hist)
        if with_matvec:
            return outs
        return outs + (None, None)

    tail.accurate_dots = accurate_dots
    return tail
