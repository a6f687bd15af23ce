"""Explicit-SPMD fused objective evaluation: shard_map + halo exchange + psum.

The auto-partitioned jnp objectives already compile correctly under pjit
(XLA inserts the halo collectives for the shifted slices); this module is the
*explicit* formulation — per-shard chunk evaluation with one-element halo
``ppermute``s over the mesh axis and a single ``psum`` for the value — which
is (a) the form that can host per-shard kernels (a pallas_call inside
shard_map runs on each device's local block; SURVEY.md §2 native-code
census item 2: "reduction kernels feeding jax.lax.psum"), and (b) the
communication-minimal recipe: exactly one scalar each way per neighbor per
evaluation.

Chain objectives (rosenbrock, coupled_quadratic) assign term i to the shard
owning element i; the shard's last term needs the next shard's first element
(forward halo), and the gradient's first element needs the previous shard's
last element (backward halo).

ROLE: this module is the readable jnp REFERENCE for the halo/ownership
semantics that ``dist.pallas_sharded`` implements with the kernel bodies —
production sharded solves run pallas_sharded; tests/test_dist_pallas.py
cross-asserts the two agree
(``test_pallas_sharded_matches_shardmap_vg_reference``).
"""
from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def _halos(x_local, axis: str):
    """(prev_last, next_first, has_prev, has_next) via one ppermute each way."""
    n = lax.axis_size(axis)
    idx = lax.axis_index(axis)
    fwd = [(i, (i + 1) % n) for i in range(n)]   # my last -> right neighbor
    bwd = [(i, (i - 1) % n) for i in range(n)]   # my first -> left neighbor
    prev_last = lax.ppermute(x_local[-1:], axis, fwd)[0]
    next_first = lax.ppermute(x_local[:1], axis, bwd)[0]
    return prev_last, next_first, idx > 0, idx < n - 1


def _rosenbrock_chunk(x, prev_last, next_first, has_prev, has_next):
    """Partial f and full local gradient for the owned chain terms."""
    xn_in = jnp.concatenate([x[1:], next_first[None]])
    # Terms i for local elements; the last local element's term only exists
    # when a next shard provides x[i+1].
    term_mask = jnp.ones(x.shape, bool).at[-1].set(has_next)
    t = jnp.where(term_mask, xn_in - x * x, 0.0)
    e = jnp.where(term_mask, 1.0 - x, 0.0)
    f_part = jnp.sum(100.0 * t * t + e * e)

    g = jnp.where(term_mask, 2.0 * (x - 1.0) - 400.0 * x * t, 0.0)
    # Inbound 200*(x[i] - x[i-1]^2) from term i-1; first element's only when
    # a previous shard exists.
    xp = jnp.concatenate([prev_last[None], x[:-1]])
    prev_mask = jnp.ones(x.shape, bool).at[0].set(has_prev)
    g = g + jnp.where(prev_mask, 200.0 * (x - xp * xp), 0.0)
    return f_part, g


def _coupled_chunk(x, prev_last, next_first, has_prev, has_next,
                   coeff=1000.0):
    xn_in = jnp.concatenate([x[1:], next_first[None]])
    term_mask = jnp.ones(x.shape, bool).at[-1].set(has_next)
    cross = jnp.where(term_mask, x * xn_in, 0.0)
    f_part = coeff * jnp.sum(x * x) + (coeff / 10.0) * jnp.sum(cross)

    g = 2.0 * coeff * x + jnp.where(term_mask, (coeff / 10.0) * xn_in, 0.0)
    xp = jnp.concatenate([prev_last[None], x[:-1]])
    prev_mask = jnp.ones(x.shape, bool).at[0].set(has_prev)
    g = g + jnp.where(prev_mask, (coeff / 10.0) * xp, 0.0)
    return f_part, g


def _quadratic_chunk(x, prev_last, next_first, has_prev, has_next):
    r = x - 1.0
    return jnp.sum(r * r), 2.0 * r


_CHUNKS = {
    "rosenbrock": _rosenbrock_chunk,
    "coupled_quadratic": _coupled_chunk,
    "quadratic": _quadratic_chunk,
}


def shardmap_value_and_grad(problem: str, mesh: Mesh,
                            axis: str = "d") -> Callable:
    """vg(x) with x sharded on `axis`: per-shard chunk evaluation, one-element
    halo ppermutes, one psum for the value.  Returns (f replicated, g sharded
    like x)."""
    chunk = _CHUNKS[problem]

    def impl(x_local):
        x_local = x_local.reshape(-1)  # shard_map passes the local block
        prev_last, next_first, has_prev, has_next = _halos(x_local, axis)
        f_part, g_local = chunk(x_local, prev_last, next_first,
                                has_prev, has_next)
        return lax.psum(f_part, axis), g_local

    smapped = jax.shard_map(
        impl, mesh=mesh, in_specs=P(axis), out_specs=(P(), P(axis)))

    def vg(x):
        return smapped(x)

    return vg
