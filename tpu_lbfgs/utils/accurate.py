"""Compensated (Neumaier) reductions for f32 accuracy (SURVEY.md §7 hard
part: "offer f32 + compensated-summation dot as an option").

At d ~ 1e8 a plain f32 dot product loses ~sqrt(d)*eps relative accuracy to
rounding of the partial sums; near convergence that noise can flip the
curvature test s.y > 0 (lbfgs.cpp:182) or the gamma sign guard.  The
compensated reduction keeps the vectorized inner passes and runs a Neumaier
error-compensated accumulation over the per-chunk partials, recovering most
of the lost bits without f64 arithmetic on the hot path.

Enabled via LBFGSConfig(accurate_dots=True); applies to the curvature-pair
scalars (s.y, y.y, ||g||^2) in the jnp iteration tail.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import Array, lax


def _neumaier_sum(parts: Array) -> Array:
    """Error-compensated sum of a 1-D vector of partials (Neumaier variant of
    Kahan summation), as a lax.scan over scalars."""

    def step(carry, p):
        s, c = carry
        t = s + p
        # |s| >= |p|: low-order bits of p are lost, else of s.
        comp = jnp.where(jnp.abs(s) >= jnp.abs(p),
                         (s - t) + p, (p - t) + s)
        return (t, c + comp), None

    (s, c), _ = lax.scan(step, (jnp.zeros((), parts.dtype),
                                jnp.zeros((), parts.dtype)), parts)
    return s + c


def compensated_dot(a: Array, b: Array, chunks: int = 1024) -> Array:
    """a . b with vectorized chunk partials + compensated combine.

    The chunk partials are plain f32 sums (full vector throughput, one pass);
    only the O(chunks) combine is compensated — that is where the magnitude
    disparity (and hence the rounding loss) concentrates.
    """
    n = a.shape[0]
    c = min(chunks, n)
    pad = (-n) % c
    if pad:
        a = jnp.pad(a, (0, pad))
        b = jnp.pad(b, (0, pad))
    parts = jnp.sum((a * b).reshape(c, -1), axis=1)
    return _neumaier_sum(parts)


def compensated_norm_sq(a: Array, chunks: int = 1024) -> Array:
    return compensated_dot(a, a, chunks)


def compensated_sum(parts: Array) -> Array:
    """Error-compensated sum over axis 0 of ``parts`` (n, ...), as a
    pairwise tree: each level adds neighbouring rows and keeps the exact
    rounding error of every add (Knuth's TwoSum) in a running compensation
    that is folded in at the end.  log2(n) vectorized levels — no
    sequential scan — so it suits per-block partials of a GPU kernel."""
    s = parts
    c = jnp.zeros_like(parts)
    while s.shape[0] > 1:
        if s.shape[0] % 2:
            zero = jnp.zeros((1,) + s.shape[1:], s.dtype)
            s = jnp.concatenate([s, zero])
            c = jnp.concatenate([c, zero])
        a, b = s[0::2], s[1::2]
        t = a + b
        bv = t - a
        err = (a - (t - bv)) + (b - bv)
        c = c[0::2] + c[1::2] + err
        s = t
    return s[0] + c[0]
