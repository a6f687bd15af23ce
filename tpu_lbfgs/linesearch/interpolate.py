"""Interpolation helpers for the line searches.

Clean-room JAX ports of the reference's interpolation math:
  - cubic_interpolate      (sequential-implementation/line_search.cpp:8-12)
  - quadratic_interpolate  (line_search.cpp:14-16)
  - safe_cubic_interpolate (parallel-implementation/line_search.cpp:231-296)

All are scalar->scalar, branchless (jnp.where), and NaN-propagating exactly
like their C++ counterparts (C++ sqrt of a negative is NaN, not an exception,
so the raw cubic can and does return NaN — the safe variant guards this).

Fidelity traps #4 and #5 (see linesearch/strategies.py): the reference's
cubic anchors the Nocedal-Wright minimizer formula at a0 WITHOUT flipping
d2's sign, which selects the cubic's MAXIMIZER root (verifiable on
phi(a) = a^3/3 - a through (0, 3): reference returns -1, the maximizer;
the minimizer is +1), and its quadratic mixes the anchor points so an
Armijo-failed trial interpolates to a LARGER step.  Both are reproduced
verbatim here for trajectory parity; the ``*_fixed`` variants implement the
textbook formulas and are used under ``cfg.fidelity == "fixed"``.
"""
from __future__ import annotations

import jax.numpy as jnp
from jax import Array


def cubic_interpolate(a0: Array, a1: Array, p0: Array, dp0: Array,
                      p1: Array, dp1: Array) -> Array:
    """The reference's cubic through (a0,p0,dp0), (a1,p1,dp1); may return NaN.
    NOTE: selects the cubic's MAXIMIZER root (fidelity trap #4) — kept
    verbatim for trajectory parity; see cubic_interpolate_fixed."""
    d1 = dp0 + dp1 - 3.0 * (p1 - p0) / (a1 - a0)
    d2 = jnp.copysign(jnp.sqrt(d1 * d1 - dp0 * dp1), a1 - a0)
    return a0 + (a1 - a0) * (dp0 + d2 - d1) / (dp0 - dp1 + 2.0 * d2)


def cubic_interpolate_fixed(a0: Array, a1: Array, p0: Array, dp0: Array,
                            p1: Array, dp1: Array) -> Array:
    """Textbook cubic MINIMIZER (Nocedal & Wright eq. 3.59, anchored at a1);
    may return NaN on a negative discriminant, like the reference variant."""
    d1 = dp0 + dp1 - 3.0 * (p1 - p0) / (a1 - a0)
    d2 = jnp.copysign(jnp.sqrt(d1 * d1 - dp0 * dp1), a1 - a0)
    return a1 - (a1 - a0) * (dp1 + d2 - d1) / (dp1 - dp0 + 2.0 * d2)


def quadratic_interpolate(a0: Array, a1: Array, p0: Array, dp0: Array,
                          p1: Array) -> Array:
    """The reference's quadratic; called with (alpha, 0, f_new, dphi0, f_x).
    NOTE: mixes the anchor points (phi0 at the trial, dphi0 at 0), returning
    a step LARGER than alpha after an Armijo failure (fidelity trap #5) —
    kept verbatim for parity; see quadratic_interpolate_fixed."""
    return a0 - 0.5 * dp0 * a0 * a0 / (p1 - p0 - dp0 * a0)


def quadratic_interpolate_fixed(alpha: Array, p0: Array, dp0: Array,
                                p_alpha: Array) -> Array:
    """Textbook one-point quadratic minimizer through phi(0)=p0,
    phi'(0)=dp0, phi(alpha)=p_alpha (Nocedal & Wright eq. 3.58)."""
    return -0.5 * dp0 * alpha * alpha / (p_alpha - p0 - dp0 * alpha)


def safe_cubic_interpolate(a0: Array, a1: Array, p0: Array, dp0: Array,
                           p1: Array, dp1: Array,
                           denom_eps: float = 1e-10,
                           fixed: bool = False) -> Array:
    """Guarded cubic: swaps so a0<a1, falls back to the midpoint on any
    NaN/inf/negative-discriminant/small-denominator, and clamps the result
    into the central 80% of [a0, a1].  fixed=True uses the textbook
    minimizer root (cubic_interpolate_fixed) under the same guards."""
    swap = a0 > a1
    a0, a1 = jnp.where(swap, a1, a0), jnp.where(swap, a0, a1)
    p0, p1 = jnp.where(swap, p1, p0), jnp.where(swap, p0, p1)
    dp0, dp1 = jnp.where(swap, dp1, dp0), jnp.where(swap, dp0, dp1)

    mid = 0.5 * (a0 + a1)
    span = a1 - a0

    d1 = dp0 + dp1 - 3.0 * (p1 - p0) / span
    disc = d1 * d1 - dp0 * dp1
    d2 = jnp.copysign(jnp.sqrt(jnp.maximum(disc, 0.0)), span)
    if fixed:
        denom = dp1 - dp0 + 2.0 * d2
        result = a1 - span * (dp1 + d2 - d1) / denom
    else:
        denom = dp0 - dp1 + 2.0 * d2
        result = a0 + span * (dp0 + d2 - d1) / denom

    bad = (
        ~jnp.isfinite(d1)
        | (disc < 0.0)
        | (jnp.abs(denom) < denom_eps)
        | ~jnp.isfinite(result)
    )
    result = jnp.where(bad, mid, result)
    # Midpoint fallback lies inside the clamp band, so clamping unconditionally
    # matches the reference's early returns.
    return jnp.clip(result, a0 + 0.1 * span, a1 - 0.1 * span)
