"""Hand-written kernels against what XLA makes of their plain twins, on the
card: agreement and time per call.

Shared by chip_smoke.py (phase 1: one configuration each, checked against
a tolerance) and scripts/kernel_ab.py (block-size sweeps).  Times come
from a jitted fori_loop of dependent calls fenced by block_until_ready, so
they are device time per call without a dispatch each; every output class
is consumed so XLA cannot drop part of its twin's work.
"""
from __future__ import annotations

import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..kernels.chain import chain_jnp, chain_triton
from ..kernels.tail import fused_tail_jnp, fused_tail_triton
from ..problems.suite import fused_value_and_grad
from ..types import hist_block

# Output positions of the tail that are vectors; the rest are sums.
TAIL_VECTORS = (0, 2, 3, 4)


def _key(block, warps) -> str:
    return "default" if block is None and warps is None \
        else f"{block}x{warps}"


def best_wall(fn, *args, reps: int = 5) -> float:
    """Best wall of ``reps`` calls after one warm-up call."""
    jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def looped(step, n: int):
    """jit of ``n`` dependent applications of step(carry, *consts); the
    constants are arguments, not captured, so large arrays stay out of the
    executable."""
    return jax.jit(lambda c, *k: lax.fori_loop(0, n,
                                               lambda _, c: step(c, *k), c))


def rel_errs(got, ref) -> list:
    """Per output: max|got - ref| / max|ref| (None outputs skipped)."""
    out = []
    for a, b in zip(got, ref):
        if a is None:
            continue
        a = np.asarray(a, np.float64)
        b = np.asarray(b, np.float64)
        out.append(float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-30)))
    return out


def tail_ab(d: int, with_matvec: bool, configs=((None, None),),
            m: int = 10, hdtype=jnp.float32, reps: int = 200,
            problem: str = "rosenbrock") -> dict:
    """The Triton tail vs fused_tail_jnp at width d, for each (block,
    num_warps) in ``configs`` (None: the module defaults).  Returns
    {"xla_us", "kernels": {"BxW": {"us", "vec_err", "sum_err",
    "memory"}}}."""
    rng = np.random.default_rng(d)
    f32 = jnp.float32
    x = jnp.asarray(rng.uniform(-2, 2, d), f32)
    dv = jnp.asarray(rng.uniform(-1, 1, d) * 1e-3, f32)
    g = jnp.asarray(rng.uniform(-1, 1, d), f32)
    S = jnp.asarray(rng.uniform(-1, 1, (m,) + hist_block(d)), f32)
    Y = jnp.asarray(rng.uniform(-1, 1, (m,) + hist_block(d)), f32)
    S, Y = S.astype(hdtype), Y.astype(hdtype)
    alpha = f32(0.5)
    vg = fused_value_and_grad(problem)

    def plain(*a):
        return fused_tail_jnp(vg, *a, with_matvec)

    def step(c, dv, S, Y, fn):
        x, g, acc = c
        o = fn(x, dv, alpha, g, S, Y)
        extra = o[11][0] + o[12][0] if with_matvec else 0.0
        return o[0], o[2], acc + o[1] + o[5] + extra

    ref = jax.jit(plain)(x, dv, alpha, g, S, Y)
    c0 = (x, g, f32(0))
    out = {"xla_us": best_wall(looped(partial(step, fn=plain), reps), c0,
                               dv, S, Y) / reps * 1e6, "kernels": {}}
    for block, warps in configs:
        kern = partial(fused_tail_triton, problem, with_matvec=with_matvec,
                       block=block, num_warps=warps)
        lowered = jax.jit(kern).lower(x, dv, alpha, g, S, Y)
        if "triton" not in lowered.as_text():
            raise RuntimeError("no Triton kernel in the lowered program")
        compiled = lowered.compile()
        errs = rel_errs(compiled(x, dv, alpha, g, S, Y), ref)
        us = best_wall(looped(partial(step, fn=kern), reps), c0,
                       dv, S, Y) / reps * 1e6
        out["kernels"][_key(block, warps)] = {
            "us": us,
            "vec_err": max(errs[i] for i in TAIL_VECTORS),
            "sum_err": max(e for i, e in enumerate(errs)
                           if i not in TAIL_VECTORS),
            "memory": str(compiled.memory_analysis())}
    return out


def chain_inputs(B: int, m: int = 10):
    """Random well-conditioned chain operands for B lanes."""
    rng = np.random.default_rng(B)
    f32 = jnp.float32
    SY = rng.uniform(0.1, 2.0, (B, m, m))
    SY[:, np.arange(m), np.arange(m)] += 2.0
    return (jnp.asarray(SY, f32),
            jnp.asarray(rng.uniform(0.1, 2.0, (B, m, m)), f32),
            jnp.asarray(rng.uniform(-1, 1, (B, m)), f32),
            jnp.asarray(rng.uniform(-1, 1, (B, m)), f32),
            jnp.asarray(rng.uniform(0.1, 2.0, (B, m)), f32),
            jnp.asarray(rng.uniform(0.1, 2.0, (B, m)), f32),
            jnp.asarray(rng.integers(0, 4 * m, (B,)), jnp.int32),
            jnp.asarray(rng.uniform(0.1, 10.0, (B,)), f32))


def chain_ab(B: int, configs=((None, None),), m: int = 10,
             reps: int = 200) -> dict:
    """The Triton chain vs the vmapped jnp chain for B lanes, for each
    (lanes, num_warps) in ``configs``.  Returns {"xla_us", "kernels":
    {"LxW": {"us", "err", "fallback_equal", "memory"}}}; err is over the
    lanes that do not fall back."""
    args = chain_inputs(B, m)
    plain = jax.vmap(partial(chain_jnp, m=m, skip_thr=1e-10))

    def step(c, fn):
        gn, acc = c
        o = fn(*args[:7], gn)
        return gn + 1e-30 * o[3], acc + o[2].sum() + o[0].sum() + o[1].sum()

    ref = jax.jit(plain)(*args)
    ok = ~np.asarray(ref[4])
    c0 = (args[7], jnp.float32(0))
    out = {"xla_us": best_wall(looped(partial(step, fn=plain), reps),
                               c0) / reps * 1e6, "kernels": {}}
    for lanes, warps in configs:
        kw = {k: v for k, v in (("lanes", lanes), ("num_warps", warps))
              if v is not None}
        kern = partial(chain_triton, m=m, skip_thr=1e-10, **kw)
        lowered = jax.jit(kern).lower(*args)
        if "triton" not in lowered.as_text():
            raise RuntimeError("no Triton kernel in the lowered program")
        compiled = lowered.compile()
        got = compiled(*args)
        err = max(rel_errs([np.asarray(a)[ok] for a in got[:4]],
                           [np.asarray(b)[ok] for b in ref[:4]]))
        out["kernels"][_key(lanes, warps)] = {
            "us": best_wall(looped(partial(step, fn=kern), reps),
                            c0) / reps * 1e6,
            "err": err,
            "fallback_equal": bool(np.array_equal(np.asarray(got[4]),
                                                  np.asarray(ref[4]))),
            "memory": str(compiled.memory_analysis())}
    return out
