"""Scaling-efficiency measurement: iterations/s at 1 shard vs N shards.

BASELINE.md north star: "scaling efficiency reported at 1 device / N
devices".  With cfg.use_pallas the sharded stack runs the per-shard fused
tail inside shard_map (dist.pallas_sharded; the Triton kernel on the GPU).
The report records which stack ran (``stack`` per row) and the device
(harness.require_gpu: a measurement needs a GPU).

Efficiency definition: eff(N) = T(1) / T(N) / N for a FIXED global problem
size d (strong scaling) — perfect overlap of the N-way-split memory streams
with the psum latency gives eff = 1.
"""
from __future__ import annotations

import time
from functools import partial
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..config import LBFGSConfig
from ..core.solver import init_state, make_value_and_grad, solve_from_state
from ..dist.mesh import make_mesh, state_shardings
from ..dist.pallas_sharded import (
    SHARDED_PALLAS_PROBLEMS,
    shardmap_fused_tail,
    shardmap_fused_vg,
)
from ..dist.sharded import _pad_for_mesh
from ..problems import get_problem
from .harness import require_gpu


def bench_sharded(problem: str, d: int, iters: int, cfg: LBFGSConfig,
                  n_devices: int, dtype=jnp.float32, repeats: int = 3,
                  seed: int = 42,
                  use_pallas: Optional[bool] = None,
                  with_matvec: bool = False) -> dict:
    """Fixed-iteration throughput with the vector sharded over n_devices.

    use_pallas=None selects the fused-tail stack for f32 suite problems.
    n_devices == 1 runs the same stacks unsharded (the scaling baseline).

    with_matvec: compute the incremental-products history matvecs inside the
    fused tail, finished by the packed psum.  Recorded in the ``stack``
    label.
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    device = require_gpu()
    if use_pallas is None:
        use_pallas = (dtype == jnp.float32
                      and problem in SHARDED_PALLAS_PROBLEMS)
    elif use_pallas and (
            problem not in SHARDED_PALLAS_PROBLEMS or dtype != jnp.float32):
        # Explicit use_pallas=True for a problem without a shard-composable
        # fused tail (or a non-f32 dtype the kernel doesn't take): warn and
        # run the jnp path rather than KeyError inside shardmap_fused_vg —
        # and for n_devices == 1 rather than benchmarking the jnp path
        # under a 'fused-unsharded' label.
        import warnings

        warnings.warn(
            f"no {'sharded ' if n_devices > 1 else ''}fused tail for "
            f"problem={problem!r} dtype={jnp.dtype(dtype).name}; "
            f"benchmarking the jnp path", RuntimeWarning, stacklevel=2)
        use_pallas = False
    devices = jax.devices()[:n_devices]
    mesh = make_mesh(devices)
    cfg = cfg.replace(max_iters=iters, tol=0.0,
                      use_pallas=use_pallas and n_devices == 1)
    p = get_problem(problem)
    vg = make_value_and_grad(p.f, p.grad)
    dir_poly = p.dir_poly if cfg.ls_eval == "polynomial" else None

    rng = np.random.default_rng(seed)
    x0 = jnp.asarray(rng.uniform(-2, 2, d), dtype)
    fused_tail = None
    if use_pallas and n_devices > 1:
        f, vg, x0, d_orig, dir_poly = _pad_for_mesh(
            p.f, vg, x0, n_devices, dir_poly=dir_poly)
        vg = shardmap_fused_vg(problem, mesh, d_orig)
        fused_tail = shardmap_fused_tail(problem, mesh, d_orig,
                                         with_matvec=with_matvec)
        stack = "fused-shard+matvec" if with_matvec else "fused-shard"
    elif use_pallas:
        # n_devices == 1: the unsharded fused stack on the ORIGINAL d (the
        # tail handles any d; padding here would pair the padded f with a
        # raw vg whose pad-coordinate gradient is nonzero for chain
        # objectives — a different problem).
        from ..problems.suite import fused_tail_for, fused_value_and_grad

        f = p.f
        vg = fused_value_and_grad(problem)
        fused_tail = fused_tail_for(problem, with_matvec=with_matvec,
                                    accurate_dots=cfg.accurate_dots)
        stack = ("fused-unsharded+matvec" if with_matvec
                 else "fused-unsharded")
    else:
        f, vg, x0, d_orig, dir_poly = _pad_for_mesh(
            p.f, vg, x0, n_devices, dir_poly=dir_poly)
        stack = "jnp-shard"

    st_sh = state_shardings(mesh)
    x_sh = NamedSharding(mesh, P("d"))
    x0 = jax.device_put(x0, x_sh)

    make = jax.jit(lambda x: init_state(vg, x, cfg.m, cfg.history_dtype),
                   out_shardings=st_sh)
    run = jax.jit(partial(solve_from_state, cfg, f, vg,
                          dir_poly=dir_poly, fused_tail=fused_tail),
                  in_shardings=(st_sh,), out_shardings=st_sh)

    state = make(x0)
    out = jax.block_until_ready(run(state))       # warmup / compile
    best = np.inf
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = jax.block_until_ready(run(state))
        best = min(best, time.perf_counter() - t0)
    return {"n_devices": n_devices, "iters_per_s": iters / best,
            "wall_s": best, "final_f": float(out.f), "stack": stack,
            "device": device}


def scaling_sweep(problem: str = "rosenbrock", d: int = 1 << 22,
                  iters: int = 50, cfg: Optional[LBFGSConfig] = None,
                  device_counts: Optional[Sequence[int]] = None,
                  dtype=jnp.float32,
                  use_pallas: Optional[bool] = None,
                  with_matvec: bool = False) -> list[dict]:
    """Strong-scaling sweep over shard counts; adds efficiency vs 1 device."""
    cfg = cfg or LBFGSConfig(line_search="backtracking",
                             direction="compact_incremental",
                             ls_eval="polynomial")
    n = len(jax.devices())
    if device_counts is None:
        device_counts = [c for c in (1, 2, 4, 8, 16, 32) if c <= n]
    rows = []
    base_rate = base_n = None
    for c in device_counts:
        r = bench_sharded(problem, d, iters, cfg, c, dtype,
                          use_pallas=use_pallas, with_matvec=with_matvec)
        if base_rate is None:
            base_rate, base_n = r["iters_per_s"], c
        # Relative to the FIRST measured count (usually 1; when d is too
        # large for one device the baseline is device_counts[0] and the
        # efficiency denominator scales by c/base_n, not the absolute c).
        r["speedup"] = r["iters_per_s"] / base_rate
        r["efficiency"] = r["speedup"] / (c / base_n)
        rows.append(r)
    return rows
