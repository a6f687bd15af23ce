"""Benchmark harness: timing protocol replicating the reference's experiment
setup (cuda_lbfgs.pdf §IV; SURVEY.md §6).

Protocol:
  - fixed-iteration runs (tol=0) so every implementation does identical
    algorithmic work per timed iteration — the reference instead times
    whole convergence runs, which confounds line-search trial counts;
    we report both modes.
  - seeds 42, 365, 12345, 777777, 10000 (sequential-implementation/main.cpp:33),
    mean over seeds.
  - compile excluded (one warmup), best-of-R timed repeats per seed.

CPU baseline: the native C++ oracle (-O3, -march=native) — this machine's
stand-in for the reference's sequential implementation.  The reference's
headline GPU result is 1.2x its CPU at d=10,000 (BASELINE.md), so
"reference-GPU-equivalent" throughput = 1.2 x the C++ CPU throughput.

Every device measurement here first calls ``require_gpu``: with no GPU it
raises instead of timing the CPU, and its record (platform, device kind,
count, the card's name and power limit, XLA_FLAGS) goes with the numbers.
Timings are fenced with ``jax.block_until_ready`` on the whole result.
"""
from __future__ import annotations

import os
import subprocess
import time
from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import LBFGSConfig
from ..core.solver import (
    init_state,
    make_value_and_grad,
    solve_bounded,
    solve_from_state,
)
from ..problems import get_problem

REFERENCE_SEEDS = (42, 365, 12345, 777777, 10000)
REFERENCE_GPU_SPEEDUP = 1.2  # cuda_lbfgs.pdf §IV-A headline at d=10,000


def card_name_and_power() -> str:
    """Each card's name and power limit as nvidia-smi reports them (one
    line per card), read by a child process that does not import JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip()


def device_record() -> dict:
    """What a measurement ran on, for its record."""
    devs = jax.devices()
    rec = {"platform": devs[0].platform, "kind": devs[0].device_kind,
           "count": len(devs), "xla_flags": os.environ.get("XLA_FLAGS", "")}
    if devs[0].platform == "gpu":
        rec["card"] = card_name_and_power()
    return rec


def require_gpu() -> dict:
    """Raise unless JAX's first device is a GPU; return device_record()."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"this measurement needs a GPU; JAX's first device is "
            f"{dev.platform} ({dev.device_kind})")
    return device_record()


@dataclass
class BenchResult:
    name: str
    iters_per_s: float
    wall_s: float
    iterations: int
    final_f: float
    final_g_norm: float
    details: dict


def _x0(d: int, seed: int, dtype) -> jnp.ndarray:
    # U(-2, 2) for every problem: near-valley starts keep line-search work
    # representative without needing 1e4+ iterations of warmup.
    rng = np.random.default_rng(seed)
    base = rng.uniform(-2.0, 2.0, d)
    return jnp.asarray(base, dtype)


def bench_device(problem: str = "rosenbrock", d: int = 1_000_000,
                 iters: int = 200, cfg: Optional[LBFGSConfig] = None,
                 dtype=jnp.float32, seeds=REFERENCE_SEEDS[:1],
                 repeats: int = 3, with_matvec: bool = False) -> BenchResult:
    """Fixed-iteration throughput of the jitted solver on the GPU.

    cfg.use_pallas runs the fused tail (the Triton kernel) with the fused
    value-and-gradient; ``with_matvec`` also computes the history matvecs
    in the tail."""
    device = require_gpu()
    cfg = cfg or LBFGSConfig(line_search="backtracking", direction="compact")
    cfg = cfg.replace(max_iters=iters, tol=0.0)  # tol=0: never converge early
    p = get_problem(problem)
    if cfg.use_pallas:
        from ..problems.suite import fused_tail_for, fused_value_and_grad

        vg = fused_value_and_grad(problem)
        fused_tail = fused_tail_for(problem, with_matvec=with_matvec,
                                    accurate_dots=cfg.accurate_dots)
    else:
        vg = make_value_and_grad(p.f, p.grad)
        fused_tail = None
    dir_poly = p.dir_poly if cfg.ls_eval == "polynomial" else None

    @jax.jit
    def run(x0):
        state = init_state(vg, x0, cfg.m, cfg.history_dtype)
        return solve_from_state(cfg, p.f, vg, state, dir_poly, fused_tail)

    per_seed = []
    all_walls = []
    compile_s = None
    out = None
    for seed in seeds:
        x0 = _x0(d, seed, dtype)
        t0 = time.perf_counter()
        out = jax.block_until_ready(run(x0))    # warmup / compile
        if compile_s is None:
            compile_s = time.perf_counter() - t0
        walls = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            out = jax.block_until_ready(run(x0))
            walls.append(time.perf_counter() - t0)
        all_walls.extend(walls)
        per_seed.append(min(walls))
    wall = float(np.mean(per_seed))
    return BenchResult(
        name=f"device/{problem}/d={d}/{cfg.line_search}/{cfg.direction}/"
             f"{jnp.dtype(dtype).name}",
        iters_per_s=iters / wall, wall_s=wall, iterations=iters,
        final_f=float(out.f), final_g_norm=float(out.g_norm),
        details={"per_seed_s": per_seed, "repeat_walls_s": all_walls,
                 "compile_s": compile_s, "n_fev": int(out.n_fev),
                 "n_gev": int(out.n_gev), "device": device})


def bench_cpu_native(problem: str = "rosenbrock", d: int = 1_000_000,
                     iters: int = 20, cfg: Optional[LBFGSConfig] = None,
                     seeds=REFERENCE_SEEDS[:1], repeats: int = 3) -> BenchResult:
    """Fixed-iteration throughput of the C++ oracle (the CPU baseline).

    Best-of-repeats per seed: the shared host CPU shows >2x noisy-neighbor
    variance across single runs, and the baseline should reflect the
    machine's actual capability (best-of is also the conservative choice
    for the vs_baseline ratio)."""
    from ..native import native_lbfgs

    cfg = cfg or LBFGSConfig(line_search="backtracking")
    cfg = cfg.replace(max_iters=iters, tol=0.0)
    per_seed = []
    r = None
    for seed in seeds:
        x0 = np.asarray(_x0(d, seed, jnp.float64))
        best = np.inf
        for _ in range(repeats):
            t0 = time.perf_counter()
            r = native_lbfgs(problem, x0, cfg)
            best = min(best, time.perf_counter() - t0)
        per_seed.append(best)
    wall = float(np.mean(per_seed))
    return BenchResult(
        name=f"cpu-native/{problem}/d={d}/{cfg.line_search}",
        iters_per_s=iters / wall, wall_s=wall, iterations=iters,
        final_f=r["f"], final_g_norm=r["g_norm"],
        details={"per_seed_s": per_seed, "n_fev": r["n_fev"],
                 "n_gev": r["n_gev"]})


def bench_batch(problem: str = "rosenbrock", batch: int = 4096,
                d: int = 1024, iters: int = 200,
                cfg: Optional[LBFGSConfig] = None, dtype=jnp.float32,
                seed: int = 42, repeats: int = 3) -> BenchResult:
    """BASELINE.json config 4: thousands of independent instances vmapped in
    lockstep on one device (the reference has no batch story at all —
    SURVEY.md §2 parallelism inventory).  Reports INSTANCE-iterations/s = batch * iters
    / wall.  d defaults to 1024 (the 1e3-class size, lane-aligned so the
    per-instance history keeps the tiled (m, R, 128) layout)."""
    # fidelity="fixed" (textbook: broke searches fail instead of stepping
    # untested) + GPU-reference pair skip: keeps every f32 lane finite —
    # see tests/test_robustness.py for the failure chain this avoids.
    device = require_gpu()
    cfg = cfg or LBFGSConfig(line_search="backtracking",
                             direction="compact_incremental",
                             ls_eval="polynomial", fidelity="fixed",
                             pair_skip_threshold=1e-10)
    cfg = cfg.replace(max_iters=iters, tol=0.0)
    if cfg.history_dtype == "auto":
        # Batch-aware residency rule (vmap_minimize does the same): the
        # TOTAL ring footprint decides, not the per-instance slice.
        from ..core.solver import resolve_history_dtype

        cfg = cfg.replace(history_dtype=resolve_history_dtype(
            "auto", cfg.m, d, dtype, batch=batch))
    p = get_problem(problem)
    vg = make_value_and_grad(p.f, p.grad)
    dir_poly = p.dir_poly if cfg.ls_eval == "polynomial" else None

    rng = np.random.default_rng(seed)
    x0s = jnp.asarray(rng.uniform(-2.0, 2.0, (batch, d)), dtype)

    # Bounded lockstep (solve_bounded): every lane runs the fixed budget
    # cond-free (no per-iteration lane masking; failed lanes are identical
    # by idempotence).
    @jax.jit
    def run(x0s):
        def solve_one(x0):
            st = init_state(vg, x0, cfg.m, cfg.history_dtype)
            return solve_bounded(cfg, p.f, vg, st, dir_poly)
        return jax.vmap(solve_one)(x0s)

    t0 = time.perf_counter()
    out = jax.block_until_ready(run(x0s))
    compile_s = time.perf_counter() - t0
    best = np.inf
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = jax.block_until_ready(run(x0s))
        best = min(best, time.perf_counter() - t0)
    return BenchResult(
        name=f"device-batch/{problem}/B={batch}/d={d}/{cfg.line_search}",
        iters_per_s=batch * iters / best, wall_s=best, iterations=iters,
        final_f=float(jnp.mean(out.f)),
        final_g_norm=float(jnp.max(out.g_norm)),
        details={"batch": batch, "per_instance_iters_per_s": iters / best,
                 "compile_s": compile_s, "device": device})


def time_to_tolerance(problem: str = "rosenbrock", d: int = 1_000_000,
                      tol: float = 1e-5, max_iters: int = 20000,
                      cfg: Optional[LBFGSConfig] = None,
                      dtype=jnp.float32, seed: int = 42) -> dict:
    """Wall time to ||g|| <= tol (BASELINE.json north-star companion metric)."""
    device = require_gpu()
    cfg = cfg or LBFGSConfig(line_search="backtracking", direction="compact")
    cfg = cfg.replace(max_iters=max_iters, tol=tol)
    p = get_problem(problem)
    vg = make_value_and_grad(p.f, p.grad)
    dir_poly = p.dir_poly if cfg.ls_eval == "polynomial" else None

    @jax.jit
    def run(x0):
        state = init_state(vg, x0, cfg.m, cfg.history_dtype)
        return solve_from_state(cfg, p.f, vg, state, dir_poly)

    x0 = _x0(d, seed, dtype)
    jax.block_until_ready(run(x0))
    t0 = time.perf_counter()
    out = jax.block_until_ready(run(x0))
    wall = time.perf_counter() - t0
    return {"wall_s": wall, "iterations": int(out.k),
            "status": int(out.status), "g_norm": float(out.g_norm),
            "f": float(out.f), "device": device}


def time_to_tolerance_refined(problem: str = "rosenbrock", d: int = 1 << 20,
                              coarse_tol: float = 1e-3, tol: float = 1e-5,
                              max_iters: int = 150_000,
                              refine_iters: int = 5_000,
                              cfg: Optional[LBFGSConfig] = None,
                              seed: int = 42,
                              refine_backend: str = "native") -> dict:
    """Time to ||g|| <= tol via two-stage precision refinement — the
    BASELINE.json north-star metric (tol=1e-5 at d~1e6), which is below the
    float32 GRADIENT-ENTRY noise floor at this d (each f32 gradient entry
    carries ~eps*scale ~ 1e-7 of rounding near the minimum; 1e6 entries put
    the norm floor around 1e-3 regardless of how the reduction is summed, so
    cfg.accurate_dots alone cannot reach 1e-5).

    Stage 1 solves in f32 on the device at full speed to coarse_tol;
    stage 2 warm-starts a fresh-history f64 solve from the f32 iterate —
    superlinear local convergence needs only a handful of iterations
    (measured: 9 at d=4096).

    refine_backend="native": stage 2 runs the C++ f64 oracle on the host.
    refine_backend="jax": stage 2 as an f64 jit on the same device (f64 is
    native on the GPU; ROADMAP S7 queues the choice of default).
    """
    device = require_gpu()
    cfg = cfg or LBFGSConfig(line_search="backtracking",
                             direction="compact_incremental",
                             ls_eval="polynomial", fidelity="fixed",
                             pair_skip_threshold=1e-10)
    p = get_problem(problem)
    vg = make_value_and_grad(p.f, p.grad)
    dir_poly = p.dir_poly if cfg.ls_eval == "polynomial" else None
    cfg32 = cfg.replace(max_iters=max_iters, tol=coarse_tol)
    cfg64 = cfg.replace(max_iters=refine_iters, tol=tol)

    @jax.jit
    def coarse(x0):
        st = init_state(vg, x0, cfg32.m, cfg32.history_dtype)
        return solve_from_state(cfg32, p.f, vg, st, dir_poly)

    if refine_backend == "native":
        from ..native import native_lbfgs

        # fidelity="fixed" has no meaning for the oracle's backtracking
        # beyond the broke-search rule; the refine never hits it.
        def refine_run(x32):
            x64 = np.asarray(jax.device_get(x32), np.float64)
            return native_lbfgs(problem, x64, cfg64)

        def refine_stats(r):
            return (int(r["iterations"]), r["status"], float(r["g_norm"]),
                    float(r["f"]))
    else:
        prev_x64 = jax.config.jax_enable_x64
        jax.config.update("jax_enable_x64", True)

        @jax.jit
        def refine(x32):
            st = init_state(vg, x32.astype(jnp.float64), cfg64.m, None)
            return solve_from_state(cfg64, p.f, vg, st, dir_poly)

        def refine_run(x32):
            return jax.block_until_ready(refine(x32))

        def refine_stats(out):
            from ..types import Status

            return (int(out.k), Status.NAMES[int(out.status)],
                    float(out.g_norm), float(out.f))

    try:
        x0 = _x0(d, seed, jnp.float32)
        out1 = jax.block_until_ready(coarse(x0))    # warmup/compile stage 1
        r2 = refine_run(out1.x)             # warmup stage 2
        t0 = time.perf_counter()
        out1 = jax.block_until_ready(coarse(x0))
        t1 = time.perf_counter()
        r2 = refine_run(out1.x)
        t2 = time.perf_counter()
        k2, status, g_norm, f = refine_stats(r2)
    finally:
        # Restore the process-global x64 flag: leaving it on contaminates
        # every later default-dtype array in the caller's process (f64 in
        # runs labeled f32).
        if refine_backend != "native":
            jax.config.update("jax_enable_x64", prev_x64)
    return {"wall_s": t2 - t0, "coarse_wall_s": t1 - t0,
            "refine_wall_s": t2 - t1, "refine_backend": refine_backend,
            "coarse_iterations": int(out1.k),
            "refine_iterations": k2,
            "status": status, "g_norm": g_norm, "f": f, "device": device}
