#!/usr/bin/env python
"""Proof that the solver's main path runs on the GPU, in one process.

    python chip_smoke.py            # one card: every phase below
    python chip_smoke.py --four     # four cards: the sharded paths only

Phases (one card):
  1. Kernel checks: each Triton kernel compiled for the card at real widths
     (fused tail at d = 2^20 and 2^20 + 77; chain at B = 4096 and 1000),
     compared with its plain-XLA twin under a stated tolerance, its
     compiled memory analysis, kernel vs XLA time; then the tests marked
     ``gpu``.
  2. Single-instance solves: Rosenbrock d = 2^20, 1000 fixed iterations, on
     the fused-tail stack vs the plain-XLA stack; then d = 2^26 for 100.
  3. Batch solve: 4096 x d = 1024 lockstep, Triton chain vs vmapped jnp.
  4. Parity: f64 solves at d = 2^14 for 50 iterations, each of the five
     reference line searches, alpha and f trajectories vs the NumPy oracle.
  5. CLI smoke: ``tpu_lbfgs.cli.main`` in-process on the fused-tail stack.

``--four`` runs sharded_minimize on a 1-D mesh of 4 GPUs at d = 2^26 (f32,
the fused tail, 100 iterations) against the same solve on one card with a
per-step bound on f (each step from the same state), and
sharded_vmap_minimize on a 2 x 2 (b, d) mesh against per-instance one-card
solves (f64, per-step bound).

Any failure exits non-zero.  The last line of standard output is one JSON
object: {"ok": true, "device": {"platform", "kind", "count"}}.  Without a GPU,
or without the rest of the repository beside it, the script exits non-zero
and prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# Stated tolerances (each with its reason).
# Kernel vs XLA twin on identical inputs: the same f32 arithmetic summed in
# another order.  Vectors: relative to the largest |entry| (elementwise FMA
# contraction may differ); scalars and matvecs: block-partial sums vs XLA's
# reduction tree over ~1e6 terms.
TOL_VEC = 1e-5
TOL_SUM = 1e-4
# One step of the kernel stack vs one step of the plain-XLA stack from the
# SAME state: the step's own rounding difference, on the steps whose line
# search accepts the same alpha (a knife-edge decision may flip under
# another summation order; at least MIN_SAME_ALPHA of them must agree).
TOL_STEP = 1e-5
MIN_SAME_ALPHA = 0.9
# Whole f32 solves through differently-rounded programs: Rosenbrock from a
# random start amplifies the per-step differences along the trajectory
# (measured up to ~1e-2 after 100 iterations at d=2^26), so this bound only
# catches a broken stack; TOL_STEP is the tight check.
TOL_SOLVE_F = 2e-2
# Batch: the mean final f over 4096 lanes.
TOL_BATCH_MEAN = 1e-3
# f64 parity with the NumPy oracle: identical decision rules, reduction
# order differs only in the last bits.
TOL_PARITY = 1e-6
# Four cards vs one, one step from the same state (as TOL_STEP): the psum
# of 4 shard partials vs one device's reduction.  2 x 2 mesh: f64 over 20
# traced iterations.
TOL_SHARD_STEP = 1e-5
TOL_SHARD_STEP_F64 = 1e-9


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check_tail(d: int, with_matvec: bool, rec: dict) -> None:
    from tpu_lbfgs.bench.kernel_ab import tail_ab

    r = tail_ab(d, with_matvec)
    k = next(iter(r["kernels"].values()))
    key = f"tail d={d} matvec={with_matvec}"
    log(f"[1] {key}: max rel err vectors {k['vec_err']:.2e} (tol "
        f"{TOL_VEC:g}), sums {k['sum_err']:.2e} (tol {TOL_SUM:g}); kernel "
        f"{k['us']:.1f} us vs XLA {r['xla_us']:.1f} us")
    log(f"    memory_analysis: {k['memory']}")
    rec[key] = r
    if not (k["vec_err"] <= TOL_VEC and k["sum_err"] <= TOL_SUM):
        fail(f"{key} disagrees with its XLA twin")


def check_chain(B: int, rec: dict) -> None:
    from tpu_lbfgs.bench.kernel_ab import chain_ab

    r = chain_ab(B)
    k = next(iter(r["kernels"].values()))
    key = f"chain B={B}"
    log(f"[1] {key}: max rel err {k['err']:.2e} (tol {TOL_SUM:g}), "
        f"fallback flags equal {k['fallback_equal']}; kernel "
        f"{k['us']:.1f} us vs XLA {r['xla_us']:.1f} us")
    log(f"    memory_analysis: {k['memory']}")
    rec[key] = r
    if not (k["err"] <= TOL_SUM and k["fallback_equal"]):
        fail(f"{key} disagrees with the vmapped jnp chain")


def run_gpu_tests() -> None:
    """The tests marked ``gpu``, in this process (tests/conftest.py leaves
    an already-initialized GPU backend in place)."""
    import jax
    import pytest

    x64 = jax.config.jax_enable_x64
    try:
        rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                          os.path.join(ROOT, "tests")])
    finally:
        jax.config.update("jax_enable_x64", x64)
    if rc != 0:
        fail(f"gpu-marked tests failed (pytest exit {rc})")
    log("[1] gpu-marked tests passed")


# --- phases 2 and 3 ----------------------------------------------------------

def stepwise(step_a, step_b, state, steps: int, put=lambda s: s):
    """Run ``steps`` steps along step_b's trajectory; at each, also take one
    step_a step from the SAME state.  Returns (share of steps/lanes with the
    same accepted alpha, max rel diff in f over those)."""
    import numpy as np

    same, total, worst = 0, 0, 0.0
    for _ in range(steps):
        nb = step_b(state)
        na = step_a(put(state))
        fa, fb = np.asarray(na.f, np.float64), np.asarray(nb.f, np.float64)
        eq = np.asarray(na.alpha) == np.asarray(nb.alpha)
        same += int(eq.sum())
        total += eq.size
        if eq.any():
            worst = max(worst, float(np.max(np.abs(fa - fb)[eq]
                                            / np.abs(fb)[eq])))
        state = nb
    return same / total, worst


def solve_pair(d: int, iters: int, steps: int, rec: dict) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    import tpu_lbfgs as tl
    from tpu_lbfgs.bench.kernel_ab import best_wall

    p = tl.get_problem("rosenbrock")
    cfg = tl.LBFGSConfig(line_search="backtracking",
                         direction="compact_incremental", m=10,
                         ls_eval="polynomial", max_iters=iters, tol=0.0,
                         use_pallas=True)
    x0 = jnp.asarray(np.random.default_rng(42).uniform(-2, 2, d),
                     jnp.float32)
    vg = tl.fused_value_and_grad("rosenbrock")
    tail = tl.fused_tail_for("rosenbrock")
    plain_cfg = cfg.replace(use_pallas=False)

    # One step of each stack from identical states.
    seg = dict(iters=1, dir_poly=p.dir_poly, donate=False)
    step_k = tl.make_solve_segment(cfg, p.f, value_and_grad=vg,
                                   fused_tail=tail, **seg)
    step_x = tl.make_solve_segment(plain_cfg, p.f, grad=p.grad, **seg)
    share, step_err = stepwise(step_k, step_x,
                               tl.init_state(vg, x0, cfg.m), steps)
    log(f"[2] d={d}: {steps} steps from identical states, same alpha in "
        f"{share:.3f}, max rel diff in f {step_err:.2e} (tol {TOL_STEP:g})")
    rec[f"steps d={d}"] = {"same_alpha": share, "max_rel": step_err}
    if share < MIN_SAME_ALPHA or step_err > TOL_STEP:
        fail(f"d={d}: a fused-tail step disagrees with the plain-XLA step")

    runs = {
        "fused-tail": lambda: tl.minimize(p.f, x0, cfg, value_and_grad=vg,
                                          dir_poly=p.dir_poly,
                                          fused_tail=tail),
        "plain-xla": lambda: tl.minimize(p.f, x0, plain_cfg, grad=p.grad,
                                         dir_poly=p.dir_poly),
    }
    out = {}
    for name, run in runs.items():
        t0 = time.perf_counter()
        r = jax.block_until_ready(run())
        first = time.perf_counter() - t0
        wall = best_wall(run, reps=2)
        out[name] = float(r.f)
        if int(r.iterations) != iters or not np.isfinite(float(r.f)):
            fail(f"d={d} {name}: {int(r.iterations)} iterations, "
                 f"f={float(r.f)}")
        log(f"[2] d={d} {name}: f={float(r.f):.8g} after {iters} it, "
            f"{iters / wall:.1f} it/s (first call {first:.1f} s)")
        rec[f"solve d={d} {name}"] = {"f": float(r.f),
                                      "iters_per_s": iters / wall}
    rel = abs(out["fused-tail"] - out["plain-xla"]) / abs(out["plain-xla"])
    log(f"[2] d={d}: whole solve, fused-tail vs plain-xla rel diff in f "
        f"{rel:.2e} (tol {TOL_SOLVE_F:g})")
    if rel > TOL_SOLVE_F:
        fail(f"d={d} solve disagrees with the plain-XLA stack")


def batch_pair(rec: dict, B: int = 4096, d: int = 1024, iters: int = 200,
               steps: int = 20) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    import tpu_lbfgs.kernels.chain as chain_mod
    from tpu_lbfgs import LBFGSConfig, get_problem, init_state, iterate
    from tpu_lbfgs.batch import vmap_minimize, vmapped
    from tpu_lbfgs.bench.kernel_ab import best_wall

    p = get_problem("rosenbrock")
    cfg = LBFGSConfig(line_search="backtracking",
                      direction="compact_incremental", ls_eval="polynomial",
                      fidelity="fixed", pair_skip_threshold=1e-10,
                      max_iters=iters, tol=0.0)
    x0s = jnp.asarray(np.random.default_rng(42).uniform(-2, 2, (B, d)),
                      jnp.float32)
    vg = p.value_and_grad
    real = chain_mod.chain_triton

    def plain_chain(*a, m, skip_thr, interpret):
        return jax.vmap(lambda *b: chain_mod.chain_jnp(
            *b, m=m, skip_thr=skip_thr))(*a)

    def build(kernel: bool):
        """(batched one-step fn, batched solve fn) on the Triton chain or,
        for the comparison stack, the vmapped jnp chain."""
        chain_mod.make_compact_chain.cache_clear()
        vmapped._compiled_vmap_run.cache_clear()
        chain_mod.chain_triton = real if kernel else plain_chain
        try:
            step = jax.jit(jax.vmap(
                lambda s: iterate(cfg, p.f, vg, s, p.dir_poly)))
            state0 = jax.jit(jax.vmap(
                lambda x: init_state(vg, x, cfg.m)))(x0s)
            jax.block_until_ready(step(state0))        # trace + compile now

            def solve():
                return vmap_minimize(p.f, x0s, cfg, grad=p.grad,
                                     dir_poly=p.dir_poly, lockstep="bounded")

            t0 = time.perf_counter()
            r = jax.block_until_ready(solve())
            first = time.perf_counter() - t0
            wall = best_wall(solve, reps=2)
        finally:
            chain_mod.chain_triton = real
        return step, state0, r, first, wall

    step_k, state0, r_k, first_k, wall_k = build(True)
    step_x, _, r_x, first_x, wall_x = build(False)
    chain_mod.make_compact_chain.cache_clear()
    share, step_err = stepwise(step_k, step_x, state0, steps)
    log(f"[3] batch {B}x{d}: {steps} steps from identical states, same "
        f"alpha in {share:.4f} of lane-steps, max rel diff in f "
        f"{step_err:.2e} (tol {TOL_STEP:g})")
    for name, r, first, wall in (("triton-chain", r_k, first_k, wall_k),
                                 ("vmapped-jnp", r_x, first_x, wall_x)):
        log(f"[3] batch {B}x{d} {name}: mean f "
            f"{float(jnp.mean(r.f)):.8g}, {B * iters / wall:,.0f} "
            f"instance-it/s (first call {first:.1f} s)")
        rec[f"batch {name}"] = {"mean_f": float(jnp.mean(r.f)),
                                "instance_iters_per_s": B * iters / wall}
    a = np.asarray(r_k.f, np.float64)
    b = np.asarray(r_x.f, np.float64)
    mean_rel = abs(a.mean() - b.mean()) / abs(b.mean())
    log(f"[3] batch: mean final f rel diff {mean_rel:.2e} (tol "
        f"{TOL_BATCH_MEAN:g})")
    rec["batch steps"] = {"same_alpha": share, "max_rel": step_err,
                          "mean_rel": mean_rel}
    if not (np.all(np.isfinite(a)) and share >= MIN_SAME_ALPHA
            and step_err <= TOL_STEP and mean_rel <= TOL_BATCH_MEAN):
        fail("batch solve disagrees with the vmapped jnp chain")


# --- phase 4 -----------------------------------------------------------------

def _rosen_np(x):
    import numpy as np

    return float(np.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2
                        + (1.0 - x[:-1]) ** 2))


def _rosen_grad_np(x):
    import numpy as np

    g = np.zeros_like(x)
    t = x[1:] - x[:-1] ** 2
    g[:-1] += 2.0 * (x[:-1] - 1.0) - 400.0 * x[:-1] * t
    g[1:] += 200.0 * t
    return g


def parity(rec: dict) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    import tpu_lbfgs as tl
    from tpu_lbfgs.oracle import lbfgs_oracle

    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        p = tl.get_problem("rosenbrock")
        x0 = np.random.default_rng(7).uniform(-1.5, 1.5, 1 << 14)
        for ls in ("backtracking", "backtracking_wolfe",
                   "backtracking_wolfe_bisect", "armijo_interpolation",
                   "wolfe_interpolation"):
            cfg = tl.LBFGSConfig(line_search=ls, max_iters=50, tol=1e-12,
                                 c2=0.9, record_trace=True)
            r = tl.minimize(p.f, jnp.asarray(x0, jnp.float64), cfg,
                            grad=p.grad)
            o = lbfgs_oracle(_rosen_np, _rosen_grad_np, x0.copy(), cfg)
            n = min(int(r.iterations), o.iterations, 50)
            tf = np.asarray(r.trace.f[: n - 1])
            ta = np.asarray(r.trace.alpha[: n - 1])
            of = np.asarray(o.fs[1:n])
            oa = np.asarray(o.alphas[: n - 1])
            ef = float(np.max(np.abs(tf - of) / np.abs(of)))
            ea = float(np.max(np.abs(ta - oa) / np.abs(oa)))
            log(f"[4] f64 parity {ls}: {n} iterations compared, max rel "
                f"err f {ef:.2e}, alpha {ea:.2e} (tol {TOL_PARITY:g})")
            rec[f"parity {ls}"] = {"iters": n, "f_err": ef, "alpha_err": ea}
            if n < 10 or ef > TOL_PARITY or ea > TOL_PARITY:
                fail(f"f64 parity with the oracle, {ls}")
    finally:
        jax.config.update("jax_enable_x64", prev)


# --- phase 5 -----------------------------------------------------------------

def cli_smoke() -> None:
    from tpu_lbfgs import cli

    rc = cli.main(["--pallas", "--poly-ls", "--direction",
                   "compact_incremental", "--dim", str(1 << 20),
                   "--max-iters", "200", "--tol", "0"])
    if rc != 0:
        fail(f"cli.main returned {rc}")
    log("[5] cli.main --pallas --poly-ls --direction compact_incremental "
        "--dim 1048576: ok")


# --- four cards ----------------------------------------------------------------

def four_cards(rec: dict, d: int = 1 << 26, iters: int = 100, B: int = 4,
               d2: int = 1 << 20) -> None:
    """sharded_minimize on 4 cards vs one card, step by step: every step
    starts both from the SAME state (the one-card trajectory), so the
    per-step difference in f is the sharded step's own error, not rounding
    amplified along a trajectory.  Then the whole sharded solve, and the
    2 x 2 (b, d) mesh."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import tpu_lbfgs as tl
    from tpu_lbfgs.dist import make_mesh, make_mesh_2d, sharded_minimize
    from tpu_lbfgs.dist import sharded_vmap_minimize
    from tpu_lbfgs.dist.mesh import state_shardings
    from tpu_lbfgs.dist.pallas_sharded import (
        shardmap_fused_tail,
        shardmap_fused_vg,
    )

    if len(jax.devices()) != 4:
        fail(f"--four needs 4 devices, found {len(jax.devices())}")
    p = tl.get_problem("rosenbrock")
    one = jax.devices()[0]
    mesh = make_mesh()
    cfg = tl.LBFGSConfig(line_search="backtracking",
                         direction="compact_incremental", m=10,
                         ls_eval="polynomial", max_iters=iters, tol=0.0,
                         use_pallas=True)
    rng = np.random.default_rng(42)
    x0 = jnp.asarray(rng.uniform(-2, 2, d), jnp.float32)

    # Step by step from the one-card states (d is a multiple of 128 * 4,
    # so the sharded layout needs no padding).
    vg1 = tl.fused_value_and_grad("rosenbrock")
    step1 = tl.make_solve_segment(cfg, p.f, value_and_grad=vg1, iters=1,
                                  dir_poly=p.dir_poly,
                                  fused_tail=tl.fused_tail_for("rosenbrock"),
                                  donate=False)
    step4 = tl.make_solve_segment(
        cfg, p.f, value_and_grad=shardmap_fused_vg("rosenbrock", mesh, d),
        iters=1, dir_poly=p.dir_poly,
        fused_tail=shardmap_fused_tail("rosenbrock", mesh, d), donate=False)
    st_sh = state_shardings(mesh)
    s1 = tl.init_state(vg1, jax.device_put(x0, one), cfg.m)
    share, step = stepwise(step4, step1, s1, iters,
                           put=lambda s: jax.device_put(s, st_sh))
    log(f"[4x] sharded step vs one-card step, f32 fused tail, d={d}, "
        f"{iters} steps from identical states: same alpha in {share:.3f}, "
        f"max rel diff in f there {step:.2e} (tol {TOL_SHARD_STEP:g})")
    rec["sharded steps"] = {"same_alpha": share, "max_step_rel": step}
    if share < MIN_SAME_ALPHA or step > TOL_SHARD_STEP:
        fail("4-card sharded step disagrees with the one-card step")

    # The public sharded solve runs its iterations ...
    r4 = jax.block_until_ready(sharded_minimize(
        p.f, x0, cfg, mesh=mesh, grad=p.grad, dir_poly=p.dir_poly,
        problem="rosenbrock"))
    if int(r4.iterations) != iters or not np.isfinite(float(r4.f)):
        fail("4-card sharded solve did not run its iterations")
    # ... and the steady-state wall of the same 100 iterations, compiled
    # once, on 4 cards and on one.
    from tpu_lbfgs.bench.kernel_ab import best_wall

    seg = dict(iters=iters, dir_poly=p.dir_poly, donate=False)
    run1 = tl.make_solve_segment(cfg, p.f, value_and_grad=vg1,
                                 fused_tail=tl.fused_tail_for("rosenbrock"),
                                 **seg)
    run4 = tl.make_solve_segment(
        cfg, p.f, value_and_grad=shardmap_fused_vg("rosenbrock", mesh, d),
        fused_tail=shardmap_fused_tail("rosenbrock", mesh, d), **seg)
    s0 = tl.init_state(vg1, jax.device_put(x0, one), cfg.m)
    w1 = best_wall(run1, s0, reps=3)
    w4 = best_wall(run4, jax.device_put(s0, st_sh), reps=3)
    log(f"[4x] sharded_minimize d={d}: {iters} it, f={float(r4.f):.8g}; "
        f"steady state {iters / w4:.1f} it/s on 4 cards vs "
        f"{iters / w1:.1f} it/s on one")
    rec["sharded solve"] = {"f": float(r4.f), "iters_per_s_4": iters / w4,
                            "iters_per_s_1": iters / w1}

    # 2 x 2 (b, d) mesh, f64 (native on the card), traced: the first
    # iterations of a trajectory, before rounding differences amplify.
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        it2 = 20
        cfg64 = cfg.replace(use_pallas=False, max_iters=it2,
                            record_trace=True)
        x0s = jnp.asarray(rng.uniform(-2, 2, (B, d2)), jnp.float64)
        r22 = sharded_vmap_minimize(p.f, x0s, cfg64,
                                    mesh=make_mesh_2d(batch_size=2),
                                    grad=p.grad, dir_poly=p.dir_poly)
        worst = 0.0
        for i in range(B):
            ri = tl.minimize(p.f, jax.device_put(x0s[i], one), cfg64,
                             grad=p.grad, dir_poly=p.dir_poly)
            fa = np.asarray(r22.trace.f[i])
            fb = np.asarray(ri.trace.f)
            worst = max(worst, float(np.max(np.abs(fa - fb) / np.abs(fb))))
    finally:
        jax.config.update("jax_enable_x64", prev)
    log(f"[4x] sharded_vmap_minimize 2x2 mesh, {B} x d={d2}, f64, {it2} "
        f"it: max per-step rel diff in f vs one card {worst:.2e} (tol "
        f"{TOL_SHARD_STEP_F64:g})")
    rec["sharded_vmap 2x2"] = {"max_step_rel": worst}
    if worst > TOL_SHARD_STEP_F64:
        fail("2x2 sharded batch disagrees with one-card solves")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-card sharded paths")
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    try:
        import tpu_lbfgs  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the tpu_lbfgs package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 2
    from tpu_lbfgs.bench.harness import card_name_and_power

    try:
        card = card_name_and_power()
    except (OSError, subprocess.SubprocessError) as e:
        print(f"chip_smoke: nvidia-smi failed ({e})", file=sys.stderr)
        return 3

    import jax

    from tpu_lbfgs.utils.cache import enable_compile_cache

    cache_dir = enable_compile_cache()
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU; JAX found {devs[0].platform}",
              file=sys.stderr)
        return 3
    log(card)
    log(f"jax {jax.__version__}; device_kind {devs[0].device_kind} x "
        f"{len(devs)}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}; "
        f"compile cache {cache_dir}")

    rec = {"card": card}
    t0 = time.perf_counter()
    if args.four:
        four_cards(rec)
    else:
        check_tail(1 << 20, False, rec)
        check_tail(1 << 20, True, rec)
        check_tail((1 << 20) + 77, False, rec)
        check_chain(4096, rec)
        check_chain(1000, rec)
        run_gpu_tests()
        solve_pair(1 << 20, 1000, 100, rec)
        solve_pair(1 << 26, 100, 20, rec)
        batch_pair(rec)
        parity(rec)
        cli_smoke()
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke_four.json" if args.four
                           else "chip_smoke.json"), "w") as fh:
        json.dump(rec, fh, indent=1)
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s; "
        f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
