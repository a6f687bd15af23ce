"""Command-line driver: problem, dimension, strategy, dtype, mesh — no
recompile-to-reconfigure.

The reference configures by editing constexpr headers and recompiling, and
selects the GPU line-search variant by which .cu file you hand to nvcc
(SURVEY.md §5 config row; parallel-implementation/run.sh:2).  This CLI is the
replacement: every reference knob is a flag.

Examples:
  python -m tpu_lbfgs --problem rosenbrock --dim 100000 --line-search wolfe_interpolation
  python -m tpu_lbfgs --problem rosenbrock --dim 1048576 --dtype float32 --direction compact --pallas
  python -m tpu_lbfgs --batch 4096 --dim 1000 --max-iters 500
  python -m tpu_lbfgs --dim 1000000 --shard --tol 1e-4
  python -m tpu_lbfgs --backend native --dim 10000        # C++ CPU oracle
  python -m tpu_lbfgs --seeds 42 365 12345 777777 10000   # reference protocol
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="tpu_lbfgs",
        description="L-BFGS solver, whole solve on the accelerator "
                    "(reference: ndzajic1/cuda-lbfgs)")
    ap.add_argument("--problem", default="rosenbrock",
                    help="rosenbrock | quadratic | coupled_quadratic | sphere")
    ap.add_argument("--dim", type=int, default=100_000)
    from .config import LINE_SEARCH_METHODS
    ap.add_argument("--line-search", default="backtracking",
                    choices=list(LINE_SEARCH_METHODS))
    ap.add_argument("--direction", default="compact",
                    choices=["two_loop", "compact", "compact_incremental"])
    ap.add_argument("--fidelity", default="reference",
                    choices=["reference", "fixed"])
    ap.add_argument("-m", "--history", type=int, default=10)
    ap.add_argument("--max-iters", type=int, default=1000)
    ap.add_argument("--tol", type=float, default=1e-5)
    ap.add_argument("--c1", type=float, default=1e-4)
    ap.add_argument("--c2", type=float, default=0.9)
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "float64"])
    ap.add_argument("--damping", type=float, default=None,
                    help="Powell damping threshold (e.g. 0.2): blend "
                         "low-curvature pairs instead of rejecting them "
                         "(extension; composes with every stack incl. "
                         "--pallas and --shard)")
    ap.add_argument("--auto-speculative", action="store_true",
                    help="for the Wolfe searches: run a short probe solve, "
                         "then switch to the speculative (fused K-trial) "
                         "twin exactly when the observed line-search "
                         "trials/iteration crosses the measured boundary "
                         "(linesearch.resolve_speculative_auto)")
    ap.add_argument("--history-dtype", default=None,
                    choices=[None, "bfloat16", "float32", "auto"],
                    help="down-cast (m,d) history storage (halves direction "
                         "memory traffic; slightly approximate H); 'auto' "
                         "resolves through core.solver.resolve_history_dtype")
    ap.add_argument("--pallas", action="store_true",
                    help="run the fused iteration tail (a Triton kernel on "
                         "the GPU; f32 suite problems)")
    ap.add_argument("--poly-ls", action="store_true",
                    help="polynomial directional line search: phi(alpha) in "
                         "closed form, O(1) scalar trials, no in-search "
                         "gradient evals")
    ap.add_argument("--seeds", type=int, nargs="+", default=[42],
                    help="x0 seeds; reference protocol: 42 365 12345 777777 10000")
    ap.add_argument("--x0-range", type=float, default=2.0,
                    help="x0 ~ U(-r, r); the reference driver uses 1000")
    ap.add_argument("--batch", type=int, default=0,
                    help="solve N independent instances vmapped (0 = single)")
    ap.add_argument("--lockstep", default="while",
                    choices=["while", "bounded"],
                    help="batch loop mode: 'while' freezes lanes as they "
                         "finish; 'bounded' runs the full --max-iters budget "
                         "cond-free (early-converging lanes keep polishing)")
    ap.add_argument("--shard", action="store_true",
                    help="shard the vector over all devices (mesh on d axis)")
    ap.add_argument("--backend", default="jax", choices=["jax", "native"],
                    help="native = the C++ CPU oracle")
    ap.add_argument("--trace", action="store_true",
                    help="record per-iteration metrics (bounded scan)")
    ap.add_argument("--verbose", action="store_true",
                    help="print the reference-style per-iteration log "
                         "(Iteration k, f, |grad|) from the recorded trace — "
                         "read out once post-solve, never syncing the device "
                         "loop (unlike lbfgs.cpp:76-78)")
    ap.add_argument("--json", action="store_true", help="machine-readable output")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="record a jax.profiler trace of the (post-warmup) "
                         "solve into DIR (TensorBoard/Perfetto)")
    ap.add_argument("--device", default="default", choices=["default", "cpu"],
                    help="cpu forces the host backend")
    ap.add_argument("--debug-nans", action="store_true",
                    help="sanitizer mode: abort with a traceback the moment "
                         "any op produces a NaN (jax_debug_nans) — the XLA "
                         "analogue of running the reference under "
                         "compute-sanitizer (SURVEY.md §5: the reference has "
                         "no sanitizer story).  Disables the jitted "
                         "while_loop fast path; expect ~10x slowdown.")
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.backend == "native":
        # Validate against what the C++ oracle supports BEFORE running —
        # otherwise unsupported choices surface as raw KeyErrors mid-run.
        from .native.binding import _LS_IDS, PROBLEM_IDS
        if args.problem not in PROBLEM_IDS:
            ap.error(f"--backend native supports problems "
                     f"{sorted(PROBLEM_IDS)}, not {args.problem!r}")
        if args.line_search not in _LS_IDS:
            ap.error(f"--backend native supports line searches "
                     f"{sorted(_LS_IDS)}, not {args.line_search!r}")

    import jax

    from .utils.cache import enable_compile_cache

    enable_compile_cache()
    if args.device == "cpu":
        jax.config.update("jax_platforms", "cpu")
    if args.debug_nans:
        jax.config.update("jax_debug_nans", True)
    import jax.numpy as jnp
    import numpy as np

    from . import LBFGSConfig, Status, get_problem, minimize
    from .problems.suite import fused_value_and_grad

    cfg = LBFGSConfig(
        m=args.history, max_iters=args.max_iters, tol=args.tol,
        line_search=args.line_search, direction=args.direction,
        fidelity=args.fidelity, c1=args.c1, c2=args.c2,
        use_pallas=args.pallas,
        # --verbose replays the trace, which only the single-instance jax
        # branch prints; forcing the (all-max_iters) traced scan for batch /
        # native runs would cost the full-horizon scan for no output.
        record_trace=args.trace or (args.verbose and not args.batch
                                    and args.backend == "jax"),
        ls_eval="polynomial" if args.poly_ls else "direct",
        history_dtype=args.history_dtype, damping=args.damping)
    dtype = jnp.float32 if args.dtype == "float32" else jnp.float64
    if dtype == jnp.float64:
        jax.config.update("jax_enable_x64", True)
    p = get_problem(args.problem)

    if args.auto_speculative and args.backend == "jax":
        from .linesearch.strategies import (
            SPECULATIVE_TWINS,
            resolve_speculative_auto,
        )

        if cfg.line_search in SPECULATIVE_TWINS:
            # Short sequential probe on the first seed's start; the measured
            # trials/iteration decides the twin BEFORE the main compile
            # (strategies.resolve_speculative_auto docstring).
            rng0 = np.random.default_rng(args.seeds[0])
            x0p = jnp.asarray(rng0.uniform(-args.x0_range, args.x0_range,
                                           args.dim), dtype)
            probe_cfg = cfg.replace(max_iters=min(50, cfg.max_iters),
                                    record_trace=False)
            probe = minimize(p.f, x0p, probe_cfg, grad=p.grad,
                             dir_poly=p.dir_poly if args.poly_ls else None)
            cfg = resolve_speculative_auto(cfg, probe)
            print(f"# auto-speculative probe: "
                  f"{int(probe.n_fev) / max(int(probe.iterations), 1) - 1:.1f}"
                  f" trials/iter -> line_search={cfg.line_search}",
                  file=sys.stderr)
        else:
            print(f"# auto-speculative: no speculative twin for "
                  f"{cfg.line_search!r}; ignoring", file=sys.stderr)

    # Fast-path builders hoisted out of the seed loop: _compiled_run caches
    # on callable IDENTITY, so per-seed fresh closures would force a full
    # retrace and recompile per seed.
    dir_poly = p.dir_poly if args.poly_ls else None
    vg = fused_tail = phi_batch = phi_dphi_batch = None
    if args.pallas and not args.shard and not args.batch \
            and args.backend == "jax":
        # Single-device fused tail.  The --shard path instead passes
        # problem= so sharded_minimize builds the shard-composable tail
        # itself — injecting the single-device kernel into an
        # auto-partitioned program would force XLA to gather the full
        # vector around it.
        from .core.solver import resolve_history_dtype
        from .problems.suite import fused_tail_for, multi_phi_for
        vg = fused_value_and_grad(args.problem)
        fused_tail = fused_tail_for(
            args.problem, with_matvec="auto", m=cfg.m, d=args.dim,
            history_dtype=resolve_history_dtype(
                cfg.history_dtype, cfg.m, args.dim, dtype),
            accurate_dots=cfg.accurate_dots)
        if cfg.line_search == "backtracking_speculative" \
                and cfg.ls_eval == "direct":
            phi_batch = multi_phi_for(args.problem)
        if cfg.line_search in ("wolfe_interpolation_speculative",
                               "backtracking_wolfe_speculative") \
                and cfg.ls_eval == "direct":
            from .problems.suite import multi_phi_dphi_for
            phi_dphi_batch = multi_phi_dphi_for(args.problem)

    results = []
    for seed in args.seeds:
        rng = np.random.default_rng(seed)
        t0 = time.perf_counter()

        if args.backend == "native":
            from .native import native_lbfgs
            x0 = rng.uniform(-args.x0_range, args.x0_range, args.dim)
            r = native_lbfgs(args.problem, x0, cfg)
            wall = time.perf_counter() - t0
            rec = {"seed": seed, "status": r["status"],
                   "iterations": r["iterations"], "f": r["f"],
                   "g_norm": r["g_norm"], "n_fev": r["n_fev"],
                   "n_gev": r["n_gev"], "wall_s": wall}
        elif args.batch:
            from .batch import vmap_minimize
            x0s = jnp.asarray(rng.uniform(-args.x0_range, args.x0_range,
                                          (args.batch, args.dim)), dtype)
            res = vmap_minimize(p.f, x0s, cfg, grad=p.grad,
                                dir_poly=p.dir_poly if args.poly_ls else None,
                                lockstep=args.lockstep)
            wall = time.perf_counter() - t0
            st = np.asarray(res.status)
            rec = {"seed": seed, "batch": args.batch,
                   "converged": int((st == Status.CONVERGED).sum()),
                   "mean_iterations": float(np.mean(np.asarray(res.iterations))),
                   "mean_f": float(np.mean(np.asarray(res.f))),
                   "max_g_norm": float(np.max(np.asarray(res.g_norm))),
                   "wall_s": wall}
        else:
            x0 = jnp.asarray(rng.uniform(-args.x0_range, args.x0_range,
                                         args.dim), dtype)
            if args.shard:
                from .dist import make_mesh, sharded_minimize
                res = sharded_minimize(p.f, x0, cfg, mesh=make_mesh(),
                                       grad=p.grad, dir_poly=dir_poly,
                                       problem=args.problem)
            else:
                solve = lambda: minimize(p.f, x0, cfg,
                                         grad=None if vg else p.grad,
                                         value_and_grad=vg, dir_poly=dir_poly,
                                         fused_tail=fused_tail,
                                         phi_batch=phi_batch,
                                         phi_dphi_batch=phi_dphi_batch)
                if args.profile:
                    from .utils.profiling import trace as profiler_trace
                    res = solve()          # warmup/compile outside the trace
                    t0 = time.perf_counter()
                    with profiler_trace(args.profile):
                        res = jax.block_until_ready(solve())
                else:
                    res = solve()
            wall = time.perf_counter() - t0
            if args.verbose and res.trace is not None:
                from .types import Guard

                k = int(res.iterations)
                tf = np.asarray(res.trace.f[:k])
                tg = np.asarray(res.trace.g_norm[:k])
                ta = np.asarray(res.trace.alpha[:k])
                tguards = (np.asarray(res.trace.guards[:k])
                           if res.trace.guards is not None else None)
                prev = np.zeros((Guard.N,), np.int64)
                for i in range(k):
                    line = (f"Iteration {i}, f = {tf[i]:.6g}, "
                            f"|grad| = {tg[i]:.6g}, alpha = {ta[i]:.4g}")
                    if tguards is not None:
                        # Per-iteration activations (counters are cumulative):
                        # the reference prints a warning at each of these
                        # events (lbfgs.cpp:105,121,150,194).
                        fired = [Guard.NAMES[j] for j in range(Guard.N)
                                 if tguards[i][j] > prev[j]]
                        prev = tguards[i]
                        if fired:
                            line += "  [" + ", ".join(fired) + "]"
                    print(line)
            rec = {"seed": seed, "status": Status.NAMES[int(res.status)],
                   "iterations": int(res.iterations), "f": float(res.f),
                   "g_norm": float(res.g_norm), "n_fev": int(res.n_fev),
                   "n_gev": int(res.n_gev), "wall_s": wall}
            if res.guards is not None:
                from .types import Guard

                g_arr = np.asarray(res.guards)
                rec["guards"] = {name: int(g_arr[j]) for j, name in
                                 enumerate(Guard.NAMES) if int(g_arr[j])}
        results.append(rec)
        if not args.json:
            print(f"seed {seed}: " + "  ".join(
                f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in rec.items() if k != "seed"))

    if args.json:
        print(json.dumps({"config": vars(args), "results": results}))
    elif len(results) > 1:
        walls = [r["wall_s"] for r in results]
        print(f"mean wall over {len(results)} seeds: {np.mean(walls):.4f}s "
              f"(protocol: cuda_lbfgs.pdf §IV, 5-run average)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
