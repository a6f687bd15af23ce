#!/usr/bin/env python
"""Fig.-2/3 analogue: per-strategy convergence profiles (verdict item 7).

The paper's §IV-B compares f-vs-iteration over a 5,000-iteration window on
Rosenbrock and claims (a) the Armijo-family searches reach satisfactory f in
FEWER ITERATIONS than Wolfe, and (b) parallelizing the line search closes
Wolfe's wall-clock gap (cuda_lbfgs.pdf Fig. 2-3; BASELINE.md convergence-
profile row).  This records the same profiles from this framework's own
device-side traces (cfg.record_trace — no per-iteration host sync, unlike
the reference's cout logging) and evaluates both claims against the data.

Config: the protocol's recommended f32 stack (parallel-reference tolerances,
rescue disabled — reference_protocol.run_device_cell no_rescue), d=10,000,
reference seed 42 (+ iteration counts over 3 seeds), direct evaluation.
The speculative Wolfe twin (K trial (phi, phi') pairs per round) is the
"parallelized line search" of claim (b).

Start box: x0 ~ U(-10, 10), NOT the published U(-1000, 1000) — from the
far box the interpolating searches' first trial sends f through values
beyond f32's exponent range and they fail honestly at iteration 1 (the
same documented behavior as the protocol grid's f32 cells); profiles from
the far box would compare two 1-iteration flatlines.  Within the scaled box every strategy iterates and
the figure's qualitative comparison is meaningful.

Writes convergence_profiles.json at the repo root.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

D = 10_000
WINDOW = 5_000
SEEDS = (42, 365, 12345)
STRATEGIES = (
    ("Armijo Backtracking", "backtracking"),
    ("Armijo Interpolation", "armijo_interpolation"),
    ("Wolfe Backtracking", "backtracking_wolfe"),
    ("Wolfe Interpolation", "wolfe_interpolation"),
    ("Wolfe Interpolation (speculative)", "wolfe_interpolation_speculative"),
)
DOWNSAMPLE = 10   # keep every 10th trace row (500 points per profile)


def log(m):
    print(f"[profiles {time.strftime('%H:%M:%S')}] {m}", file=sys.stderr,
          flush=True)


def run_one(strategy: str, seed: int, traced: bool):
    from tpu_lbfgs.bench.reference_protocol import _x0_np
    from tpu_lbfgs.config import REFERENCE_PARALLEL
    from tpu_lbfgs.core.solver import (
        init_state,
        make_value_and_grad,
        solve_from_state,
        _solve_traced,
        _state_to_result,
    )
    from tpu_lbfgs.problems import get_problem
    from tpu_lbfgs.problems.suite import (
        fused_tail_for,
        fused_value_and_grad,
        multi_phi_dphi_for,
    )

    cfg = REFERENCE_PARALLEL.replace(
        line_search=strategy, direction="compact_incremental",
        ls_eval="direct", use_pallas=True, alpha_rescue_floor=None,
        max_iters=WINDOW, record_trace=traced)
    p = get_problem("rosenbrock")
    vg = fused_value_and_grad("rosenbrock")
    fused_tail = fused_tail_for("rosenbrock", with_matvec=False)
    phi_dphi_batch = None
    if strategy.endswith("_speculative"):
        phi_dphi_batch = multi_phi_dphi_for("rosenbrock")

    @jax.jit
    def run(x0):
        st = init_state(vg, x0, cfg.m, cfg.history_dtype)
        if cfg.record_trace:
            out, trace = _solve_traced(cfg, p.f, vg, st, None, fused_tail,
                                       None, phi_dphi_batch)
            return _state_to_result(out, trace)
        return _state_to_result(
            solve_from_state(cfg, p.f, vg, st, None, fused_tail, None,
                             phi_dphi_batch), None)

    x0 = jnp.asarray(_x0_np(D, seed, -10.0, 10.0), jnp.float32)
    t0 = time.perf_counter()
    out = jax.block_until_ready(run(x0))
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = jax.block_until_ready(run(x0))
    wall = time.perf_counter() - t0
    return out, wall, compile_s


def main():
    log(f"backend={jax.default_backend()}")
    profiles = []
    for label, strategy in STRATEGIES:
        # Traced profile run on the reference seed (the figure), plus
        # untraced timed runs over 3 seeds (the wall-clock claim — tracing
        # runs the full bounded scan, so walls come from untraced solves).
        out, _, _ = run_one(strategy, SEEDS[0], traced=True)
        tr = out.trace
        f_arr = np.asarray(tr.f, np.float64)
        g_arr = np.asarray(tr.g_norm, np.float64)
        nfev = np.asarray(tr.n_fev)
        walls, iters, statuses = [], [], []
        for seed in SEEDS:
            o2, wall, compile_s = run_one(strategy, seed, traced=False)
            walls.append(wall)
            iters.append(int(o2.iterations))
            statuses.append(int(o2.status))
        idx = list(range(0, WINDOW, DOWNSAMPLE))
        prof = {
            "strategy": label, "strategy_key": strategy,
            "seed_traced": SEEDS[0],
            "iterations_traced": int(out.iterations),
            "final_f_traced": float(out.f),
            "final_g_norm_traced": float(out.g_norm),
            "n_fev_traced": int(out.n_fev),
            "n_gev_traced": int(out.n_gev),
            "trace_stride": DOWNSAMPLE,
            "trace_iteration": idx,
            "trace_f": [float(f_arr[i]) for i in idx],
            "trace_g_norm": [float(g_arr[i]) for i in idx],
            # iterations to reach f thresholds (the Fig.-2 reading)
            "iters_to_f": {
                ("%.0e" % th): (int(np.argmax(f_arr <= th))
                                if (f_arr <= th).any() else None)
                for th in (1e4, 1e2, 1e1, 1e0)
            },
            "untraced_mean_wall_s": round(float(np.mean(walls)), 3),
            "untraced_iterations": iters,
            "untraced_statuses": statuses,
            "ms_per_iteration": round(
                1e3 * float(np.mean([w / max(i, 1) for w, i
                                     in zip(walls, iters)])), 4),
            "trace_n_fev_final": int(nfev[-1]),
        }
        profiles.append(prof)
        log(f"{label}: {prof['iterations_traced']} iters, "
            f"f={prof['final_f_traced']:.3e}, "
            f"{prof['ms_per_iteration']} ms/it")

    # Evaluate the paper's two claims against our own data.
    by_key = {p["strategy_key"]: p for p in profiles}
    armijo = [by_key["backtracking"], by_key["armijo_interpolation"]]
    wolfe = [by_key["backtracking_wolfe"], by_key["wolfe_interpolation"]]

    # Claim (a) is evaluated at the TIGHTEST threshold every strategy
    # reached (at this d nobody reaches f<=10 in 5000 iterations; comparing
    # unreached thresholds would make the claim vacuously true).
    core4 = armijo + wolfe
    common_th = None
    for th in ("1e+00", "1e+01", "1e+02", "1e+04"):
        if all(p["iters_to_f"].get(th) is not None for p in core4):
            common_th = th
            break

    def its(p, th):
        v = p["iters_to_f"].get(th)
        return v if v is not None else WINDOW + 1

    claim_a = {
        "statement": "Armijo-family reaches satisfactory f in fewer "
                     "iterations than Wolfe over the 5000-iteration window "
                     "(cuda_lbfgs.pdf Fig. 2-3)",
        "evaluated_at_threshold": common_th,
        "iters_to_threshold": {p["strategy"]:
                               p["iters_to_f"].get(common_th)
                               for p in profiles} if common_th else None,
        "final_f_at_window": {p["strategy"]: p["final_f_traced"]
                              for p in profiles},
        "holds": (bool(min(its(p, common_th) for p in armijo)
                       <= min(its(p, common_th) for p in wolfe))
                  if common_th else
                  bool(min(p["final_f_traced"] for p in armijo)
                       <= min(p["final_f_traced"] for p in wolfe))),
    }
    seq_w = by_key["wolfe_interpolation"]
    spec_w = by_key["wolfe_interpolation_speculative"]
    trials_per_iter = seq_w["n_fev_traced"] / max(
        seq_w["iterations_traced"], 1) - 1.0
    from tpu_lbfgs.linesearch.strategies import (
        SPECULATIVE_TRIALS_THRESHOLD,
        resolve_speculative_auto,
    )
    from types import SimpleNamespace

    from tpu_lbfgs.config import LBFGSConfig as _Cfg

    auto_pick = resolve_speculative_auto(
        _Cfg(line_search="wolfe_interpolation"),
        SimpleNamespace(iterations=seq_w["iterations_traced"],
                        n_fev=seq_w["n_fev_traced"])).line_search
    claim_b = {
        "statement": "parallel line-search evaluation narrows Wolfe's "
                     "wall-clock cost (paper §IV-C: inlined-GPU Wolfe 1.79x "
                     "over host); here: fused K-trial (phi,phi') kernel vs "
                     "sequential trials, ms/iteration",
        "sequential_ms_per_iter": seq_w["ms_per_iteration"],
        "speculative_ms_per_iter": spec_w["ms_per_iteration"],
        "speedup": round(seq_w["ms_per_iteration"]
                         / spec_w["ms_per_iteration"], 3),
        "observed_trials_per_iter": round(trials_per_iter, 2),
        "reading": ("the paper's claim holds only in many-trials regimes "
                    "(measured boundary in bench_results.json "
                    "speculative_wolfe_cells: +6.9% at ~12 trials/iter, "
                    "loses at 1-2); in THIS profile's regime the ladder "
                    "evaluates candidates the sequential search never "
                    "visits and loses — which the executable rule "
                    "(linesearch.resolve_speculative_auto, threshold "
                    f"{SPECULATIVE_TRIALS_THRESHOLD}) decides correctly"),
        "auto_rule_selects": auto_pick,
        "auto_rule_correct": bool(
            (auto_pick == "wolfe_interpolation")
            == (seq_w["ms_per_iteration"] <= spec_w["ms_per_iteration"])),
    }

    report = {
        "protocol": {
            "problem": "rosenbrock", "d": D, "window": WINDOW,
            "x0": "U(-10, 10) scaled box (see module docstring), "
                  "reference seeds",
            "config": "parallel-reference tolerances (tol=1e-1, C2=0.7, "
                      "pair skip), rescue disabled, f32, direct eval, "
                      "fast stack (compact_incremental + Pallas)",
            "note": "traces recorded device-side (cfg.record_trace); the "
                    "reference's per-iteration cout forces a host sync "
                    "every step (lbfgs.cpp:76-78)",
        },
        "profiles": profiles,
        "claim_armijo_fewer_iterations": claim_a,
        "claim_parallel_closes_wolfe_gap": claim_b,
    }
    out_path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "convergence_profiles.json")
    json.dump(report, open(out_path, "w"), indent=1)
    log(f"wrote {out_path}")
    print(json.dumps({"claim_a_holds": claim_a["holds"],
                      "claim_b_speedup": claim_b["speedup"]}))


if __name__ == "__main__":
    main()
