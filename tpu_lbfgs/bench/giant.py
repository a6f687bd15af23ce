"""Giant-instance single-device bench cell: one (d, stack) configuration
per process, printed as one JSON line.

BASELINE.md north star: ">80% of memory roofline on the two-loop recursion
at d=1e8".  Sweep history dtypes and matvec placement one process each:

    python -m tpu_lbfgs.bench.giant --d 67108864 [--history-dtype bfloat16]
        [--with-matvec] [--donate]

Needs a GPU (harness.require_gpu); the record names the device and the
card's power limit.
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tpu_lbfgs.bench.giant")
    ap.add_argument("--d", type=int, default=1 << 26)
    ap.add_argument("--m", type=int, default=10)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--problem", default="rosenbrock")
    ap.add_argument("--history-dtype", default=None,
                    help="e.g. bfloat16; default f32")
    ap.add_argument("--with-matvec", action="store_true",
                    help="compute the history matvecs inside the fused tail "
                         "kernel instead of as XLA contractions")
    ap.add_argument("--direction", default="compact_incremental")
    ap.add_argument("--no-pallas", action="store_true")
    ap.add_argument("--donate", action="store_true",
                    help="drive the solve as donated compiled segments "
                         "(make_solve_segment) instead of one jitted call")
    args = ap.parse_args(argv)

    from ..config import LBFGSConfig
    from ..utils.roofline import traffic_model
    from .harness import require_gpu

    device = require_gpu()
    cfg = LBFGSConfig(
        line_search="backtracking", direction=args.direction, m=args.m,
        use_pallas=not args.no_pallas, ls_eval="polynomial",
        history_dtype=args.history_dtype)

    if args.donate:
        r = _bench_donated(args, cfg)
    else:
        from .harness import bench_device

        br = bench_device(problem=args.problem, d=args.d, iters=args.iters,
                          cfg=cfg, repeats=args.repeats,
                          with_matvec=args.with_matvec)
        r = {"iters_per_s": br.iters_per_s, "wall_s": br.wall_s,
             "compile_s": br.details["compile_s"]}

    ms_per_iter = 1e3 / r["iters_per_s"]
    # Roofline accounting: modeled traffic at the measured rate, as a
    # fraction of the device's published peak bandwidth.
    from ..utils.roofline import peak_bw_gbps

    tm = traffic_model(cfg, args.d)
    achieved_gbps = tm.bytes_per_iter * r["iters_per_s"] / 1e9
    roof = {
        "modeled_passes_per_iter": tm.passes_total,
        "modeled_gb_per_iter": tm.bytes_per_iter / 1e9,
        "achieved_gbps_on_model": achieved_gbps,
        "frac_of_published_peak": achieved_gbps
        / peak_bw_gbps(device["kind"]),
    }
    print(json.dumps({
        "d": args.d, "m": args.m, "iters": args.iters,
        "history_dtype": args.history_dtype or "float32",
        "with_matvec": args.with_matvec,
        "direction": args.direction,
        "use_pallas": not args.no_pallas,
        "donated_segments": args.donate,
        "ms_per_iter": ms_per_iter,
        **r,
        "roofline": roof,
        "device": device,
    }))
    return 0


def _bench_donated(args, cfg):
    """Segment-driver variant: make_solve_segment with donation, so a giant
    state is never double-buffered across segment boundaries."""
    import jax.numpy as jnp
    import numpy as np

    from ..core.solver import init_state, make_solve_segment
    from ..problems import get_problem
    from ..problems.suite import fused_tail_for, fused_value_and_grad

    cfg = cfg.replace(max_iters=args.iters * (args.repeats + 1), tol=0.0)
    p = get_problem(args.problem)
    if cfg.use_pallas:
        vg = fused_value_and_grad(args.problem)
        fused_tail = fused_tail_for(args.problem,
                                    with_matvec=args.with_matvec,
                                    accurate_dots=cfg.accurate_dots)
    else:
        from ..core.solver import make_value_and_grad

        vg = make_value_and_grad(p.f, p.grad)
        fused_tail = None
    seg = make_solve_segment(cfg, p.f, value_and_grad=vg, iters=args.iters,
                             dir_poly=p.dir_poly, fused_tail=fused_tail,
                             donate=True)

    rng = np.random.default_rng(42)
    x0 = jnp.asarray(rng.uniform(-2.0, 2.0, args.d), jnp.float32)
    import jax

    t0 = time.perf_counter()
    state = init_state(vg, x0, cfg.m, cfg.history_dtype)
    state = jax.block_until_ready(seg(state))
    compile_s = time.perf_counter() - t0
    walls = []
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        state = jax.block_until_ready(seg(state))
        walls.append(time.perf_counter() - t0)
    best = min(walls)
    return {"iters_per_s": args.iters / best, "wall_s": best,
            "compile_s": compile_s, "repeat_walls_s": walls}


if __name__ == "__main__":
    sys.exit(main())
