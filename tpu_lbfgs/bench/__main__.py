"""Full benchmark sweep: python -m tpu_lbfgs.bench [--out bench_results.json]

Runs the headline fixed-iteration benches across configurations (directions,
line searches, dtypes, dims) plus the CPU-native baseline, and writes a JSON
report naming the device.  Needs a GPU: with none it fails before measuring,
and any failed configuration fails the run (non-zero exit).
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tpu_lbfgs.bench")
    ap.add_argument("--out", default="bench_results.json")
    ap.add_argument("--d", type=int, default=1 << 20)
    ap.add_argument("--iters", type=int, default=1000)
    ap.add_argument("--quick", action="store_true",
                    help="3 key configs only")
    ap.add_argument("--reference-protocol", action="store_true",
                    help="run the reference's published experiment instead: "
                         "5 seeds x 4 strategies x d in {1e4,1e5,2^20}, "
                         "x0 ~ U(-1000,1000), to convergence, device vs the "
                         "native C++ oracle (Table-I analogue)")
    ap.add_argument("--problem", default="rosenbrock")
    ap.add_argument("--cpu-budget", type=float, default=600.0,
                    help="per-(dim,strategy) CPU-oracle wall budget (s)")
    ap.add_argument("--device-budget", type=float, default=600.0,
                    help="per-cell device seed-loop wall budget (s)")
    ap.add_argument("--cell-timeout", type=int, default=900,
                    help="hard time limit per CPU-oracle cell (s)")
    ap.add_argument("--no-cpu", action="store_true")
    ap.add_argument("--no-device", action="store_true")
    ap.add_argument("--device-f64", action="store_true",
                    help="include the f64 sequential-config device cells")
    ap.add_argument("--scaling", action="store_true",
                    help="strong-scaling sweep over shard counts on the "
                         "available GPUs (BASELINE.md: efficiency at "
                         "1 device / N devices)")
    args = ap.parse_args(argv)

    from ..utils.cache import enable_compile_cache
    from .harness import require_gpu

    enable_compile_cache()
    device = require_gpu()
    print(f"device: {device['kind']} x{device['count']}; card "
          f"{device['card']}", flush=True)

    if args.scaling:
        from .scaling import scaling_sweep

        rows = scaling_sweep(d=args.d, iters=min(args.iters, 50))
        for r in rows:
            print(f"n={r['n_devices']:3d}  {r['iters_per_s']:9.1f} it/s  "
                  f"speedup {r['speedup']:.2f}  eff {r['efficiency']:.2f}")
        out = args.out if args.out != "bench_results.json" \
            else "scaling_results.json"
        with open(out, "w") as fh:
            json.dump({"device": device, "d": args.d, "rows": rows}, fh,
                      indent=1)
        print(f"wrote {out}")
        return 0

    if args.reference_protocol:
        from .reference_protocol import run_protocol

        out = args.out if args.out != "bench_results.json" \
            else "reference_protocol_results.json"
        run_protocol(problem=args.problem, cpu=not args.no_cpu,
                     device=not args.no_device, cpu_budget_s=args.cpu_budget,
                     device_budget_s=args.device_budget,
                     cell_timeout_s=args.cell_timeout,
                     out=out, quick=args.quick, device_f64=args.device_f64)
        return 0

    from ..config import LBFGSConfig
    from .harness import bench_batch, bench_cpu_native, bench_device

    base = LBFGSConfig(line_search="backtracking", m=10)
    configs = [
        ("two_loop/direct", base.replace(direction="two_loop")),
        ("compact/direct", base.replace(direction="compact")),
        ("compact/poly+fused", base.replace(
            direction="compact", ls_eval="polynomial", use_pallas=True)),
        ("incr/poly+fused", base.replace(
            direction="compact_incremental", ls_eval="polynomial",
            use_pallas=True)),
        ("incr/poly+fused/bf16", base.replace(
            direction="compact_incremental", ls_eval="polynomial",
            use_pallas=True, history_dtype="bfloat16")),
        ("incr/poly+fused/m=20", base.replace(
            direction="compact_incremental", ls_eval="polynomial",
            use_pallas=True, m=20)),
        ("wolfe/poly", base.replace(
            direction="compact_incremental", ls_eval="polynomial",
            line_search="wolfe_interpolation", c2=0.9, use_pallas=True)),
        ("spec-ls/direct+fused/bf16", base.replace(
            direction="compact_incremental",
            line_search="backtracking_speculative",
            use_pallas=True, history_dtype="bfloat16")),
    ]
    if args.quick:
        configs = [configs[1], configs[4], configs[7]]

    rows = []
    for name, cfg in configs:
        t0 = time.time()
        r = bench_device(d=args.d, iters=args.iters, cfg=cfg, repeats=2)
        rows.append({"config": name, "iters_per_s": r.iters_per_s,
                     "wall_s": r.wall_s, "final_f": r.final_f,
                     "compile_s": r.details["compile_s"],
                     "setup_s": time.time() - t0})
        print(f"{name:28s} {r.iters_per_s:9.1f} it/s", flush=True)

    # BASELINE.json config 4: 4096 independent d=1e3-class instances vmapped.
    rb = bench_batch(batch=4096, d=1024, iters=200)
    rows.append({"config": "batch-4096xd1024",
                 "instance_iters_per_s": rb.iters_per_s,
                 "wall_s": rb.wall_s})
    print(f"{'batch-4096xd1024':28s} {rb.iters_per_s:12,.0f} inst-it/s")

    cpu = bench_cpu_native(d=args.d, iters=20,
                           cfg=LBFGSConfig(line_search="backtracking"))
    rows.append({"config": "cpu-native-baseline",
                 "iters_per_s": cpu.iters_per_s})
    print(f"{'cpu-native-baseline':28s} {cpu.iters_per_s:9.2f} it/s")

    with open(args.out, "w") as fh:
        json.dump({"device": device, "d": args.d, "iters": args.iters,
                   "rows": rows}, fh, indent=1)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
