#!/usr/bin/env python
"""Headline benchmark: L-BFGS iterations/s on Rosenbrock d=2^20 (GPU, f32).

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "iter/s", "vs_baseline": N, ...,
   "device": {...}}

vs_baseline semantics: the reference's published headline is its GPU running
1.2x faster than its own CPU implementation at d=10,000 (BASELINE.md, Fig.1).
Absolute reference GPU times are unrecoverable (missing xlsx), so the
baseline is reconstructed on this machine: the native C++ oracle (-O3
-march=native, the stand-in for the reference's sequential implementation)
times the identical fixed-iteration workload, and

    vs_baseline = device_iters_per_s / (1.2 * cpu_iters_per_s)

i.e. our speedup over the *reference-GPU-equivalent* throughput.  Values > 1
beat the reference's headline result.

Needs a GPU: with none it exits non-zero before measuring anything, and any
failed configuration fails the run.  The record names the device, the card's
name and power limit, and XLA_FLAGS.
"""
import json
import sys
import time

# The benched stack, also emitted in the JSON record.
BENCH_D = 1 << 20


def config_key(cfg) -> str:
    """The (config)-keying string, derived FROM the cfg object so a record
    cannot drift from the actually-benched stack."""
    return (f"{cfg.line_search}/{cfg.direction}"
            + ("/poly-ls" if cfg.ls_eval == "polynomial" else "")
            + ("/fused-tail" if cfg.use_pallas else "")
            + f"/m={cfg.m}")


def log(msg: str) -> None:
    print(f"[bench {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def main() -> int:
    import jax.numpy as jnp

    from tpu_lbfgs.bench.harness import (
        REFERENCE_GPU_SPEEDUP,
        bench_batch,
        bench_cpu_native,
        bench_device,
        require_gpu,
    )
    from tpu_lbfgs.config import LBFGSConfig
    from tpu_lbfgs.utils.cache import enable_compile_cache

    cache_dir = enable_compile_cache()
    device = require_gpu()
    log(f"device: {device['kind']} x{device['count']}; card "
        f"{device['card']}; compile cache {cache_dir}")

    # d = 2^20 (the 1e6-class size).  Stack: incremental compact direction
    # + polynomial line search + the fused tail (the Triton kernel on the
    # GPU) + f32 history.  1000 timed iterations per call.
    d = BENCH_D
    cfg = LBFGSConfig(line_search="backtracking",
                      direction="compact_incremental", m=10,
                      use_pallas=True, ls_eval="polynomial")
    r = bench_device(problem="rosenbrock", d=d, iters=1000, cfg=cfg,
                     dtype=jnp.float32, repeats=3)
    log(f"single: {r.iters_per_s:.1f} it/s (wall {r.wall_s:.4f} s, "
        f"compile {r.details['compile_s']:.1f} s)")

    # CPU baseline runs the reference's own algorithm (direct evaluation,
    # two-loop) — the comparison is framework vs framework, not knob vs knob.
    cpu_cfg = LBFGSConfig(line_search="backtracking", m=10)
    cpu = bench_cpu_native(problem="rosenbrock", d=d, iters=20, cfg=cpu_cfg)

    # BASELINE config-4 batch cell: 4096 independent d=1024 instances
    # vmapped in lockstep — the second headline workload.
    b = bench_batch(problem="rosenbrock", batch=4096, d=1024, iters=200,
                    repeats=3)
    cpu_b = bench_cpu_native(problem="rosenbrock", d=1024, iters=200,
                             cfg=LBFGSConfig(line_search="backtracking",
                                             m=10))
    log(f"batch: {b.iters_per_s:,.0f} instance-it/s (wall {b.wall_s:.3f} s)")
    batch_rec = {
        "metric": "lbfgs_instance_iters_per_s_batch4096_d1024_f32",
        "value": b.iters_per_s,
        "unit": "instance-iter/s",
        # One device solving 4096 instances vs the reference-GPU-equivalent
        # solving them one at a time (1.2x normalization).
        "vs_baseline": b.iters_per_s
        / (REFERENCE_GPU_SPEEDUP * cpu_b.iters_per_s),
        "cpu_native_iters_per_s_d1024": cpu_b.iters_per_s,
        "wall_s_200it": b.wall_s,
        "compile_s": b.details["compile_s"],
    }

    vs_baseline = r.iters_per_s / (REFERENCE_GPU_SPEEDUP * cpu.iters_per_s)
    print(json.dumps({
        "metric": "lbfgs_iters_per_s_rosenbrock_d2e20_f32",
        "value": r.iters_per_s,
        "unit": "iter/s",
        "vs_baseline": vs_baseline,
        "cpu_native_iters_per_s": cpu.iters_per_s,
        "device_wall_s_1000it": r.wall_s,
        "repeat_walls_s": r.details["repeat_walls_s"],
        "compile_s": r.details["compile_s"],
        "config": config_key(cfg),
        # Second BASELINE workload, nested so the one-line contract holds.
        "batch_metric": batch_rec,
        "device": device,
        "compile_cache_dir": cache_dir,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
