#!/usr/bin/env python
"""Hand-written Triton kernels against what XLA makes of their plain twins,
on the GPU: unit timings, block-size sweeps and end-to-end solves.

    python scripts/kernel_ab.py [--out chiprun_out/kernel_ab.json] [--quick]

Needs a CUDA device (exits non-zero otherwise).  Every number is printed
beside the card's name and power limit.  Unit comparisons come from
tpu_lbfgs.bench.kernel_ab (shared with chip_smoke.py phase 1).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from functools import partial

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tpu_lbfgs.bench.kernel_ab import best_wall, looped  # noqa: E402


def tail_unit(rec, d, m, hdtype, with_matvec, configs, reps=200):
    import jax.numpy as jnp

    from tpu_lbfgs.bench.kernel_ab import tail_ab

    key = f"tail/d={d}/m={m}/{jnp.dtype(hdtype).name}/matvec={with_matvec}"
    r = tail_ab(d, with_matvec, configs, m=m, hdtype=hdtype, reps=reps)
    for cfg, k in r["kernels"].items():
        print(f"{key} block x warps={cfg}: kernel {k['us']:.1f} us, xla "
              f"{r['xla_us']:.1f} us, max rel diff vectors "
              f"{k['vec_err']:.3g} sums {k['sum_err']:.3g}", flush=True)
    rec[key] = r


def chain_unit(rec, B, m, configs, reps=200):
    from tpu_lbfgs.bench.kernel_ab import chain_ab

    key = f"chain/B={B}/m={m}"
    r = chain_ab(B, configs, m=m, reps=reps)
    for cfg, k in r["kernels"].items():
        print(f"{key} lanes x warps={cfg}: kernel {k['us']:.1f} us, xla "
              f"{r['xla_us']:.1f} us, max rel diff {k['err']:.3g}, "
              f"fallback equal {k['fallback_equal']}", flush=True)
    rec[key] = r


def trace_summary(trace_dir: str, iters: int) -> dict:
    """Device busy share and event counts of a profiler trace: the union of
    all intervals on the GPU planes over the window from the first to the
    last device event."""
    import glob

    from jax.profiler import ProfileData

    path = sorted(glob.glob(f"{trace_dir}/**/*.xplane.pb", recursive=True))[-1]
    prof = ProfileData.from_file(path)
    spans, names, lines = [], {}, {}
    for plane in prof.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            evs = list(line.events)
            lines[f"{plane.name}/{line.name}"] = len(evs)
            if line.name not in ("Kernels", "Memcpy", "Activities",
                                 "Stream #0", "XLA Ops") and \
                    not line.name.startswith("Stream"):
                continue
            for e in evs:
                spans.append((e.start_ns, e.end_ns))
                names[e.name] = names.get(e.name, 0) + 1
    spans.sort()
    busy, cur_s, cur_e = 0.0, None, None
    for a, b in spans:
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    if cur_e is not None:
        busy += cur_e - cur_s
    window = (spans[-1][1] - spans[0][0]) if spans else 0
    top = sorted(names.items(), key=lambda kv: -kv[1])[:25]
    return {"lines": lines, "window_ms": window / 1e6,
            "busy_ms": busy / 1e6,
            "idle_share": 1.0 - busy / window if window else None,
            "events_per_iter": len(spans) / iters,
            "top_events": top}


def single_e2e(rec, d, iters, variants, hdtype=None, trace=None):
    """End-to-end single-instance solves (Rosenbrock, compact_incremental,
    polynomial line search, m=10, f32), one line per tail variant."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from tpu_lbfgs import LBFGSConfig, get_problem
    from tpu_lbfgs.core.solver import init_state, solve_from_state
    from tpu_lbfgs.kernels.tail import fused_tail_jnp, make_fused_tail

    p = get_problem("rosenbrock")
    cfg = LBFGSConfig(line_search="backtracking",
                      direction="compact_incremental", m=10,
                      ls_eval="polynomial", max_iters=iters, tol=0.0,
                      history_dtype=hdtype)
    vg = p.value_and_grad
    x0 = jnp.asarray(np.random.default_rng(42).uniform(-2, 2, d),
                     jnp.float32)
    for name in variants:
        if name == "plain":
            tail = None
        elif name.startswith("xla"):
            wm = name.endswith("+matvec")
            tail = (lambda wm: lambda *a: fused_tail_jnp(
                vg, *a, with_matvec=wm))(wm)
        else:
            tail = make_fused_tail("rosenbrock", vg,
                                   with_matvec=name.endswith("+matvec"))

        @jax.jit
        def run(x0, tail=tail):
            st = init_state(vg, x0, cfg.m, cfg.history_dtype)
            return solve_from_state(cfg, p.f, vg, st, p.dir_poly, tail)

        t0 = time.perf_counter()
        out = jax.block_until_ready(run(x0))
        compile_s = time.perf_counter() - t0
        wall = best_wall(run, x0, reps=3)
        hd = "bf16" if hdtype else "f32"
        key = f"e2e/d={d}/{hd}/{name}"
        rec[key] = {"wall_s": wall, "iters_per_s": iters / wall,
                    "f": float(out.f), "k": int(out.k),
                    "first_call_s": compile_s}
        print(f"{key}: {iters / wall:.1f} it/s (wall {wall:.4f} s, "
              f"f={float(out.f):.6g}, first call {compile_s:.1f} s)",
              flush=True)
        if trace and name == trace:
            tdir = f"chiprun_out/trace_{d}_{name}"
            with jax.profiler.trace(tdir):
                jax.block_until_ready(run(x0))
            summ = trace_summary(tdir, iters)
            rec[key]["trace"] = summ
            print(f"{key} trace: idle share {summ['idle_share']:.3f}, "
                  f"{summ['events_per_iter']:.1f} device events/iter, "
                  f"lines {summ['lines']}", flush=True)
            print(f"  top events: {summ['top_events'][:12]}", flush=True)


def batch_e2e(rec, B, d, iters):
    import jax
    import jax.numpy as jnp
    import numpy as np

    import tpu_lbfgs.kernels.chain as chain_mod
    from tpu_lbfgs import LBFGSConfig, get_problem
    from tpu_lbfgs.core.solver import init_state, solve_bounded

    p = get_problem("rosenbrock")
    cfg = LBFGSConfig(line_search="backtracking",
                      direction="compact_incremental", ls_eval="polynomial",
                      fidelity="fixed", pair_skip_threshold=1e-10,
                      max_iters=iters, tol=0.0)
    vg = p.value_and_grad
    x0s = jnp.asarray(np.random.default_rng(42).uniform(-2, 2, (B, d)),
                      jnp.float32)
    real_triton = chain_mod.chain_triton
    for name in ("kernel", "xla"):
        chain_mod.make_compact_chain.cache_clear()
        if name == "xla":
            # Route the custom_vmap rule's CUDA branch to the vmapped jnp
            # formulation for the A/B.
            chain_mod.chain_triton = lambda *a, m, skip_thr, interpret: \
                jax.vmap(partial(chain_mod.chain_jnp, m=m,
                                 skip_thr=skip_thr))(*a)

        @jax.jit
        def run(x0s):
            def one(x0):
                st = init_state(vg, x0, cfg.m, cfg.history_dtype)
                return solve_bounded(cfg, p.f, vg, st, p.dir_poly)
            return jax.vmap(one)(x0s)

        t0 = time.perf_counter()
        out = jax.block_until_ready(run(x0s))
        compile_s = time.perf_counter() - t0
        wall = best_wall(run, x0s, reps=3)
        chain_mod.chain_triton = real_triton
        key = f"batch/B={B}/d={d}/{name}"
        rec[key] = {"wall_s": wall, "instance_iters_per_s": B * iters / wall,
                    "mean_f": float(jnp.mean(out.f)),
                    "first_call_s": compile_s}
        print(f"{key}: {B * iters / wall:,.0f} instance-it/s (wall "
              f"{wall:.4f} s, mean f {float(jnp.mean(out.f)):.6g}, first "
              f"call {compile_s:.1f} s)", flush=True)
    chain_mod.make_compact_chain.cache_clear()


def precision_unit(rec, d, m, reps=200):
    """History contractions at HIGHEST vs DEFAULT precision."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax import lax

    from tpu_lbfgs.types import hist_block

    rng = np.random.default_rng(3)
    R, L = hist_block(d)
    S = jnp.asarray(rng.uniform(-1, 1, (m, R, L)), jnp.float32)
    Y = jnp.asarray(rng.uniform(-1, 1, (m, R, L)), jnp.float32)
    g = jnp.asarray(rng.uniform(-1, 1, (R, L)), jnp.float32)
    dn = (((1, 2), (0, 1)), ((), ()))
    for prec in ("highest", "default"):
        pr = lax.Precision.HIGHEST if prec == "highest" else None

        def step(c, S, Y):
            g, acc = c
            a = lax.dot_general(S, g, dn, precision=pr)
            b = lax.dot_general(Y, g, dn, precision=pr)
            return g + 1e-30 * a[0], acc + a.sum() + b.sum()

        t = best_wall(looped(step, reps), (g, jnp.float32(0)), S, Y) / reps
        key = f"matvec_pair/d={d}/m={m}/{prec}"
        rec[key] = {"us": t * 1e6}
        print(f"{key}: {t*1e6:.1f} us", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out/kernel_ab.json")
    ap.add_argument("--quick", action="store_true",
                    help="fewer block-size configurations and variants")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from tpu_lbfgs.bench.harness import card_name_and_power

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU: found {dev.platform}", file=sys.stderr)
        return 2
    card = card_name_and_power()
    print(f"card: {card}; jax {jax.__version__}; {dev.device_kind}",
          flush=True)
    rec = {"card": card, "device_kind": dev.device_kind,
           "jax": jax.__version__}

    tail_cfgs = [(1024, 4)] if args.quick else \
        [(512, 4), (1024, 4), (2048, 4), (2048, 8), (4096, 8)]
    mv_cfgs = [(256, 4)] if args.quick else \
        [(128, 4), (256, 4), (256, 8), (512, 8), (1024, 8)]
    chain_cfgs = [(128, 4)] if args.quick else \
        [(32, 1), (64, 2), (128, 4), (256, 4)]
    tail_unit(rec, 1 << 20, 10, jnp.float32, False, tail_cfgs)
    tail_unit(rec, 1 << 20, 10, jnp.float32, True, mv_cfgs)
    tail_unit(rec, (1 << 20) + 77, 10, jnp.float32, False, [(1024, 4)])
    tail_unit(rec, 1 << 26, 10, jnp.float32, True, [(256, 4), (512, 8)],
              reps=10)
    chain_unit(rec, 4096, 10, chain_cfgs)
    chain_unit(rec, 1000, 10, [(128, 4)])
    precision_unit(rec, 1 << 20, 10)
    variants = ["plain", "xla", "triton", "xla+matvec", "triton+matvec"]
    single_e2e(rec, 1 << 20, 1000, variants, trace="triton")
    single_e2e(rec, 1 << 20, 1000, variants[1:])        # repeat: spread
    batch_e2e(rec, 4096, 1024, 200)
    if not args.quick:
        single_e2e(rec, 1 << 20, 1000, ["triton", "triton+matvec"],
                   hdtype="bfloat16")
        for hd in (None, "bfloat16"):
            single_e2e(rec, 1 << 26, 100,
                       ["xla", "triton", "xla+matvec", "triton+matvec"],
                       hdtype=hd)
        batch_e2e(rec, 4096, 1024, 200)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(rec, fh, indent=1)
    print(f"card: {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
