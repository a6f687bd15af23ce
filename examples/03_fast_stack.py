"""The fastest measured single-device stack (see PERF.md):

  compact_incremental direction + polynomial line search + the fused
  value-and-gradient + the fused iteration tail (a Triton kernel on the
  GPU) + f32 history.

Run:  python examples/03_fast_stack.py   (d = 2^20 on a GPU, 2^14 elsewhere)
"""
import time

import jax
import jax.numpy as jnp

import tpu_lbfgs as tl

problem = "rosenbrock"
p = tl.get_problem(problem)

on_gpu = jax.default_backend() == "gpu"
d, iters = ((1 << 20), 1000) if on_gpu else ((1 << 14), 100)

cfg = tl.LBFGSConfig(
    line_search="backtracking",
    direction="compact_incremental",   # Byrd–Nocedal–Schnabel + incremental products
    ls_eval="polynomial",              # closed-form phi(alpha): O(1) trials
    use_pallas=True,
    max_iters=iters,
    tol=0.0,                           # fixed-iteration throughput run
)

# Problem-aware fast-path capabilities (all optional; plain minimize(f, x0)
# works for any objective):
vg = tl.fused_value_and_grad(problem)                      # f+grad, one pass
tail = tl.fused_tail_for(problem, with_matvec=False)       # fused iteration tail

x0 = jnp.full((d,), -1.2, jnp.float32)
res = jax.block_until_ready(tl.minimize(p.f, x0, cfg, value_and_grad=vg,
                                        dir_poly=p.dir_poly,
                                        fused_tail=tail))   # compile warmup

t0 = time.perf_counter()
res = jax.block_until_ready(tl.minimize(p.f, x0, cfg, value_and_grad=vg,
                                        dir_poly=p.dir_poly,
                                        fused_tail=tail))
dt = time.perf_counter() - t0
print(f"{int(res.iterations)} iterations in {dt:.3f}s = "
      f"{int(res.iterations) / dt:.0f} it/s")
