"""Scaling out: vmapped instance batches and mesh-sharded giant instances.

The reference is single-process single-GPU (SURVEY.md §2 parallelism
inventory); these are the two scaling axes here:

  - batch axis:  thousands of independent problem instances per device (vmap)
  - vector axis: one giant instance sharded over a device mesh, every
    reduction compiled to local partials + psum

Run:  python examples/04_batched_and_sharded.py
(on CPU it uses the virtual-device mesh; set
 XLA_FLAGS=--xla_force_host_platform_device_count=8 to see 8-way sharding)
"""
import jax
import jax.numpy as jnp
import numpy as np

import tpu_lbfgs as tl
from tpu_lbfgs.batch import vmap_minimize
from tpu_lbfgs.dist import (
    make_mesh,
    make_mesh_2d,
    sharded_minimize,
    sharded_vmap_minimize,
)

p = tl.get_problem("rosenbrock")
cfg = tl.LBFGSConfig(line_search="backtracking",
                     direction="compact_incremental",
                     max_iters=500, tol=1e-4)

# --- 1. batch of independent instances (one jitted program, all lanes) ------
# The BASELINE config-4 shape: 4096 independent d=1000 instances per chip.
# (Rosenbrock from random starts needs thousands of iterations per lane —
# the reference's own notebook shows 18k+ — so the batch demo uses the
# coupled quadratic, which converges in ~12.)
pq = tl.get_problem("coupled_quadratic")
B, d = 4096, 1000
x0s = jnp.asarray(np.random.default_rng(0).uniform(-2, 2, (B, d)), jnp.float32)
res = vmap_minimize(pq.f, x0s, cfg, grad=pq.grad)
conv = int(jnp.sum(res.status == tl.Status.CONVERGED))
print(f"batch: {conv}/{B} converged, "
      f"median iters = {int(jnp.median(res.iterations))}")

# --- 2. one giant instance sharded over every device ------------------------
mesh = make_mesh()                       # 1-D mesh over jax.devices()
big = jnp.full((1 << 16,), -1.2, jnp.float32)
res = sharded_minimize(p.f, big, cfg, mesh=mesh, grad=p.grad)
print(f"sharded over {len(mesh.devices.ravel())} device(s): "
      f"{tl.Status.NAMES[int(res.status)]} in {int(res.iterations)} iters, "
      f"||g|| = {float(res.g_norm):.2e}")

# --- 3. both axes at once: a 2-D (batch, d) mesh, fused-tail stack ----------
# Passing problem= selects the shard-composable fused tail: the per-shard
# tail inside shard_map (the Triton kernel on GPUs), batched over the mesh's
# b axis.
n = len(jax.devices())
if n % 2 == 0 and n > 1:
    mesh2 = make_mesh_2d(batch_size=2)
    cfg2 = cfg.replace(use_pallas=True, ls_eval="polynomial",
                       max_iters=60, tol=1e-3)
    x0s2 = jnp.asarray(
        np.random.default_rng(1).uniform(-2, 2, (4, 1 << 14)), jnp.float32)
    res = sharded_vmap_minimize(p.f, x0s2, cfg2, mesh=mesh2, grad=p.grad,
                                dir_poly=p.dir_poly, problem="rosenbrock")
    print(f"2-D mesh {dict(mesh2.shape)}: "
          f"{int(jnp.sum(res.status == tl.Status.CONVERGED))}/4 converged, "
          f"median iters = {int(jnp.median(res.iterations))}")
