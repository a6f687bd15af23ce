"""Hard-problem tooling and the auto rules.

Three features the reference has no analogue for:
  1. Powell damping (cfg.damping): BLEND low-curvature pairs instead of
     rejecting them (the reference can only skip, lbfgs.cpp:192-195) —
     composes with every stack including the fused tail and the sharded
     solver.
  2. history_dtype="auto": resolved per solve from the ring's size and the
     batch (core.solver.resolve_history_dtype; the input dtype until a
     size rule is measured on the GPU, ROADMAP S5).
  3. resolve_speculative_auto: a short sequential probe decides whether the
     speculative (batched K-trial) Wolfe twin will pay off, from the observed
     line-search trials/iteration (CLI: --auto-speculative).

Run:  python examples/08_hard_problems_and_auto_rules.py
"""
import jax.numpy as jnp
import numpy as np

import tpu_lbfgs as tl

# --- 1. Powell damping on a non-convex double-well -------------------------------
# Around the hilltop at x=0 curvature is negative: the plain solver REJECTS
# those pairs (Guard.PAIR_REJECT), losing their information; damping blends
# them (Guard.DAMPED) and keeps every step's curvature.


def dw(x):
    return jnp.sum(-0.5 * x * x + 0.05 * x ** 4)


def dw_grad(x):
    return -x + 0.2 * x ** 3


x0 = jnp.asarray(np.random.default_rng(0).uniform(-0.5, 0.5, 512))
base = tl.LBFGSConfig(line_search="backtracking", m=5, max_iters=80,
                      tol=1e-8)
plain = tl.minimize(dw, x0, base, grad=dw_grad)
damped = tl.minimize(dw, x0, base.replace(damping=0.2), grad=dw_grad)
g_p, g_d = np.asarray(plain.guards), np.asarray(damped.guards)
print(f"plain : {tl.Status.NAMES[int(plain.status)]:10s} "
      f"iters={int(plain.iterations):3d} rejected pairs="
      f"{g_p[tl.Guard.PAIR_REJECT]}")
print(f"damped: {tl.Status.NAMES[int(damped.status)]:10s} "
      f"iters={int(damped.iterations):3d} damped pairs="
      f"{g_d[tl.Guard.DAMPED]} (rejected: {g_d[tl.Guard.PAIR_REJECT]})")

# --- 2. the batch-aware history-dtype rule ---------------------------------------
from tpu_lbfgs.core.solver import resolve_history_dtype  # noqa: E402

for batch, d in ((1, 4096), (4096, 1024), (1024, 4096), (1, 1 << 26)):
    picked = resolve_history_dtype("auto", 10, d, jnp.float32, batch=batch)
    print(f"auto ring dtype at batch={batch:5d} d={d:9d}: "
          f"{picked or 'float32 (input dtype)'}")

# --- 3. speculative line-search auto selection -----------------------------------
from tpu_lbfgs.linesearch.strategies import resolve_speculative_auto  # noqa: E402

p = tl.get_problem("rosenbrock")
cfg = tl.LBFGSConfig(line_search="wolfe_interpolation", c2=0.9,
                     max_iters=50, tol=0.0)
x0r = jnp.asarray(np.random.default_rng(1).uniform(-2, 2, 4096), jnp.float32)
probe = tl.minimize(p.f, x0r, cfg, grad=p.grad)
resolved = resolve_speculative_auto(cfg, probe)
trials = int(probe.n_fev) / max(int(probe.iterations), 1) - 1
print(f"probe observed {trials:.1f} line-search trials/iter -> "
      f"line_search={resolved.line_search!r}")
