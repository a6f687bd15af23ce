"""Minimal solve: the reference's `LBFGS(f, grad, x0, "backtracking", ...)`
call (sequential-implementation/lbfgs.cpp:17-25) in its on-device form.

Run:  python examples/01_basic_solve.py
"""
import jax.numpy as jnp

import tpu_lbfgs as tl

# A problem from the built-in suite (rosenbrock | quadratic |
# coupled_quadratic | sphere) — or bring your own f (see 02_custom_problem).
p = tl.get_problem("rosenbrock")

cfg = tl.LBFGSConfig(
    line_search="backtracking",   # the reference's default driver choice
    max_iters=2000,
    tol=1e-5,                     # ||g||_2 convergence (lbfgs.cpp:80-84)
    m=10,
)

x0 = jnp.full((10_000,), -1.2, jnp.float32)
res = tl.minimize(p.f, x0, cfg, grad=p.grad)

print(f"status     : {tl.Status.NAMES[int(res.status)]}")
print(f"iterations : {int(res.iterations)}")
print(f"f(x*)      : {float(res.f):.3e}")
print(f"||g||      : {float(res.g_norm):.3e}")
print(f"evals      : {int(res.n_fev)} f, {int(res.n_gev)} grad")
