"""Speculative (batched-candidate) backtracking: alpha parity with the
sequential strategy, and the batched trial evaluator.

The speculative search evaluates the whole ladder alpha0 * shrink^[0..K) per
round in one vector phi call; the accepted alpha must be IDENTICAL to
sequential backtracking's (same ladder, same Armijo rule, same underflow
exit), for any spec_width.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_lbfgs.config import LBFGSConfig
from tpu_lbfgs.core.solver import make_phi, make_value_and_grad, minimize
from tpu_lbfgs.linesearch.strategies import (
    backtracking,
    backtracking_speculative,
)
from tpu_lbfgs.problems import get_problem
from tpu_lbfgs.problems.suite import multi_phi_for
from tpu_lbfgs.types import Status


def _poly_phi(coeffs):
    def phi(a):
        acc = jnp.zeros_like(jnp.asarray(a)) + coeffs[-1]
        for c in coeffs[-2::-1]:
            acc = acc * a + c
        return acc
    return phi


@pytest.mark.parametrize("fidelity", ["reference", "fixed"])
@pytest.mark.parametrize("spec_width", [2, 4, 8, 19])
@pytest.mark.parametrize("shrink", [0.5, 0.7])
def test_alpha_parity_random_polys(fidelity, spec_width, shrink):
    """Random descent-shaped quartics: speculative == sequential alpha,
    bit-identical — including non-power-of-two shrink factors, where a
    pow-based ladder would round differently from the sequential
    iterated-multiply chain."""
    rng = np.random.default_rng(0)
    for trial in range(40):
        g_dot_d = jnp.float32(-np.abs(rng.normal()) - 1e-3)
        # phi(a) = f_x + g_dot_d * a + q * a^2 + c * a^3 (random curvature).
        f_x = jnp.float32(rng.normal())
        q = jnp.float32(rng.normal() * 10)
        c = jnp.float32(rng.normal())
        phi = _poly_phi([f_x, g_dot_d, q, c])
        cfg = LBFGSConfig(line_search="backtracking_speculative",
                          fidelity=fidelity, spec_width=spec_width,
                          shrink=shrink)
        r_seq = backtracking(cfg, phi, None, f_x, g_dot_d)
        r_spec = backtracking_speculative(cfg, phi, None, f_x, g_dot_d)
        assert float(r_seq.alpha) == float(r_spec.alpha), \
            f"trial {trial}: {float(r_seq.alpha)} != {float(r_spec.alpha)}"


def test_alpha_parity_with_rescue_floor():
    """Parallel-fidelity rescue (alpha underflow -> 0.5) applies equally."""
    # phi that never satisfies Armijo: strictly increasing.
    phi = _poly_phi([jnp.float32(0.0), jnp.float32(1000.0)])
    g_dot_d = jnp.float32(-1.0)
    cfg = LBFGSConfig(line_search="backtracking_speculative",
                      fidelity="fixed", alpha_rescue_floor=1e-4,
                      spec_width=4)
    r_seq = backtracking(cfg, phi, None, jnp.float32(0.0), g_dot_d)
    r_spec = backtracking_speculative(cfg, phi, None, jnp.float32(0.0),
                                      g_dot_d)
    assert float(r_seq.alpha) == float(r_spec.alpha) == 0.5


@pytest.mark.parametrize("problem", ["quadratic", "rosenbrock",
                                     "coupled_quadratic"])
def test_multi_phi_matches_numpy(problem):
    """multi_phi_for (the vmapped objective, XLA) vs the NumPy twin at K
    trial points, at an unaligned d."""
    import np_problems

    d = 1152 + 77
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.uniform(-2, 2, d), jnp.float32)
    dv = jnp.asarray(rng.uniform(-1, 1, d), jnp.float32)
    alphas = jnp.asarray([1.0, 0.5, 0.25, 0.125, 0.0625], jnp.float32)
    out = jax.jit(multi_phi_for(problem))(x, dv, alphas)
    f_np = np_problems.PROBLEMS[problem][0]
    x64, d64 = np.asarray(x, np.float64), np.asarray(dv, np.float64)
    ref = [f_np(x64 + float(a) * d64) for a in alphas]
    np.testing.assert_allclose(np.asarray(out), ref, rtol=2e-5, atol=1e-3)


def test_make_phi_vector_capable_direct():
    p = get_problem("rosenbrock")
    vg = make_value_and_grad(p.f, p.grad)
    cfg = LBFGSConfig(ls_eval="direct")
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.uniform(-2, 2, 64), jnp.float32)
    dv = jnp.asarray(rng.uniform(-1, 1, 64), jnp.float32)
    phi, _ = make_phi(cfg, p.f, vg, x, dv)
    alphas = jnp.asarray([0.5, 0.25], jnp.float32)
    batched = phi(alphas)
    singles = jnp.stack([phi(alphas[0]), phi(alphas[1])])
    np.testing.assert_allclose(np.asarray(batched), np.asarray(singles),
                               rtol=1e-6)


@pytest.mark.parametrize("ls_eval", ["direct", "polynomial"])
def test_end_to_end_speculative_matches_sequential(ls_eval):
    """Full solve: speculative and sequential backtracking produce the same
    trajectory (identical alphas -> identical iterates)."""
    p = get_problem("rosenbrock")
    x0 = jnp.asarray(np.random.default_rng(5).uniform(-2, 2, 512), jnp.float32)
    kw = dict(grad=p.grad)
    if ls_eval == "polynomial":
        kw["dir_poly"] = p.dir_poly
    base = dict(direction="compact", m=6, max_iters=120, tol=1e-3,
                ls_eval=ls_eval)
    r_seq = minimize(p.f, x0, LBFGSConfig(line_search="backtracking", **base),
                     **kw)
    r_spec = minimize(
        p.f, x0,
        LBFGSConfig(line_search="backtracking_speculative", spec_width=6,
                    **base),
        phi_batch=multi_phi_for("rosenbrock") if ls_eval == "direct" else None,
        **kw)
    assert int(r_seq.status) == int(r_spec.status)
    assert int(r_seq.iterations) == int(r_spec.iterations)
    np.testing.assert_allclose(float(r_seq.f), float(r_spec.f), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(r_seq.x), np.asarray(r_spec.x),
                               rtol=1e-4, atol=1e-5)
