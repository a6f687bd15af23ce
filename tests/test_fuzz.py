"""Property fuzzing: line searches and directions vs the NumPy oracle on
randomized, sometimes-adversarial inputs (huge/tiny gradients, bad scaling).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_lbfgs import LBFGSConfig
from tpu_lbfgs import oracle
from tpu_lbfgs.linesearch.strategies import get_line_search
import np_problems

STRATEGIES = ["backtracking", "backtracking_wolfe_bisect",
              "armijo_interpolation", "wolfe_interpolation"]


def _fuzz_cases(n=40, dim=12):
    rng = np.random.default_rng(99)
    f_np, g_np = np_problems.PROBLEMS["rosenbrock"]
    for i in range(n):
        scale = 10.0 ** rng.integers(-3, 4)
        x = rng.uniform(-2, 2, dim) * scale
        g = g_np(x)
        kind = i % 4
        if kind == 0:
            d = -g
        elif kind == 1:
            d = -g * 10.0 ** rng.integers(-6, 7)   # absurd scaling
        elif kind == 2:
            d = -g + rng.normal(size=dim) * np.linalg.norm(g)
        else:
            d = -rng.exponential(size=dim) * np.sign(g)  # rough descent
        gdd = float(np.dot(g, d))
        if gdd >= 0:
            d, gdd = -g, float(np.dot(g, -g))
        yield x, d, float(f_np(x)), g, gdd


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_fuzz_alpha_parity(strategy):
    cfg = LBFGSConfig(line_search=strategy, c2=0.9)
    from tpu_lbfgs.problems import get_problem
    p = get_problem("rosenbrock")
    f_np, g_np = np_problems.PROBLEMS["rosenbrock"]
    ls_jax = get_line_search(strategy)
    ls_np = oracle.LINE_SEARCHES[strategy]

    def run_impl(x, d, fx, gdd):
        phi = lambda a: p.f(x + a * d)

        def phi_dphi(a):
            fv = p.f(x + a * d)
            return fv, jnp.vdot(p.grad(x + a * d), d)

        return ls_jax(cfg, phi, phi_dphi, fx, gdd)

    run = jax.jit(run_impl)
    mismatches = []
    for x, d, fx, g, gdd in _fuzz_cases():
        a_np = ls_np(cfg, f_np, g_np, x, d, fx, g, gdd)
        a_jax = float(run(jnp.asarray(x), jnp.asarray(d), jnp.asarray(fx),
                          jnp.asarray(gdd)).alpha)
        both_nan = np.isnan(a_np) and np.isnan(a_jax)
        if not both_nan and not np.isclose(a_jax, a_np, rtol=1e-7, atol=1e-12):
            mismatches.append((a_jax, a_np, gdd))
    assert not mismatches, f"{strategy}: {mismatches[:3]} (+{len(mismatches)})"


@pytest.mark.parametrize("shrink", [0.5, 0.7])
def test_fuzz_speculative_matches_sequential(shrink):
    """Fuzzed phi landscapes: backtracking_speculative returns exactly the
    sequential strategy's alpha (both fidelities exercised via the default
    reference mode + the textbook break-fail rule)."""
    from tpu_lbfgs.linesearch.strategies import (
        backtracking,
        backtracking_speculative,
    )
    from tpu_lbfgs.problems import get_problem

    p = get_problem("rosenbrock")
    for fidelity in ("reference", "fixed"):
        cfg = LBFGSConfig(line_search="backtracking_speculative",
                          fidelity=fidelity, spec_width=5, shrink=shrink)

        def make(x, d):
            def phi(a):
                a = jnp.asarray(a)
                if a.ndim == 0:
                    return p.f(x + a * d)
                return jax.vmap(lambda aa: p.f(x + aa * d))(a)
            return phi

        mismatches = []
        for x, d, fx, g, gdd in _fuzz_cases(n=24):
            phi = make(jnp.asarray(x), jnp.asarray(d))
            fx_j = jnp.asarray(np.float64(fx))
            gdd_j = jnp.asarray(np.float64(gdd))
            a_seq = float(backtracking(cfg, phi, None, fx_j, gdd_j).alpha)
            a_spec = float(
                backtracking_speculative(cfg, phi, None, fx_j, gdd_j).alpha)
            if a_seq != a_spec:
                mismatches.append((a_seq, a_spec))
        assert not mismatches, f"{fidelity}: {mismatches[:3]}"


def test_fuzz_fused_tail_parity():
    """Randomized (x, d, alpha, g, history): the fused tail's jnp fallback
    and the solver-visible quantities agree with direct computation."""
    from tpu_lbfgs.core.solver import make_value_and_grad
    from tpu_lbfgs.kernels.tail import fused_tail_jnp
    from tpu_lbfgs.problems import get_problem
    from tpu_lbfgs.types import hist_block

    p = get_problem("coupled_quadratic")
    vg = make_value_and_grad(p.f, p.grad)
    rng = np.random.default_rng(11)
    d_dim, m = 96, 3
    for trial in range(10):
        x = jnp.asarray(rng.uniform(-1, 1, d_dim))
        dv = jnp.asarray(rng.uniform(-1, 1, d_dim))
        g = jnp.asarray(rng.uniform(-1, 1, d_dim))
        S = jnp.asarray(rng.uniform(-1, 1, (m, d_dim))).reshape(
            m, *hist_block(d_dim))
        Y = jnp.asarray(rng.uniform(-1, 1, (m, d_dim))).reshape(
            m, *hist_block(d_dim))
        alpha = jnp.asarray(10.0 ** rng.integers(-6, 1))
        out = fused_tail_jnp(vg, x, dv, alpha, g, S, Y, True)
        (x_new, f_new, g_new, s_row, y_row, sy, yy, gg, dgn, ggn, ygn,
         t1, t2) = out
        xn_ref = x + alpha * dv
        f_ref, g_ref = vg(xn_ref)
        np.testing.assert_allclose(np.asarray(x_new), np.asarray(xn_ref),
                                   rtol=1e-12)
        np.testing.assert_allclose(float(f_new), float(f_ref), rtol=1e-10)
        y_ref = g_ref - g
        np.testing.assert_allclose(float(ygn), float(jnp.vdot(y_ref, g_ref)),
                                   rtol=1e-8, atol=1e-12)
        np.testing.assert_allclose(
            np.asarray(t1),
            np.asarray(jnp.tensordot(S, y_ref.reshape(S.shape[1:]), 2)),
            rtol=1e-8, atol=1e-12)


def test_fuzz_direction_agreement():
    """two_loop vs compact on randomized histories (incl. ill-conditioned
    curvature pairs): agree or both fall back to a descent direction."""
    from test_direction import _make_state
    from tpu_lbfgs.core.direction import compact_direction, two_loop_direction

    cfg = LBFGSConfig(m=5)
    rng = np.random.default_rng(7)
    for trial in range(20):
        state, g, _, _ = _make_state(rng, d=24, m=5)
        d_loop = np.asarray(two_loop_direction(cfg, state))
        d_comp = np.asarray(compact_direction(cfg, state))
        scale = np.max(np.abs(d_loop)) + 1e-30
        agree = np.max(np.abs(d_comp - d_loop)) / scale < 1e-6
        descent = float(np.dot(d_comp, g)) < 0 and float(np.dot(d_loop, g)) < 0
        assert agree or descent, trial
