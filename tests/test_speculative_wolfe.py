"""Speculative Wolfe searches (VERDICT r3 missing #3): the K-trial
(phi, phi') ladder/tree evaluation must reproduce the sequential searches'
alpha sequences EXACTLY — speculation changes how many evaluations run, not
which step is accepted.

Covers: the batched (phi, dphi) evaluator vs NumPy, strategy-level alpha parity on
crafted 1-D problems, and end-to-end trajectory parity of full solves.
Completes the paper's "multiple step sizes in parallel" idea
(cuda_lbfgs.pdf §II) for the Wolfe searches it motivated; the reference's
own loops evaluate one host-round-trip trial at a time
(L-BFGS-Wolfe.cu:276-349).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_lbfgs import LBFGSConfig, get_problem, minimize
from tpu_lbfgs.linesearch.strategies import (
    backtracking_wolfe,
    backtracking_wolfe_speculative,
    wolfe_interpolation,
    wolfe_interpolation_speculative,
)


@pytest.mark.parametrize("problem", ["quadratic", "rosenbrock",
                                     "coupled_quadratic"])
def test_multi_phi_dphi_matches_numpy(problem):
    """multi_phi_dphi_for (vmapped fused value-and-gradient, XLA) vs the
    NumPy twins at K trial points."""
    import np_problems

    from tpu_lbfgs.problems.suite import multi_phi_dphi_for

    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.uniform(-2, 2, 2048), jnp.float32)
    d = jnp.asarray(rng.uniform(-1, 1, 2048), jnp.float32)
    alphas = jnp.asarray([1.0, 2.0, 4.0, 0.5, 0.25], jnp.float32)
    phis, dphis = jax.jit(multi_phi_dphi_for(problem))(x, d, alphas)
    f_np, g_np = np_problems.PROBLEMS[problem]
    x64, d64 = np.asarray(x, np.float64), np.asarray(d, np.float64)
    want_f = [f_np(x64 + float(a) * d64) for a in alphas]
    want_d = [g_np(x64 + float(a) * d64) @ d64 for a in alphas]
    np.testing.assert_allclose(np.asarray(phis), want_f, rtol=2e-5)
    np.testing.assert_allclose(np.asarray(dphis), want_d,
                               rtol=2e-5, atol=1e-2)


def _poly_phi_dphi(coeffs):
    """Vector-capable analytic (phi, phi') from ascending coefficients."""
    coeffs = jnp.asarray(coeffs, jnp.float64)
    dcoeffs = coeffs[1:] * jnp.arange(1, coeffs.shape[0], dtype=jnp.float64)

    def horner(c, a):
        acc = c[-1] * jnp.ones_like(a)
        for k in range(c.shape[0] - 2, -1, -1):
            acc = acc * a + c[k]
        return acc

    def phi(a):
        return horner(coeffs, jnp.asarray(a, jnp.float64))

    def phi_dphi(a):
        a = jnp.asarray(a, jnp.float64)
        return horner(coeffs, a), horner(dcoeffs, a)

    return phi, phi_dphi


# 1-D test objectives phi(a) with phi(0)=c0, phi'(0)=c1 < 0; shapes chosen to
# exercise accept-at-1, long doubling ladders, zoom entries, and growth.
POLYS = [
    [1.0, -1.0, 0.5],                       # quadratic, min at a=1
    [1.0, -1.0, 0.005],                     # shallow: min at a=100 (ladder)
    [1.0, -1.0, 0.0005],                    # min at a=1000 (long ladder)
    [1.0, -2.0, 0.02],                      # min at a=50
    [5.0, -4.0, 2.0, -0.5, 0.03],           # quartic with structure
    [1.0, -0.1, 2.0],                       # steep: min at a=0.025 (zoom)
    [1.0, -0.01, 8.0],                      # steeper: tiny accepted step
]


@pytest.mark.parametrize("coeffs", POLYS)
@pytest.mark.parametrize("K", [2, 4, 8])
def test_wolfe_interpolation_speculative_alpha_parity(coeffs, K):
    cfg = LBFGSConfig(line_search="wolfe_interpolation", c2=0.9,
                      spec_width=K)
    phi, phi_dphi = _poly_phi_dphi(coeffs)
    f_x = phi(jnp.asarray(0.0))
    gdd = phi_dphi(jnp.asarray(0.0))[1]
    seq = wolfe_interpolation(cfg, phi, phi_dphi, f_x, gdd)
    spec = wolfe_interpolation_speculative(cfg, phi, phi_dphi, f_x, gdd)
    assert float(spec.alpha) == float(seq.alpha), \
        (coeffs, K, float(spec.alpha), float(seq.alpha))


@pytest.mark.parametrize("coeffs", POLYS)
@pytest.mark.parametrize("K", [3, 5, 8])
def test_backtracking_wolfe_speculative_alpha_parity(coeffs, K):
    cfg = LBFGSConfig(line_search="backtracking_wolfe", c2=0.9, spec_width=K)
    phi, phi_dphi = _poly_phi_dphi(coeffs)
    f_x = phi(jnp.asarray(0.0))
    gdd = phi_dphi(jnp.asarray(0.0))[1]
    seq = backtracking_wolfe(cfg, phi, phi_dphi, f_x, gdd)
    spec = backtracking_wolfe_speculative(cfg, phi, phi_dphi, f_x, gdd)
    assert float(spec.alpha) == float(seq.alpha), \
        (coeffs, K, float(spec.alpha), float(seq.alpha))


@pytest.mark.parametrize("ls_pair", [
    ("wolfe_interpolation", "wolfe_interpolation_speculative"),
    ("backtracking_wolfe", "backtracking_wolfe_speculative"),
])
@pytest.mark.parametrize("problem", ["rosenbrock", "coupled_quadratic"])
def test_speculative_wolfe_full_solve_trajectory_parity(ls_pair, problem):
    """End-to-end (f64, direct evaluation): the speculative solve walks the
    IDENTICAL iterate sequence as the sequential one."""
    seq_name, spec_name = ls_pair
    p = get_problem(problem)
    x0 = jnp.asarray(np.random.default_rng(8).uniform(-2, 2, 96))
    base = LBFGSConfig(max_iters=60, tol=1e-8, c2=0.9, ls_eval="direct")
    r_seq = minimize(p.f, x0, base.replace(line_search=seq_name), grad=p.grad)
    r_spec = minimize(p.f, x0, base.replace(line_search=spec_name),
                      grad=p.grad)
    assert int(r_spec.iterations) == int(r_seq.iterations)
    np.testing.assert_allclose(np.asarray(r_spec.x), np.asarray(r_seq.x),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(float(r_spec.f), float(r_seq.f), rtol=1e-12)


def test_speculative_wolfe_with_pallas_phi_dphi_batch():
    """f32 + the batched K-trial evaluator as phi_dphi_batch: the
    speculative solve matches the sequential Wolfe solve within f32
    reduction tolerance."""
    from tpu_lbfgs.problems.suite import multi_phi_dphi_for

    p = get_problem("rosenbrock")
    x0 = jnp.asarray(np.random.default_rng(9).uniform(-2, 2, 2048),
                     jnp.float32)
    base = LBFGSConfig(max_iters=25, tol=0.0, c2=0.9, ls_eval="direct")
    r_seq = minimize(p.f, x0, base.replace(line_search="wolfe_interpolation"),
                     grad=p.grad)
    r_spec = minimize(
        p.f, x0,
        base.replace(line_search="wolfe_interpolation_speculative"),
        grad=p.grad,
        phi_dphi_batch=multi_phi_dphi_for("rosenbrock"))
    assert abs(int(r_spec.iterations) - int(r_seq.iterations)) <= 1
    np.testing.assert_allclose(float(r_spec.f), float(r_seq.f), rtol=5e-3)


def test_speculative_wolfe_polynomial_mode():
    """Under ls_eval="polynomial" the Horner phi_dphi broadcasts natively;
    the speculative searches run with zero objective evaluations and match
    the sequential polynomial-mode solve exactly."""
    p = get_problem("rosenbrock")
    x0 = jnp.asarray(np.random.default_rng(10).uniform(-2, 2, 256))
    base = LBFGSConfig(max_iters=40, tol=1e-8, c2=0.9, ls_eval="polynomial")
    r_seq = minimize(p.f, x0, base.replace(line_search="wolfe_interpolation"),
                     grad=p.grad, dir_poly=p.dir_poly)
    r_spec = minimize(
        p.f, x0,
        base.replace(line_search="wolfe_interpolation_speculative"),
        grad=p.grad, dir_poly=p.dir_poly)
    assert int(r_spec.iterations) == int(r_seq.iterations)
    np.testing.assert_allclose(np.asarray(r_spec.x), np.asarray(r_seq.x),
                               rtol=1e-12, atol=1e-12)


def test_speculative_wolfe_sharded():
    """Sharded speculative-Wolfe solve (the K trials as one vmapped
    evaluation on the sharded vectors) matches the sharded sequential-Wolfe
    solve."""
    import warnings

    from tpu_lbfgs.dist import make_mesh, sharded_minimize

    p = get_problem("rosenbrock")
    mesh = make_mesh()
    x0 = jnp.asarray(np.random.default_rng(12).uniform(-2, 2, 8192),
                     jnp.float32)
    base = LBFGSConfig(max_iters=20, tol=0.0, c2=0.9, ls_eval="direct",
                       use_pallas=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")      # the fused path must NOT warn
        r_spec = sharded_minimize(
            p.f, x0,
            base.replace(line_search="wolfe_interpolation_speculative"),
            mesh=mesh, grad=p.grad, problem="rosenbrock")
        r_seq = sharded_minimize(
            p.f, x0, base.replace(line_search="wolfe_interpolation"),
            mesh=mesh, grad=p.grad, problem="rosenbrock")
    assert abs(int(r_spec.iterations) - int(r_seq.iterations)) <= 1
    np.testing.assert_allclose(float(r_spec.f), float(r_seq.f), rtol=5e-3)


def test_wolfe_speculative_subfloor_initial_step_parity():
    """Regression (r4 review): a branch-3 doubling node can itself floor out
    (alpha*2 < interp_min) when initial_step is below the floor; the ladder
    must stop there exactly like the sequential loop."""
    cfg = LBFGSConfig(line_search="wolfe_interpolation", c2=0.9,
                      initial_step=2.5e-11)      # < interp_min = 1e-10
    phi, phi_dphi = _poly_phi_dphi([1.0, -1.0, 0.005])
    f_x = phi(jnp.asarray(0.0))
    gdd = phi_dphi(jnp.asarray(0.0))[1]
    seq = wolfe_interpolation(cfg, phi, phi_dphi, f_x, gdd)
    spec = wolfe_interpolation_speculative(cfg, phi, phi_dphi, f_x, gdd)
    assert float(spec.alpha) == float(seq.alpha) == cfg.interp_min


def test_backtracking_wolfe_speculative_non_pow2_shrink_delegates():
    """Regression (r4 review): for a non-power-of-two shrink the tree cannot
    reproduce the walk's fp rounding; the speculative variant must delegate
    to the sequential search (parity preserved by construction)."""
    cfg = LBFGSConfig(line_search="backtracking_wolfe", c2=0.9, shrink=0.9)
    phi, phi_dphi = _poly_phi_dphi([1.0, -0.1, 2.0])
    f_x = phi(jnp.asarray(0.0))
    gdd = phi_dphi(jnp.asarray(0.0))[1]
    seq = backtracking_wolfe(cfg, phi, phi_dphi, f_x, gdd)
    spec = backtracking_wolfe_speculative(cfg, phi, phi_dphi, f_x, gdd)
    assert float(spec.alpha) == float(seq.alpha)
    assert int(spec.n_fev) == int(seq.n_fev)     # delegated, not speculated


def test_resolve_speculative_auto_rule():
    """The measured speculative-selection guidance as an executable rule
    (same pattern as history_dtype='auto'): switch to the twin at high
    observed trials/iteration, keep the sequential search in well-scaled
    regimes, touch nothing for non-Wolfe searches."""
    from types import SimpleNamespace

    from tpu_lbfgs import LBFGSConfig
    from tpu_lbfgs.linesearch.strategies import (
        SPECULATIVE_TRIALS_THRESHOLD,
        resolve_speculative_auto,
    )

    def probe(iters, trials_per_iter):
        return SimpleNamespace(iterations=iters,
                               n_fev=int(iters * (1 + trials_per_iter)))

    cfg = LBFGSConfig(line_search="wolfe_interpolation")
    hard = resolve_speculative_auto(cfg, probe(50, 12.0))
    assert hard.line_search == "wolfe_interpolation_speculative"
    easy = resolve_speculative_auto(cfg, probe(50, 1.5))
    assert easy.line_search == "wolfe_interpolation"
    edge = resolve_speculative_auto(
        cfg, probe(50, SPECULATIVE_TRIALS_THRESHOLD))
    assert edge.line_search == "wolfe_interpolation_speculative"
    bw = LBFGSConfig(line_search="backtracking_wolfe")
    assert resolve_speculative_auto(bw, probe(50, 20.0)).line_search \
        == "backtracking_wolfe_speculative"
    # non-Wolfe strategies unchanged even at extreme trial counts
    bt = LBFGSConfig(line_search="backtracking")
    assert resolve_speculative_auto(bt, probe(50, 20.0)).line_search \
        == "backtracking"
    # the resolved twin is accepted by the solver's registry
    from tpu_lbfgs.linesearch.strategies import get_line_search
    get_line_search(hard.line_search)
