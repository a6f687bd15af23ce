"""Analytic gradients vs jax.grad, and NumPy-vs-JAX value agreement.

The reference only ships analytic gradients (functions.cpp:16-49) and its GPU
Rosenbrock gradient kernel is wrong (benchmark.cu:30-48); here every analytic
gradient is checked against autodiff.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_lbfgs.problems import get_problem, problem_names
import np_problems


@pytest.mark.parametrize("name", problem_names())
def test_analytic_grad_matches_autodiff(name):
    p = get_problem(name)
    key = jax.random.PRNGKey(0)
    x = jax.random.uniform(key, (64,), jnp.float64, minval=-2.0, maxval=2.0)
    auto = jax.grad(p.f)(x)
    np.testing.assert_allclose(np.asarray(p.grad(x)), np.asarray(auto),
                               rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("name", sorted(np_problems.PROBLEMS))
def test_jax_matches_numpy(name):
    p = get_problem(name)
    f_np, g_np = np_problems.PROBLEMS[name]
    rng = np.random.default_rng(1)
    x = rng.uniform(-3, 3, size=128)
    xj = jnp.asarray(x)
    assert np.isclose(float(p.f(xj)), f_np(x), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(p.grad(xj)), g_np(x), rtol=1e-12)


@pytest.mark.parametrize("name", problem_names())
def test_minimum(name):
    p = get_problem(name)
    if p.minimizer is None:
        pytest.skip("no known minimizer")
    xstar = p.minimizer(32, jnp.float64)
    assert np.isclose(float(p.f(xstar)), p.minimum_value, atol=1e-12)
    np.testing.assert_allclose(np.asarray(p.grad(xstar)), 0.0, atol=1e-10)


def test_vmap_and_jit():
    p = get_problem("rosenbrock")
    xs = jnp.asarray(np.random.default_rng(2).uniform(-1, 1, (8, 32)))
    vals = jax.jit(jax.vmap(p.f))(xs)
    assert vals.shape == (8,)
    grads = jax.jit(jax.vmap(p.grad))(xs)
    assert grads.shape == (8, 32)


def test_auto_with_matvec_dtype_forms_agree():
    """Both spellings of a history dtype (string and class) resolve the
    same way, for every dtype and size."""
    import jax.numpy as jnp
    from tpu_lbfgs.problems.suite import auto_with_matvec
    for d in (1 << 20, 1 << 21, 1 << 22, 1 << 26):
        assert auto_with_matvec(10, d, "bfloat16") \
            == auto_with_matvec(10, d, jnp.bfloat16)
        assert auto_with_matvec(10, d, "float64") \
            == auto_with_matvec(10, d, jnp.float64)
