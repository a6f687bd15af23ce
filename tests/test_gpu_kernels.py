"""The Triton kernels compiled for the card (marker ``gpu``).

Elsewhere these skip inside the ``gpu`` fixture (tests/conftest.py): a
Triton kernel compiles only for a CUDA device, and its interpret-mode runs
are covered by tests/test_tail_fused.py and tests/test_chain.py.
chip_smoke.py runs them on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_lbfgs.kernels.chain import chain_jnp, chain_triton
from tpu_lbfgs.kernels.tail import fused_tail_jnp, fused_tail_triton
from tpu_lbfgs.problems.suite import fused_value_and_grad

pytestmark = pytest.mark.gpu


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-30))


@pytest.mark.parametrize("d", [1 << 16, (1 << 16) + 77])
@pytest.mark.parametrize("with_matvec", [False, True])
@pytest.mark.parametrize("problem", ["rosenbrock", "coupled_quadratic"])
def test_tail_kernel_on_card(gpu, problem, d, with_matvec):
    rng = np.random.default_rng(d)
    f32 = jnp.float32
    m = 4
    x = jnp.asarray(rng.uniform(-2, 2, d), f32)
    dv = jnp.asarray(rng.uniform(-1, 1, d), f32)
    g = jnp.asarray(rng.uniform(-1, 1, d), f32)
    S = jnp.asarray(rng.uniform(-1, 1, (m, d)), f32)
    Y = jnp.asarray(rng.uniform(-1, 1, (m, d)), f32)
    alpha = jnp.float32(0.37)
    lowered = jax.jit(lambda *a: fused_tail_triton(
        problem, *a, with_matvec)).lower(x, dv, alpha, g, S, Y)
    assert "triton" in lowered.as_text()
    got = lowered.compile()(x, dv, alpha, g, S, Y)
    want = jax.jit(lambda *a: fused_tail_jnp(
        fused_value_and_grad(problem), *a, with_matvec))(
            x, dv, alpha, g, S, Y)
    for i, (a, b) in enumerate(zip(got, want)):
        if b is None:
            assert a is None
            continue
        assert _rel(a, b) < 1e-4, i


@pytest.mark.parametrize("B", [4096, 1000])
def test_chain_kernel_on_card(gpu, B):
    m = 10
    rng = np.random.default_rng(B)
    f32 = jnp.float32
    SY = rng.uniform(0.1, 2.0, (B, m, m))
    SY[:, np.arange(m), np.arange(m)] += 2.0
    args = (jnp.asarray(SY, f32),
            jnp.asarray(rng.uniform(0.1, 2.0, (B, m, m)), f32),
            jnp.asarray(rng.uniform(-1, 1, (B, m)), f32),
            jnp.asarray(rng.uniform(-1, 1, (B, m)), f32),
            jnp.asarray(rng.uniform(0.1, 2.0, (B, m)), f32),
            jnp.asarray(rng.uniform(0.1, 2.0, (B, m)), f32),
            jnp.asarray(rng.integers(0, 4 * m, (B,)), jnp.int32),
            jnp.asarray(rng.uniform(0.1, 10.0, (B,)), f32))
    got = jax.jit(lambda *a: chain_triton(*a, m=m, skip_thr=1e-10))(*args)
    want = jax.jit(jax.vmap(lambda *a: chain_jnp(*a, m=m,
                                                 skip_thr=1e-10)))(*args)
    np.testing.assert_array_equal(np.asarray(got[4]), np.asarray(want[4]))
    ok = ~np.asarray(want[4])
    for a, b in zip(got[:4], want[:4]):
        assert _rel(np.asarray(a)[ok], np.asarray(b)[ok]) < 1e-4


def test_solver_dispatch_picks_the_kernels_on_card(gpu):
    """On CUDA the fused tail and the vmapped chain lower to Triton calls,
    and the platform dispatch leaves no conditional in the optimized
    program."""
    import tpu_lbfgs as tl
    from tpu_lbfgs.core.solver import init_state, solve_bounded

    p = tl.get_problem("rosenbrock")
    cfg = tl.LBFGSConfig(line_search="backtracking",
                         direction="compact_incremental",
                         ls_eval="polynomial", max_iters=3, tol=0.0)
    vg = tl.fused_value_and_grad("rosenbrock")
    tail = tl.fused_tail_for("rosenbrock")
    x0s = jnp.zeros((64, 1024), jnp.float32)

    def run(x0s):
        def one(x0):
            st = init_state(vg, x0, cfg.m, None)
            return solve_bounded(cfg, p.f, vg, st, p.dir_poly, tail)
        return jax.vmap(one)(x0s)

    lowered = jax.jit(run).lower(x0s)
    assert lowered.as_text().count("triton") >= 2
    hlo = lowered.compile().as_text()
    assert "conditional" not in hlo
