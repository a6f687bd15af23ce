"""Fused post-line-search tail kernel: parity with the plain-ops composition.

The fused tail (kernels/tail.py::make_fused_tail) must return exactly what
the unfused chain computes: x_new = x + alpha*d, (f, g) at x_new, the ring
rows in history dtype, the seven pair/convergence scalars, and the
pre-update history matvecs S@y_new / Y@y_new.  On the CPU the Triton kernel
runs in interpret mode, asked for explicitly (tests/conftest.py forces the
cpu backend).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_lbfgs.config import LBFGSConfig
from tpu_lbfgs.core.solver import init_state, iterate, make_value_and_grad
from tpu_lbfgs.kernels.tail import (
    fused_tail_jnp,
    fused_tail_triton,
    make_fused_tail,
)
from tpu_lbfgs.problems import get_problem
from tpu_lbfgs.problems.suite import fused_tail_for

PROBLEMS = ["quadratic", "rosenbrock", "coupled_quadratic"]


def _inputs(d, m, hdtype, seed=0):
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.uniform(-2, 2, d), jnp.float32)
    dv = jnp.asarray(rng.uniform(-1, 1, d), jnp.float32)
    g = jnp.asarray(rng.uniform(-1, 1, d), jnp.float32)
    S = jnp.asarray(rng.uniform(-1, 1, (m, d)), jnp.float32).astype(hdtype)
    Y = jnp.asarray(rng.uniform(-1, 1, (m, d)), jnp.float32).astype(hdtype)
    alpha = jnp.float32(0.37)
    return x, dv, alpha, g, S, Y


@pytest.mark.parametrize("problem", PROBLEMS)
@pytest.mark.parametrize("hdtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("with_matvec", [True, False])
def test_pallas_matches_jnp(problem, hdtype, with_matvec):
    d, m = 1152, 4  # not a block multiple: masked lanes exercised
    x, dv, alpha, g, S, Y = _inputs(d, m, hdtype)
    p = get_problem(problem)
    vg = make_value_and_grad(p.f, p.grad)

    ref = fused_tail_jnp(vg, x, dv, alpha, g, S, Y, with_matvec)
    out = fused_tail_triton(problem, x, dv, alpha, g, S, Y, with_matvec,
                            block=256, interpret=True)

    names = ["x_new", "f_new", "g_new", "s_row", "y_row",
             "sy", "yy", "gg", "dgn", "ggn", "ygn", "t1", "t2"]
    for name, a, b in zip(names, out, ref):
        if a is None:
            assert b is None
            continue
        np.testing.assert_allclose(
            np.asarray(a, np.float32), np.asarray(b, np.float32),
            rtol=2e-5, atol=1e-4, err_msg=f"{problem}/{name}")
        assert a.dtype == b.dtype, name


def test_dispatch_falls_back_on_ineligible_shape():
    # f64 vectors (no kernel) -> the jnp path even with interpret=True,
    # bitwise equal to fused_tail_jnp; and off CUDA the kernel-eligible
    # f32 call lowers to the same jnp twin.
    d, m = 100, 3
    x, dv, alpha, g, S, Y = _inputs(d, m, jnp.float32)
    p = get_problem("rosenbrock")
    vg = make_value_and_grad(p.f, p.grad)
    as64 = lambda *a: tuple(v.astype(jnp.float64) for v in a)
    tail = make_fused_tail("rosenbrock", vg, with_matvec=True,
                           interpret=True)
    out = tail(*as64(x, dv, alpha, g, S, Y))
    ref = fused_tail_jnp(vg, *as64(x, dv, alpha, g, S, Y), True)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    on_cpu = jax.jit(make_fused_tail("rosenbrock", vg, with_matvec=True))
    ref32 = jax.jit(lambda *a: fused_tail_jnp(vg, *a, True))
    for a, b in zip(on_cpu(x, dv, alpha, g, S, Y),
                    ref32(x, dv, alpha, g, S, Y)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("hdtype", [None, "bfloat16"])
def test_solver_trajectory_matches_unfused(hdtype):
    """iterate() with fused_tail must track the unfused path."""
    p = get_problem("rosenbrock")
    vg = make_value_and_grad(p.f, p.grad)
    cfg = LBFGSConfig(line_search="backtracking",
                      direction="compact_incremental", m=4,
                      ls_eval="polynomial", use_pallas=False,
                      history_dtype=hdtype)
    tail = fused_tail_for("rosenbrock", with_matvec=True, interpret=True)

    x0 = jnp.asarray(np.random.default_rng(1).uniform(-2, 2, 256), jnp.float32)
    s_a = init_state(vg, x0, cfg.m, cfg.history_dtype)
    s_b = init_state(vg, x0, cfg.m, cfg.history_dtype)
    for _ in range(6):
        s_a = iterate(cfg, p.f, vg, s_a, p.dir_poly)
        s_b = iterate(cfg, p.f, vg, s_b, p.dir_poly, tail)
    # bf16 history amplifies benign reduction-order differences over the
    # trajectory; the single-step kernel parity test above is the tight one.
    rtol = 1e-4 if hdtype is None else 3e-3
    np.testing.assert_allclose(float(s_a.f), float(s_b.f), rtol=rtol)
    np.testing.assert_allclose(float(s_a.g_norm), float(s_b.g_norm),
                               rtol=10 * rtol)
    np.testing.assert_allclose(np.asarray(s_a.x), np.asarray(s_b.x),
                               rtol=10 * rtol, atol=10 * rtol)
    assert int(s_a.n_pairs) == int(s_b.n_pairs)


def test_fused_tail_incremental_update_semantics():
    """t1/t2 from the fused tail are S@y_new / Y@y_new over PRE-update rows;
    the solver's additive updates plus exact slot patches must reproduce a
    direct contraction with the post-update history and g_new."""
    d, m = 256, 3
    x, dv, alpha, g, S, Y = _inputs(d, m, jnp.float32, seed=2)
    p = get_problem("quadratic")
    vg = make_value_and_grad(p.f, p.grad)
    out = fused_tail_jnp(vg, x, dv, alpha, g, S, Y, True)
    (x_new, f_new, g_new, s_row, y_row, sy, yy, gg, dgn, ggn, ygn,
     t1, t2) = out
    slot = 1
    S2 = S.at[slot].set(s_row)
    Y2 = Y.at[slot].set(y_row)
    Sg_old, Yg_old = S @ g, Y @ g
    Sg_next = (Sg_old + t1).at[slot].set(alpha * dgn)
    Yg_next = (Yg_old + t2).at[slot].set(ygn)
    np.testing.assert_allclose(np.asarray(S2 @ g_new), np.asarray(Sg_next),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(Y2 @ g_new), np.asarray(Yg_next),
                               rtol=1e-4, atol=1e-4)
    # New SY / YY column against y_new, with exact diagonals.
    SY_col = t1.at[slot].set(sy)
    YY_col = t2.at[slot].set(yy)
    np.testing.assert_allclose(np.asarray(S2 @ y_row), np.asarray(SY_col),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(Y2 @ y_row), np.asarray(YY_col),
                               rtol=1e-4, atol=1e-4)


def test_auto_with_matvec_rule():
    """with_matvec="auto" resolves to no matvecs at every size and history
    dtype: no size rule is set on the GPU yet (ROADMAP S5), and the exact
    default keeps the tail's outputs the plain contract's."""
    from tpu_lbfgs.problems.suite import auto_with_matvec, fused_tail_for

    m = 10
    for d in (1 << 10, 1 << 20, 1 << 26):
        for hd in (None, "bfloat16"):
            assert not auto_with_matvec(m, d, hd)
    assert not auto_with_matvec(m, 1024, None, batch=4096)
    # "auto" with and without d builds a tail that returns no matvecs
    x, dv, alpha, g, S, Y = _inputs(256, 2, jnp.float32)
    for kw in ({}, {"d": 256}):
        tail = fused_tail_for("rosenbrock", with_matvec="auto", **kw)
        out = tail(x, dv, alpha, g, S, Y)
        assert out[11] is None and out[12] is None
