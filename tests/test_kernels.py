"""The iteration's plain-XLA pieces against their NumPy twins, and the
Triton fused tail (interpret mode) against its XLA twin: identical
semantics to f32 rounding, at sizes crossing block boundaries, lane-aligned
or not.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import np_problems
from tpu_lbfgs import LBFGSConfig, Status, get_problem, minimize
from tpu_lbfgs.core.direction import combine_direction
from tpu_lbfgs.core.solver import iteration_tail
from tpu_lbfgs.kernels import tail_kernel_ok
from tpu_lbfgs.problems.suite import FUSED_VG, fused_value_and_grad

# 128-multiples crossing 1 and 2 tail blocks, plus an unaligned size.
DIMS = [128 * 3, 128 * 513, 128 * 1030 + 77]


@pytest.fixture(scope="module")
def vecs():
    rng = np.random.default_rng(0)
    out = {}
    for d in DIMS:
        out[d] = tuple(jnp.asarray(rng.normal(size=d), jnp.float32)
                       for _ in range(4))
    return out


def _close(a, b, tol, name):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.max(np.abs(b)) + 1e-30
    assert np.max(np.abs(a - b)) / scale < tol, name


@pytest.mark.parametrize("d", DIMS)
def test_iteration_tail(vecs, d):
    """The solver's plain tail (x_new, s, y and the reductions) vs NumPy."""
    x, dv, g, gn = vecs[d]
    alpha = jnp.float32(0.37)
    outs = jax.jit(iteration_tail)(x, dv, alpha, g, gn)
    x64, d64, g64, gn64 = (np.asarray(v, np.float64) for v in (x, dv, g, gn))
    s = 0.37 * d64
    y = gn64 - g64
    want = (x64 + s, s, y, s @ y, y @ y, gn64 @ gn64, d64 @ gn64,
            g64 @ gn64, y @ gn64)
    names = ("x_new", "s", "y", "sy", "yy", "gg", "dgn", "ggn", "ygn")
    for name, a, b in zip(names, outs, want):
        _close(a, b, 1e-4, name)


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("m", [1, 10, 20])
def test_combine_direction(vecs, d, m):
    """r = gamma*g + v@S - gamma*(u@Y) vs NumPy, on the solver's (m, R, L)
    ring layout."""
    from tpu_lbfgs.types import hist_block

    rng = np.random.default_rng(m)
    g = vecs[d][0]
    S = rng.normal(size=(m, d))
    Y = rng.normal(size=(m, d))
    v = rng.normal(size=m)
    u = rng.normal(size=m)
    R, L = hist_block(d)
    f32 = jnp.float32
    r = combine_direction(g, jnp.asarray(S, f32).reshape(m, R, L),
                          jnp.asarray(Y, f32).reshape(m, R, L),
                          jnp.asarray(v, f32), jnp.asarray(u, f32),
                          f32(0.8))
    want = 0.8 * np.asarray(g, np.float64) + v @ S - 0.8 * (u @ Y)
    _close(r, want, 1e-4, "r")


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("name", sorted(FUSED_VG))
def test_fused_vg(vecs, d, name):
    """The fused value-and-gradient forms (XLA) vs the NumPy twins."""
    x = vecs[d][0]
    f, g = jax.jit(FUSED_VG[name])(x)
    f_np, g_np = np_problems.PROBLEMS[name]
    x64 = np.asarray(x, np.float64)
    assert abs(float(f) - f_np(x64)) / (abs(f_np(x64)) + 1e-30) < 1e-5
    _close(g, g_np(x64), 1e-4, "g")


@pytest.mark.parametrize("name", sorted(FUSED_VG))
def test_fused_vg_matches_problem_fp64_semantics(name):
    """The fused forms compute the same math as the Problem definitions."""
    p = get_problem(name)
    rng = np.random.default_rng(3)
    x64 = rng.normal(size=128 * 9)
    f64 = float(p.f(jnp.asarray(x64)))
    x32 = jnp.asarray(x64, jnp.float32)
    f32, g32 = FUSED_VG[name](x32)
    assert abs(float(f32) - f64) / (abs(f64) + 1e-30) < 1e-4
    g64 = np.asarray(p.grad(jnp.asarray(x64)))
    scale = np.max(np.abs(g64)) + 1e-30
    assert np.max(np.abs(np.asarray(g32, np.float64) - g64)) / scale < 1e-4


def test_tail_kernel_gating():
    """The Triton tail takes f32 suite problems with an f32/bf16 ring, any
    d; everything else goes to the XLA twin."""
    f32 = jnp.zeros(100, jnp.float32)                      # unaligned: ok
    ring = jnp.zeros((2, 1, 100), jnp.float32)
    assert tail_kernel_ok("rosenbrock", f32, ring)
    assert tail_kernel_ok("quadratic", f32, ring.astype(jnp.bfloat16))
    assert not tail_kernel_ok("rosenbrock", f32.astype(jnp.float64),
                              ring.astype(jnp.float64))
    assert not tail_kernel_ok("sphere", f32, ring)         # no kernel body
    # a ring whose flat offsets pass int32 (m=20 -> 32 rows, d=2^26)
    big = jax.ShapeDtypeStruct((1 << 26,), jnp.float32)
    assert tail_kernel_ok("rosenbrock", big,
                          jax.ShapeDtypeStruct((10, 1, 1), jnp.float32))
    assert not tail_kernel_ok("rosenbrock", big,
                              jax.ShapeDtypeStruct((20, 1, 1), jnp.float32))


def test_full_solve_with_fused_tail():
    """End-to-end: the fused vg + Triton tail (interpret mode) converges
    like the plain path on coupled_quadratic in f32."""
    from tpu_lbfgs.problems.suite import fused_tail_for

    d = 128 * 16
    p = get_problem("coupled_quadratic")
    x0 = jnp.asarray(np.random.default_rng(5).uniform(-1, 1, d), jnp.float32)
    cfg_j = LBFGSConfig(line_search="wolfe_interpolation", direction="compact",
                        max_iters=100, tol=1e-2)
    cfg_p = cfg_j.replace(use_pallas=True)
    r_j = minimize(p.f, x0, cfg_j, grad=p.grad)
    r_p = minimize(p.f, x0, cfg_p,
                   value_and_grad=fused_value_and_grad("coupled_quadratic"),
                   fused_tail=fused_tail_for("coupled_quadratic",
                                             interpret=True))
    assert int(r_p.status) == Status.CONVERGED
    assert abs(int(r_p.iterations) - int(r_j.iterations)) <= 1
    assert abs(float(r_p.f) - float(r_j.f)) < 1e-2


@pytest.mark.parametrize("block", [64, 256, 2048])
def test_block_size_preserves_semantics(block):
    """Any power-of-two block leaves the Triton tail's semantics unchanged
    (masked lanes past the end, per-block partials summed outside)."""
    from tpu_lbfgs.kernels.tail import fused_tail_jnp, fused_tail_triton

    d, m = 128 * 97 + 5, 3          # not a multiple of any block size
    rng = np.random.default_rng(block)
    x, dv, g = (jnp.asarray(rng.normal(size=d), jnp.float32)
                for _ in range(3))
    S = jnp.asarray(rng.normal(size=(m, d)), jnp.float32)
    Y = jnp.asarray(rng.normal(size=(m, d)), jnp.float32)
    alpha = jnp.float32(0.41)
    vg = fused_value_and_grad("rosenbrock")
    got = fused_tail_triton("rosenbrock", x, dv, alpha, g, S, Y, True,
                            block=block, interpret=True)
    want = fused_tail_jnp(vg, x, dv, alpha, g, S, Y, True)
    for i, (a, b) in enumerate(zip(got, want)):
        _close(a, b, 1e-4, (i, block))


def test_compensated_tail_kernel_beats_plain_f32():
    """accurate_dots on the Triton tail: the compensated sum of the
    per-block partials (utils.accurate.compensated_sum) must track the f64
    reference at least as tightly as the plain sum, on data built to lose
    bits across many block partials (large running sum + small per-element
    increments)."""
    from tpu_lbfgs.kernels import make_fused_tail
    from tpu_lbfgs.kernels.tail import fused_tail_triton
    from tpu_lbfgs.types import hist_block

    d = 1 << 17
    rng = np.random.default_rng(11)
    g_new = jnp.asarray(1.0 + 1e-3 * rng.standard_normal(d), jnp.float32)
    g = jnp.asarray(1e-3 * rng.standard_normal(d), jnp.float32)
    m = 4
    R, L = hist_block(d)
    s_hist = jnp.zeros((m, R, L), jnp.float32)
    y_hist = jnp.zeros((m, R, L), jnp.float32)
    # Quadratic objective: g_new = 2 (x_new - 1), so pick x_new from g_new.
    x = jnp.asarray(1.0 + np.asarray(g_new, np.float64) / 2.0, jnp.float32)
    dvec = jnp.zeros((d,), jnp.float32)
    alpha = jnp.float32(0.37)
    outs_p = fused_tail_triton("quadratic", x, dvec, alpha, g, s_hist,
                               y_hist, False, block=64, interpret=True)
    outs_c = fused_tail_triton("quadratic", x, dvec, alpha, g, s_hist,
                               y_hist, False, block=64, accurate=True,
                               interpret=True)
    gn = np.asarray(outs_p[2], np.float64)
    ref = float(gn @ gn)
    err_plain = abs(float(outs_p[7]) - ref)
    err_comp = abs(float(outs_c[7]) - ref)
    assert err_comp <= err_plain
    assert err_comp < 64.0 * np.finfo(np.float32).eps * ref
    # the big outputs are identical (compensation touches only scalars)
    np.testing.assert_array_equal(np.asarray(outs_p[0]), np.asarray(outs_c[0]))

    # same contract through make_fused_tail
    x1 = jnp.asarray(1.0 + 1e-3 * rng.standard_normal(d), jnp.float32)
    d1 = jnp.asarray(1e-3 * rng.standard_normal(d), jnp.float32)
    vg = fused_value_and_grad("quadratic")
    tail_c = make_fused_tail("quadratic", vg, with_matvec=False,
                             accurate_dots=True, interpret=True)
    tail_p = make_fused_tail("quadratic", vg, with_matvec=False,
                             accurate_dots=False, interpret=True)
    assert tail_c.accurate_dots and not tail_p.accurate_dots
    outc = tail_c(x1, d1, jnp.float32(0.5), g, s_hist, y_hist)
    outp = tail_p(x1, d1, jnp.float32(0.5), g, s_hist, y_hist)
    xn64 = np.asarray(x1, np.float64) + 0.5 * np.asarray(d1, np.float64)
    f64 = float(np.sum((xn64 - 1.0) ** 2))
    assert abs(float(outc[1]) - f64) <= abs(float(outp[1]) - f64) + \
        4 * np.finfo(np.float32).eps * f64


def test_accurate_dots_composes_with_fused_tail_solver():
    """cfg.accurate_dots + the accurate fused tail (interpret mode) runs
    end-to-end and matches the jnp compensated path; a PLAIN fused tail
    under accurate_dots is rejected."""
    from tpu_lbfgs.problems.suite import fused_tail_for

    p = get_problem("rosenbrock")
    x0 = jnp.asarray(
        np.random.default_rng(12).uniform(-2, 2, 512), jnp.float32)
    cfg = LBFGSConfig(line_search="backtracking", max_iters=15, tol=0.0,
                      accurate_dots=True, fidelity="fixed",
                      pair_skip_threshold=1e-10)
    r_jnp = minimize(p.f, x0, cfg, grad=p.grad)
    r_fused = minimize(p.f, x0, cfg.replace(use_pallas=True), grad=p.grad,
                       value_and_grad=fused_value_and_grad("rosenbrock"),
                       fused_tail=fused_tail_for("rosenbrock",
                                                 accurate_dots=True,
                                                 interpret=True))
    np.testing.assert_allclose(np.asarray(r_fused.x), np.asarray(r_jnp.x),
                               rtol=2e-3, atol=2e-3)
    with pytest.raises(ValueError, match="accurate_dots"):
        minimize(p.f, x0, cfg.replace(use_pallas=True), grad=p.grad,
                 fused_tail=fused_tail_for("rosenbrock"))
