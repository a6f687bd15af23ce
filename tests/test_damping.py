"""Powell-damped curvature updates (cfg.damping — an extension; the
reference can only REJECT low-curvature pairs, lbfgs.cpp:192-195).  The
damped pair's scalars are derived algebraically from the raw ones; these
tests pin the algebra against direct recomputation and the behavioral
contract (pairs stored instead of rejected; inactive on convex runs)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_lbfgs import Guard, LBFGSConfig, Status, get_problem, minimize


def _dw(x):
    return jnp.sum(-0.5 * x * x + 0.05 * x ** 4)


def _dw_grad(x):
    return -x + 0.2 * x ** 3


def test_damping_stores_pairs_instead_of_rejecting():
    x0 = jnp.asarray(np.random.default_rng(0).uniform(-0.5, 0.5, 16))
    base = LBFGSConfig(line_search="backtracking", max_iters=60, tol=1e-8,
                       m=5)
    r_skip = minimize(_dw, x0, base, grad=_dw_grad)
    r_damp = minimize(_dw, x0, base.replace(damping=0.2), grad=_dw_grad)
    gs, gd = np.asarray(r_skip.guards), np.asarray(r_damp.guards)
    assert gs[Guard.PAIR_REJECT] > 0            # the undamped run rejects
    assert gd[Guard.PAIR_REJECT] == 0           # damping rescues every pair
    assert gd[Guard.DAMPED] > 0
    assert int(r_damp.status) == Status.CONVERGED


def test_damping_inactive_on_convex_run():
    """On a well-conditioned convex problem s.y >= mu * s.B0 s holds, so the
    damped solve is bit-identical to the plain one."""
    p = get_problem("rosenbrock")
    x0 = jnp.asarray(np.random.default_rng(1).uniform(0.5, 1.5, 64))
    base = LBFGSConfig(line_search="wolfe_interpolation", c2=0.9,
                       max_iters=40, tol=1e-10)
    r_plain = minimize(p.f, x0, base, grad=p.grad)
    r_damp = minimize(p.f, x0, base.replace(damping=0.2), grad=p.grad)
    d = np.asarray(r_damp.guards)[Guard.DAMPED]
    if d == 0:                                   # expected: never fires
        np.testing.assert_array_equal(np.asarray(r_plain.x),
                                      np.asarray(r_damp.x))
        assert int(r_plain.iterations) == int(r_damp.iterations)


def test_damped_scalars_match_direct_recomputation():
    """sy/yy/ygn for the damped pair, derived algebraically in iterate, must
    equal direct dots of the stored y_bar row."""
    from tpu_lbfgs.core.solver import init_state, iterate, make_value_and_grad

    cfg = LBFGSConfig(line_search="backtracking", max_iters=10, tol=0.0,
                      m=4, damping=0.2)
    vg = make_value_and_grad(_dw, _dw_grad)
    x0 = jnp.asarray(np.random.default_rng(2).uniform(-0.5, 0.5, 16))
    st = init_state(vg, x0, cfg.m)
    for _ in range(6):
        st = iterate(cfg, _dw, vg, st)
    st = jax.tree.map(np.asarray, st)
    m = cfg.m
    for p_i in range(int(st.n_pairs)):
        slot = p_i % m
        s_row = st.s_hist[slot].reshape(-1)
        y_row = st.y_hist[slot].reshape(-1)
        np.testing.assert_allclose(st.sy_hist[slot], s_row @ y_row,
                                   rtol=1e-10)
        np.testing.assert_allclose(st.yy_hist[slot], y_row @ y_row,
                                   rtol=1e-10)
    # every stored pair has positive curvature (the damping guarantee)
    assert np.all(st.sy_hist[:int(min(st.n_pairs, m))] > 0)
    assert np.asarray(st.guards)[Guard.DAMPED] > 0


def test_damping_validates_range():
    with pytest.raises(ValueError, match="damping"):
        LBFGSConfig(damping=1.5)


def test_damping_compact_incremental_matches_compact():
    """The incremental products under damping must reproduce the recomputed
    ('compact') products' trajectory: the round-4 advisor found the Sg/Yg
    advance used the DAMPED y_bar where the invariant needs the raw gradient
    difference — this pins the fixed algebra on a run where damping fires
    repeatedly."""
    x0 = jnp.asarray(np.random.default_rng(3).uniform(-0.5, 0.5, 64))
    base = LBFGSConfig(line_search="backtracking", max_iters=60, tol=1e-9,
                       m=5, damping=0.2)
    r_c = minimize(_dw, x0, base.replace(direction="compact"), grad=_dw_grad)
    r_i = minimize(_dw, x0, base.replace(direction="compact_incremental"),
                   grad=_dw_grad)
    assert np.asarray(r_c.guards)[Guard.DAMPED] > 0
    # f64 end-to-end: the incremental products differ from recomputation
    # only by accumulated rounding, so trajectories agree tightly.
    np.testing.assert_allclose(np.asarray(r_i.x), np.asarray(r_c.x),
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(float(r_i.f), float(r_c.f), rtol=1e-8,
                               atol=1e-12)
    assert np.asarray(r_i.guards)[Guard.DAMPED] \
        == np.asarray(r_c.guards)[Guard.DAMPED]


def test_damping_composes_with_fused_tail():
    """cfg.damping now runs on the fused-tail path (the blend is applied to
    the kernel's raw outputs post-hoc): trajectory must match the plain jnp
    tail.  Exercised through the fused-tail code route (t1/t2 matvecs +
    hdtype rows) via its jnp composition — semantics identical to the Triton
    kernel, which tests/test_tail_fused.py pins against it."""
    from tpu_lbfgs.kernels.tail import fused_tail_jnp

    def vg(x):
        return _dw(x), _dw_grad(x)

    def tail(x, d, alpha, g, s_hist, y_hist):
        return fused_tail_jnp(vg, x, d, alpha, g, s_hist, y_hist,
                              with_matvec=True)

    x0 = jnp.asarray(np.random.default_rng(4).uniform(-0.5, 0.5, 128))
    for direction in ("compact_incremental", "two_loop"):
        cfg = LBFGSConfig(line_search="backtracking", max_iters=50, tol=1e-9,
                          m=5, damping=0.2, direction=direction)
        r_plain = minimize(_dw, x0, cfg, grad=_dw_grad)
        r_fused = minimize(_dw, x0, cfg, grad=_dw_grad, fused_tail=tail)
        assert np.asarray(r_plain.guards)[Guard.DAMPED] > 0, direction
        np.testing.assert_allclose(np.asarray(r_fused.x),
                                   np.asarray(r_plain.x),
                                   rtol=1e-9, atol=1e-12, err_msg=direction)
        np.testing.assert_array_equal(np.asarray(r_fused.guards),
                                      np.asarray(r_plain.guards))


def test_damping_composes_with_pallas_f32():
    """damping + use_pallas + the Triton fused tail (interpret mode on CPU)
    on a suite problem: runs without raising and matches the jnp path to
    f32 tolerance."""
    from tpu_lbfgs.problems.suite import fused_tail_for, fused_value_and_grad

    p = get_problem("rosenbrock")
    x0 = jnp.asarray(
        np.random.default_rng(5).uniform(-2.0, 2.0, 256), jnp.float32)
    cfg = LBFGSConfig(line_search="backtracking", max_iters=25, tol=0.0,
                      m=5, damping=0.2, direction="compact_incremental",
                      pair_skip_threshold=1e-10, fidelity="fixed")
    r_jnp = minimize(p.f, x0, cfg, grad=p.grad)
    r_pal = minimize(p.f, x0, cfg.replace(use_pallas=True), grad=p.grad,
                     value_and_grad=fused_value_and_grad("rosenbrock"),
                     fused_tail=fused_tail_for("rosenbrock",
                                               with_matvec=True,
                                               interpret=True))
    # f32 kernels accumulate in a different order than the jnp reduction;
    # trajectories agree to f32 tolerance over 25 iterations.
    np.testing.assert_allclose(np.asarray(r_pal.x), np.asarray(r_jnp.x),
                               rtol=2e-3, atol=2e-3)
    assert np.asarray(r_pal.guards)[Guard.DAMPED] \
        == np.asarray(r_jnp.guards)[Guard.DAMPED]


def test_damping_composes_with_sharded_minimize():
    """damping on the d-sharded stack (8 virtual devices): matches the
    single-device damped solve."""
    from tpu_lbfgs.dist import sharded_minimize
    from tpu_lbfgs.dist.mesh import make_mesh

    x0 = jnp.asarray(np.random.default_rng(6).uniform(-0.5, 0.5, 1024))
    cfg = LBFGSConfig(line_search="backtracking", max_iters=40, tol=1e-9,
                      m=5, damping=0.2)
    r_one = minimize(_dw, x0, cfg, grad=_dw_grad)
    r_sh = sharded_minimize(_dw, x0, cfg, mesh=make_mesh(), grad=_dw_grad)
    assert np.asarray(r_one.guards)[Guard.DAMPED] > 0
    np.testing.assert_allclose(np.asarray(r_sh.x), np.asarray(r_one.x),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_array_equal(np.asarray(r_sh.guards),
                                  np.asarray(r_one.guards))
