"""Divergence-robustness regressions.

Failure chain this guards (observed on ~20/4096 vmapped f32 Rosenbrock
lanes at d=1024): a pair with sy ~ 1e-20 passes the CPU-rule curvature
check (sy > 0), puts a near-zero pivot on R's diagonal, the compact solve
emits an astronomically-large-but-finite direction, backtracking underflows
its floor without ever passing Armijo, and the reference semantics then
APPLY the untested step — f explodes to 1e20+.

Fixes under test:
  1. fidelity="fixed": a broke backtracking search returns alpha=0 (solver
     bails with LINE_SEARCH_FAILED) instead of stepping untested.
  2. pair_skip_threshold masks low-curvature pairs inside the compact
     formulations (previously two_loop only).
  3. non-finite f/||g|| after a step freezes the lane (all fidelities).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_lbfgs import LBFGSConfig, Status, get_problem
from tpu_lbfgs.core.direction import compute_direction
from tpu_lbfgs.core.solver import (
    init_state,
    make_value_and_grad,
    solve_from_state,
)
from tpu_lbfgs.linesearch.strategies import get_line_search
from tpu_lbfgs.types import hist_block


@pytest.mark.parametrize("ls", ["backtracking", "backtracking_speculative"])
def test_fixed_broke_search_returns_zero(ls):
    """Never-accepting phi under fixed fidelity -> alpha = 0 (failure)."""
    phi = lambda a: jnp.asarray(1e6, jnp.float32) * (1.0 + a)  # always worse
    cfg = LBFGSConfig(line_search=ls, fidelity="fixed")
    r = get_line_search(ls)(cfg, phi, None, jnp.float32(0.0),
                            jnp.float32(-1.0))
    assert float(r.alpha) == 0.0


@pytest.mark.parametrize("ls", ["backtracking", "backtracking_speculative"])
def test_reference_broke_search_keeps_untested_alpha(ls):
    """Reference fidelity preserves the reference's underflow behavior."""
    phi = lambda a: jnp.asarray(1e6, jnp.float32) * (1.0 + a)
    cfg = LBFGSConfig(line_search=ls, fidelity="reference")
    r = get_line_search(ls)(cfg, phi, None, jnp.float32(0.0),
                            jnp.float32(-1.0))
    assert 0.0 < float(r.alpha) < cfg.backtracking_tol


def test_pair_skip_masks_tiny_curvature_in_compact():
    """A stored pair with sy ~ 1e-20 must not blow up the compact direction
    when pair_skip_threshold is set."""
    d, m = 64, 4
    rng = np.random.default_rng(0)
    g = jnp.asarray(rng.normal(size=d), jnp.float32)
    vg = lambda x: (jnp.sum(x * x), g)
    cfg = LBFGSConfig(direction="compact", pair_skip_threshold=1e-10)
    st = init_state(vg, jnp.zeros(d, jnp.float32), m)
    blk = hist_block(d)
    # One healthy pair + one degenerate pair (s almost orthogonal to y).
    s0 = jnp.asarray(rng.normal(size=d), jnp.float32)
    y0 = s0 * 2.0
    s1 = jnp.asarray(rng.normal(size=d), jnp.float32) * 1e-12
    y1 = jnp.asarray(rng.normal(size=d), jnp.float32) * 1e-12
    st = st._replace(
        s_hist=st.s_hist.at[0].set(s0.reshape(blk)).at[1].set(s1.reshape(blk)),
        y_hist=st.y_hist.at[0].set(y0.reshape(blk)).at[1].set(y1.reshape(blk)),
        sy_hist=st.sy_hist.at[0].set(jnp.vdot(s0, y0))
                          .at[1].set(jnp.float32(1e-25)),
        yy_hist=st.yy_hist.at[0].set(jnp.vdot(y0, y0))
                          .at[1].set(jnp.vdot(y1, y1)),
        n_pairs=jnp.int32(2))
    d_vec = compute_direction(cfg, st)
    # Masked solve: direction magnitude stays commensurate with gamma*||g||.
    assert float(jnp.linalg.norm(d_vec)) < 1e3 * float(jnp.linalg.norm(g))


def test_vmapped_lanes_never_go_nonfinite():
    """The 4096-lane blowup scenario, shrunk: all lanes stay finite and the
    worst lane ends at a sane objective."""
    p = get_problem("rosenbrock")
    vg = make_value_and_grad(p.f, p.grad)
    cfg = LBFGSConfig(line_search="backtracking",
                      direction="compact_incremental", ls_eval="direct",
                      fidelity="fixed", max_iters=120, tol=0.0)
    rng = np.random.default_rng(42)
    x0s = jnp.asarray(rng.uniform(-2.0, 2.0, (256, 256)), jnp.float32)

    @jax.jit
    def run(x0s):
        def one(x0):
            return solve_from_state(cfg, p.f, vg,
                                    init_state(vg, x0, cfg.m), p.dir_poly)
        return jax.vmap(one)(x0s)

    out = run(x0s)
    f = np.asarray(out.f)
    assert np.all(np.isfinite(f))
    assert float(np.max(f)) < 1e6


def test_nonfinite_step_freezes_lane():
    """A step that sends f to inf must freeze the state with
    LINE_SEARCH_FAILED rather than poisoning subsequent iterations."""
    calls = jnp.asarray(0)  # noqa: F841 - documentation only

    def f(x):
        # Smooth near 0, overflows for |x| > ~30 in f32.
        return jnp.sum(jnp.exp(x * x) - 1.0)

    grad = jax.grad(f)
    vg = lambda x: (f(x), grad(x))
    # Start far out: the first steepest-descent trial overflows f32.
    x0 = jnp.full((8,), 8.0, jnp.float32)
    cfg = LBFGSConfig(line_search="backtracking", fidelity="reference",
                      max_iters=50, tol=1e-6, direction="compact")
    out = solve_from_state(cfg, f, vg, init_state(vg, x0, cfg.m))
    assert bool(jnp.isfinite(out.f)) or int(out.status) == Status.LINE_SEARCH_FAILED


# -----------------------------------------------------------------------------
# Sanitizer mode (SURVEY.md §5: the XLA analogue of compute-sanitizer)
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("ls,direction", [
    ("backtracking", "compact_incremental"),
    ("wolfe_interpolation", "compact"),
    ("backtracking_speculative", "two_loop"),
])
def test_solver_is_nan_free_under_debug_nans(ls, direction):
    """jax_debug_nans aborts the moment ANY op produces a NaN; the solver's
    clean path (guarded rho/gamma divisions, masked skips, branchless
    freezes) must never rely on transient NaNs.  This is the sanitizer run
    the reference has no analogue of (it hand-fences CUDA streams instead —
    SURVEY.md §5 race-detection row)."""
    p = get_problem("rosenbrock")
    vg = make_value_and_grad(p.f, p.grad)
    x0 = jnp.asarray(np.random.default_rng(7).uniform(-2, 2, 1024),
                     jnp.float32)
    c2 = 0.9 if ls == "wolfe_interpolation" else 0.7
    cfg = LBFGSConfig(line_search=ls, direction=direction, max_iters=40,
                      tol=1e-6, c2=c2)
    jax.config.update("jax_debug_nans", True)
    try:
        out = solve_from_state(cfg, p.f, vg, init_state(vg, x0, cfg.m))
        assert bool(jnp.isfinite(out.f))
    finally:
        jax.config.update("jax_debug_nans", False)


def test_cli_debug_nans_flag():
    """--debug-nans enables the config flag and the solve still completes."""
    from tpu_lbfgs.cli import main

    jax.config.update("jax_debug_nans", False)
    try:
        rc = main(["--problem", "quadratic", "--dim", "256", "--max-iters",
                   "20", "--device", "cpu", "--debug-nans", "--json"])
        assert rc == 0
        assert jax.config.jax_debug_nans
    finally:
        jax.config.update("jax_debug_nans", False)


def test_refresh_interval_zero_rejected():
    """refresh_interval=0 would make the segmented solve's inner loop unable
    to advance k -> infinite outer while_loop (device hang); rejected at
    config construction.  'never' is spelled None."""
    with pytest.raises(ValueError, match="refresh_interval"):
        LBFGSConfig(direction="compact_incremental", refresh_interval=0)
    LBFGSConfig(refresh_interval=1)
    LBFGSConfig(refresh_interval=None)


def test_accurate_dots_fused_tail_pairing():
    """accurate_dots silently replaced by per-block accumulation was exactly
    the giant-d corruption it exists to prevent: a PLAIN fused tail under
    cfg.accurate_dots is still a trace-time error; accurate_dots=True tails
    and the bare use_pallas path (compensated iteration_tail) run."""
    from tpu_lbfgs import Status, minimize
    from tpu_lbfgs.problems.suite import fused_tail_for
    p = get_problem("rosenbrock")
    x0 = jnp.full((256,), 1.5, jnp.float32)
    tail = fused_tail_for("rosenbrock", with_matvec=False)
    with pytest.raises(ValueError, match="accurate_dots"):
        minimize(p.f, x0, LBFGSConfig(accurate_dots=True, max_iters=5),
                 grad=p.grad, fused_tail=tail)
    # Compensated pairings run end-to-end (semantics pinned in
    # tests/test_kernels.py::test_accurate_dots_composes_with_fused_tail_solver).
    r = minimize(p.f, x0,
                 LBFGSConfig(accurate_dots=True, use_pallas=True, max_iters=5,
                             tol=0.0),
                 grad=p.grad)
    assert int(r.iterations) == 5 and int(r.status) == Status.MAX_ITERS
    tail_c = fused_tail_for("rosenbrock", with_matvec=False,
                            accurate_dots=True)
    r2 = minimize(p.f, x0, LBFGSConfig(accurate_dots=True, max_iters=5,
                                       tol=0.0),
                  grad=p.grad, fused_tail=tail_c)
    assert int(r2.iterations) == 5
