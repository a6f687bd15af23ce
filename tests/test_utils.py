"""Compensated reductions and the roofline traffic model."""
import jax.numpy as jnp
import numpy as np

from tpu_lbfgs.config import LBFGSConfig
from tpu_lbfgs.utils import compensated_dot, traffic_model


def test_compensated_dot_beats_plain_f32():
    """Adversarial case: large cancelling values + small signal."""
    rng = np.random.default_rng(0)
    n = 1 << 16
    big = rng.normal(size=n) * 1e6
    small = rng.normal(size=n)
    a64 = big + small
    b64 = rng.normal(size=n)
    exact = float(np.dot(a64, b64))

    a32 = jnp.asarray(a64, jnp.float32)
    b32 = jnp.asarray(b64, jnp.float32)
    plain = float(jnp.vdot(a32, b32))
    comp = float(compensated_dot(a32, b32))
    # The compensated result must be at least as close to the f64 truth.
    assert abs(comp - exact) <= abs(plain - exact) + 1e-3 * abs(exact)


def test_compensated_dot_matches_exact_small():
    a = jnp.asarray([1.0, 2.0, 3.0], jnp.float32)
    b = jnp.asarray([4.0, 5.0, 6.0], jnp.float32)
    assert float(compensated_dot(a, b)) == 32.0


def test_compensated_dot_f64_agrees():
    rng = np.random.default_rng(1)
    a = jnp.asarray(rng.normal(size=10000))
    b = jnp.asarray(rng.normal(size=10000))
    assert np.isclose(float(compensated_dot(a, b)),
                      float(jnp.vdot(a, b)), rtol=1e-12)


def test_traffic_model_sanity():
    cfg = LBFGSConfig(direction="compact", ls_eval="polynomial", m=10)
    tm = traffic_model(cfg, d=1 << 20)
    assert tm.passes_direction > tm.passes_line_search
    assert tm.bytes_per_iter == tm.passes_total * (1 << 20) * 4
    kind = "NVIDIA H100 80GB HBM3"
    peak = tm.peak_iters_per_s(kind)
    assert 1000 < peak < 100000
    assert 0 < tm.roofline_fraction(peak * 0.5, kind) == 0.5
    # a device missing from the peak table is an error, not a default
    import pytest
    with pytest.raises(ValueError, match="no published peak"):
        tm.peak_iters_per_s("cpu")


def test_traffic_model_auto_history_matches_solver_rule():
    """history_dtype='auto' in the traffic model must mirror
    resolve_history_dtype (the input dtype at every size): f64 and f32 runs
    model a full-precision ring, an explicit bf16 ring halves history
    passes."""
    cfg = LBFGSConfig(direction="compact_incremental", ls_eval="polynomial",
                      m=10, history_dtype="auto")
    d = 1 << 24
    tm64 = traffic_model(cfg, d=d, dtype_bytes=8)
    tm64_full = traffic_model(cfg.replace(history_dtype=None), d=d,
                              dtype_bytes=8)
    assert tm64.passes_total == tm64_full.passes_total
    tm32 = traffic_model(cfg, d=d, dtype_bytes=4)
    tm32_full = traffic_model(cfg.replace(history_dtype=None), d=d,
                              dtype_bytes=4)
    assert tm32.passes_total == tm32_full.passes_total
    tm32_bf16 = traffic_model(cfg.replace(history_dtype="bfloat16"), d=d,
                              dtype_bytes=4)
    assert tm32_bf16.passes_total < tm32.passes_total


def test_accurate_dots_solver_path():
    from tpu_lbfgs import LBFGSConfig, Status, get_problem, minimize
    p = get_problem("coupled_quadratic")
    cfg = LBFGSConfig(max_iters=200, tol=1e-4, accurate_dots=True)
    r = minimize(p.f, jnp.full((1000,), 1.5, jnp.float32), cfg, grad=p.grad)
    assert int(r.status) == Status.CONVERGED


def test_time_to_tolerance_refined_reaches_1e5(monkeypatch):
    """The north-star metric path (BASELINE.json: time-to-||g||<=1e-5 at
    d~1e6): two-stage f32->f64 refinement must actually reach 1e-5 — below
    the f32 gradient-entry noise floor — with only a handful of f64
    iterations (superlinear local convergence from the f32 iterate)."""
    from tpu_lbfgs.bench import harness
    from tpu_lbfgs.bench.harness import time_to_tolerance_refined

    # The harness refuses to time anything but a GPU; this checks the
    # two-stage algorithm on the CPU, not a device number.
    monkeypatch.setattr(harness, "require_gpu", harness.device_record)
    for backend in ("native", "jax"):
        r = time_to_tolerance_refined(d=2048, max_iters=30_000,
                                      refine_iters=2_000,
                                      refine_backend=backend)
        assert r["status"] == "converged", (backend, r)
        assert r["g_norm"] <= 1e-5
        assert r["refine_iterations"] <= 100, (backend, r)


def test_batch_aware_residency_rules():
    """history_dtype='auto' and with_matvec='auto' take the batch size (the
    TOTAL footprint is what a size rule would key on) and currently resolve
    to the exact choice at every batch and size; explicit dtypes pass
    through."""
    import jax.numpy as jnp

    from tpu_lbfgs.core.solver import resolve_history_dtype
    from tpu_lbfgs.problems.suite import auto_with_matvec

    m = 10
    for d, batch in ((1024, 4096), (4096, 1024), (4096, 4), (1 << 26, 1)):
        assert resolve_history_dtype("auto", m, d, jnp.float32,
                                     batch=batch) is None
        assert not auto_with_matvec(m, d, None, batch=batch)
    assert resolve_history_dtype("auto", m, 4096, jnp.float64,
                                 batch=4096) is None
    assert resolve_history_dtype("bfloat16", m, 4096, jnp.float32,
                                 batch=4) == "bfloat16"
    assert resolve_history_dtype(None, m, 4096, jnp.float32) is None


def test_vmap_minimize_resolves_auto_by_batch():
    """vmap_minimize with history_dtype='auto' resolves through
    resolve_history_dtype with the batch size (an f32 ring today)."""
    import jax.numpy as jnp
    import numpy as np

    from tpu_lbfgs import LBFGSConfig, get_problem
    from tpu_lbfgs.batch.vmapped import _compiled_vmap_run, vmap_minimize
    from tpu_lbfgs.core.solver import resolve_history_dtype

    p = get_problem("quadratic")
    cfg = LBFGSConfig(max_iters=3, tol=0.0, history_dtype="auto")
    # Small batch: runs end-to-end, ring stays input dtype (f32).
    x0s = jnp.asarray(np.random.default_rng(0).uniform(-2, 2, (4, 1024)),
                      jnp.float32)
    r = vmap_minimize(p.f, x0s, cfg, grad=p.grad)
    assert r.x.dtype == jnp.float32
    # Large batch: assert the RESOLUTION (running B=1024 x d=4096 on CPU in
    # a test is wasteful; the resolver is exactly what vmap_minimize calls).
    assert resolve_history_dtype("auto", cfg.m, 4096, jnp.float32,
                                 batch=1024) is None


def test_traffic_model_batch_axis():
    """The batch axis scales bytes/iter (per-instance passes unchanged)."""
    from tpu_lbfgs import LBFGSConfig
    from tpu_lbfgs.utils.roofline import traffic_model

    cfg = LBFGSConfig(direction="compact_incremental", ls_eval="polynomial",
                      history_dtype="auto")
    one = traffic_model(cfg, d=1024)
    many = traffic_model(cfg, d=1024, batch=4096)
    assert many.batch == 4096
    assert many.passes_total == one.passes_total
    assert many.bytes_per_iter == 4096 * one.bytes_per_iter
    kind = "NVIDIA H100 80GB HBM3"
    assert many.peak_instance_iters_per_s(kind) \
        == many.peak_iters_per_s(kind) * 4096
