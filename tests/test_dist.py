"""Sharding tests on the 8-virtual-device CPU mesh (conftest sets
xla_force_host_platform_device_count=8): sharded results must equal the
unsharded ones, and the state must actually be distributed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_lbfgs import LBFGSConfig, Status, get_problem, minimize
from tpu_lbfgs.batch import vmap_minimize
from tpu_lbfgs.dist import (
    make_mesh,
    make_mesh_2d,
    sharded_minimize,
    sharded_vmap_minimize,
)


@pytest.fixture
def cpu_measure(monkeypatch):
    """Let the scaling harness run on the CPU mesh: its device check
    (harness.require_gpu) would refuse; these tests check the program and
    the bookkeeping, not a device number."""
    from tpu_lbfgs.bench import harness, scaling

    monkeypatch.setattr(scaling, "require_gpu", harness.device_record)


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "conftest should provide 8 CPU devices"
    return make_mesh()


@pytest.mark.parametrize("direction", ["two_loop", "compact"])
@pytest.mark.parametrize("strategy", ["backtracking", "wolfe_interpolation"])
def test_sharded_equals_unsharded(mesh, direction, strategy):
    p = get_problem("rosenbrock")
    d = 512  # divisible by 8
    x0 = jnp.asarray(np.random.default_rng(3).uniform(-2, 2, d))
    # Short window: psum partial-sum ordering differs from the single-pass
    # reduction, so parity is to tolerance, not bitwise, and branchy line
    # searches amplify ulp drift over long Rosenbrock trajectories
    # (SURVEY.md §7 reduction-order note).
    cfg = LBFGSConfig(line_search=strategy, direction=direction,
                      max_iters=12, tol=1e-6, c2=0.9)
    r_ref = minimize(p.f, x0, cfg, grad=p.grad)
    r_sh = sharded_minimize(p.f, x0, cfg, mesh=mesh, grad=p.grad)
    assert int(r_sh.iterations) == int(r_ref.iterations)
    np.testing.assert_allclose(float(r_sh.f), float(r_ref.f),
                               rtol=1e-7, atol=1e-10)
    np.testing.assert_allclose(np.asarray(r_sh.x), np.asarray(r_ref.x),
                               rtol=1e-5, atol=1e-8)


def test_sharded_full_convergence(mesh):
    """Long-horizon equivalence on a well-conditioned problem: the sharded
    solve converges to the same optimum in the same iteration count."""
    p = get_problem("coupled_quadratic")
    x0 = jnp.asarray(np.random.default_rng(30).uniform(-2, 2, 512))
    cfg = LBFGSConfig(line_search="wolfe_interpolation", max_iters=500,
                      tol=1e-8)
    r_ref = minimize(p.f, x0, cfg, grad=p.grad)
    r_sh = sharded_minimize(p.f, x0, cfg, mesh=mesh, grad=p.grad)
    assert int(r_ref.status) == Status.CONVERGED
    assert int(r_sh.status) == Status.CONVERGED
    assert abs(int(r_sh.iterations) - int(r_ref.iterations)) <= 1
    assert abs(float(r_sh.f) - float(r_ref.f)) < 1e-12


def test_sharded_uneven_dimension(mesh):
    """d not divisible by the mesh: XLA pads shards internally."""
    p = get_problem("coupled_quadratic")
    d = 500  # 500 % 8 != 0
    x0 = jnp.asarray(np.random.default_rng(4).uniform(-1, 1, d))
    cfg = LBFGSConfig(line_search="wolfe_interpolation", max_iters=200, tol=1e-8)
    r_ref = minimize(p.f, x0, cfg, grad=p.grad)
    r_sh = sharded_minimize(p.f, x0, cfg, mesh=mesh, grad=p.grad)
    assert int(r_sh.status) == Status.CONVERGED
    np.testing.assert_allclose(float(r_sh.f), float(r_ref.f),
                               rtol=1e-8, atol=1e-12)


def test_sharded_polynomial_ls_unpadded_dir_poly(mesh):
    """Regression: dir_poly must see the UNPADDED (x, d).  With d % mesh != 0
    the padded Rosenbrock chain gains an a-dependent crossing term at the pad
    boundary (100*(0 - x_{d-1}^2)^2) that corrupts the line-search polynomial
    — silent trajectory divergence (f=1315 vs 557 after 15 iterations at
    d=500 before the fix) while the direct line search agreed to 1e-5."""
    p = get_problem("rosenbrock")
    d = 500  # pads on the 8-way mesh
    x0 = jnp.asarray(np.random.default_rng(13).uniform(-2, 2, d))
    cfg = LBFGSConfig(line_search="backtracking", ls_eval="polynomial",
                      max_iters=15, tol=0.0)
    r_ref = minimize(p.f, x0, cfg, grad=p.grad, dir_poly=p.dir_poly)
    r_sh = sharded_minimize(p.f, x0, cfg, mesh=mesh, grad=p.grad,
                            dir_poly=p.dir_poly)
    np.testing.assert_allclose(float(r_sh.f), float(r_ref.f), rtol=1e-4)

    mesh2 = make_mesh_2d(batch_size=2)
    x0s = jnp.asarray(np.random.default_rng(14).uniform(-2, 2, (2, d)))
    res_sh = sharded_vmap_minimize(p.f, x0s, cfg, mesh=mesh2, grad=p.grad,
                                   dir_poly=p.dir_poly)
    for i in range(2):
        r1 = minimize(p.f, x0s[i], cfg, grad=p.grad, dir_poly=p.dir_poly)
        np.testing.assert_allclose(float(res_sh.f[i]), float(r1.f), rtol=1e-4)


def test_state_actually_sharded(mesh):
    """The returned x must live sharded across all 8 devices."""
    p = get_problem("quadratic")
    x0 = jnp.zeros(256, jnp.float64)
    cfg = LBFGSConfig(max_iters=20, tol=1e-10)
    r = sharded_minimize(p.f, x0, cfg, mesh=mesh, grad=p.grad)
    assert len(r.x.sharding.device_set) == 8
    assert not r.x.sharding.is_fully_replicated


def test_vmap_minimize_batch():
    p = get_problem("rosenbrock")
    rng = np.random.default_rng(5)
    x0s = jnp.asarray(rng.uniform(-2, 2, (16, 32)))
    cfg = LBFGSConfig(line_search="wolfe_interpolation", max_iters=2000,
                      tol=1e-5, c2=0.9)
    res = vmap_minimize(p.f, x0s, cfg, grad=p.grad)
    assert res.f.shape == (16,)
    assert np.all(np.asarray(res.status) == Status.CONVERGED)
    assert np.all(np.asarray(res.g_norm) < 1e-5)
    # Lanes reach either the global minimum (f=0) or Rosenbrock's local
    # minimum near x_1 = -1 (f ~ 3.9866) — both are legitimate.
    fs = np.asarray(res.f)
    assert np.all((fs < 1e-7) | (np.abs(fs - 3.98662385) < 1e-3))
    # Lanes converge at different iteration counts -> per-lane freezing works.
    assert len(set(np.asarray(res.iterations).tolist())) > 1


def test_vmap_matches_single():
    p = get_problem("coupled_quadratic")
    rng = np.random.default_rng(6)
    x0s = jnp.asarray(rng.uniform(-1, 1, (4, 48)))
    cfg = LBFGSConfig(max_iters=300, tol=1e-8)
    res_b = vmap_minimize(p.f, x0s, cfg, grad=p.grad)
    for i in range(4):
        r1 = minimize(p.f, x0s[i], cfg, grad=p.grad)
        assert int(res_b.iterations[i]) == int(r1.iterations)
        np.testing.assert_allclose(float(res_b.f[i]), float(r1.f),
                                   rtol=1e-9, atol=1e-13)


def test_sharded_vmap_2d_mesh():
    """Full 2-D parallelism: 2-way batch x 4-way vector sharding."""
    mesh2 = make_mesh_2d(batch_size=2)
    p = get_problem("rosenbrock")
    rng = np.random.default_rng(7)
    x0s = jnp.asarray(rng.uniform(-2, 2, (4, 64)))
    cfg = LBFGSConfig(line_search="backtracking", max_iters=500, tol=1e-4)
    res = sharded_vmap_minimize(p.f, x0s, cfg, mesh=mesh2, grad=p.grad)
    res_ref = vmap_minimize(p.f, x0s, cfg, grad=p.grad)
    np.testing.assert_allclose(np.asarray(res.f), np.asarray(res_ref.f),
                               rtol=1e-6, atol=1e-9)
    assert np.all(np.asarray(res.status) == Status.CONVERGED)
    # Hundreds of branchy iterations: reduction-order drift may flip a few
    # line-search branches, shifting convergence by a handful of iterations.
    assert np.all(np.abs(np.asarray(res.iterations, np.int64)
                         - np.asarray(res_ref.iterations, np.int64)) <= 10)


def test_batched_problem_params():
    """Per-instance problem parameters (not in the reference at all)."""
    rng = np.random.default_rng(8)
    targets = jnp.asarray(rng.uniform(-1, 1, (6, 24)))

    def f(x, t):
        r = x - t
        return jnp.sum(r * r)

    def g(x, t):
        return 2.0 * (x - t)

    x0s = jnp.zeros((6, 24), jnp.float64)
    cfg = LBFGSConfig(max_iters=50, tol=1e-10)
    res = vmap_minimize(f, x0s, cfg, grad=g, problem_params=targets)
    assert np.all(np.asarray(res.status) == Status.CONVERGED)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(targets),
                               atol=1e-8)


def test_scaling_sweep_on_virtual_mesh(cpu_measure):
    """Strong-scaling harness runs on the 8-virtual-CPU mesh and produces
    consistent results (no real speedup expected — the 'devices' share one
    physical CPU; this validates program + bookkeeping, not performance)."""
    from tpu_lbfgs.bench.scaling import scaling_sweep
    cfg = LBFGSConfig(line_search="backtracking", direction="compact")
    rows = scaling_sweep(problem="coupled_quadratic", d=1024, iters=5,
                         cfg=cfg, device_counts=[1, 8],
                         dtype=__import__("jax.numpy", fromlist=["x"]).float64)
    assert [r["n_devices"] for r in rows] == [1, 8]
    for r in rows:
        assert np.isfinite(r["final_f"])
        assert r["iters_per_s"] > 0
    assert rows[0]["efficiency"] == 1.0


def test_bench_sharded_explicit_pallas_unsupported_problem_falls_back(
        cpu_measure):
    """use_pallas=True for a problem without a shard-composable fused tail
    (or a non-f32 dtype) must warn and bench the jnp-shard path, not
    KeyError inside shardmap_fused_vg."""
    import jax.numpy as jnp

    from tpu_lbfgs.bench.scaling import bench_sharded
    cfg = LBFGSConfig(line_search="backtracking", direction="compact")
    with pytest.warns(RuntimeWarning, match="no sharded fused tail"):
        row = bench_sharded("sphere", d=1024, iters=3, cfg=cfg, n_devices=2,
                            dtype=jnp.float32, repeats=1, use_pallas=True)
    assert row["stack"] == "jnp-shard"
    assert np.isfinite(row["final_f"])


def test_bench_sharded_single_device_pallas_unsupported_warns(cpu_measure):
    """n_devices == 1 with use_pallas=True for a non-FUSED_VG problem: the
    fused helpers fall back to jnp, so the row must warn and be labeled
    jnp — not report the fallback as 'fused-unsharded'."""
    import jax.numpy as jnp

    from tpu_lbfgs.bench.scaling import bench_sharded
    cfg = LBFGSConfig(line_search="backtracking", direction="compact")
    with pytest.warns(RuntimeWarning, match="no fused tail"):
        row = bench_sharded("sphere", d=1024, iters=3, cfg=cfg, n_devices=1,
                            dtype=jnp.float32, repeats=1, use_pallas=True)
    assert row["stack"] == "jnp-shard"
    assert np.isfinite(row["final_f"])


def test_bench_sharded_with_matvec_stack_label(cpu_measure):
    """The tail-matvec configuration is reachable and labeled from
    bench_sharded."""
    import jax.numpy as jnp

    from tpu_lbfgs.bench.scaling import bench_sharded
    cfg = LBFGSConfig(line_search="backtracking",
                      direction="compact_incremental", ls_eval="polynomial")
    row = bench_sharded("coupled_quadratic", d=128 * 8 * 8 * 2, iters=4,
                        cfg=cfg, n_devices=8, dtype=jnp.float32, repeats=1,
                        use_pallas=True, with_matvec=True)
    assert row["stack"] == "fused-shard+matvec"
    assert np.isfinite(row["final_f"])


@pytest.mark.parametrize("problem", ["rosenbrock", "coupled_quadratic",
                                     "quadratic"])
def test_shardmap_vg_matches_reference(mesh, problem):
    """Explicit shard_map + halo ppermute + psum vg == the plain objective."""
    from tpu_lbfgs.dist.shardmap_vg import shardmap_value_and_grad
    p = get_problem(problem)
    d = 512
    x = jnp.asarray(np.random.default_rng(11).uniform(-2, 2, d))
    vg = shardmap_value_and_grad(problem, mesh)
    xs = jax.device_put(x, jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec("d")))
    f_sm, g_sm = jax.jit(vg)(xs)
    np.testing.assert_allclose(float(f_sm), float(p.f(x)), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(g_sm), np.asarray(p.grad(x)),
                               rtol=1e-10, atol=1e-12)


def test_shardmap_vg_drives_solver(mesh):
    """The shard_map vg plugs into sharded_minimize as value_and_grad."""
    from tpu_lbfgs.dist.shardmap_vg import shardmap_value_and_grad
    p = get_problem("coupled_quadratic")
    d = 512
    x0 = jnp.asarray(np.random.default_rng(12).uniform(-1, 1, d))
    vg = shardmap_value_and_grad("coupled_quadratic", mesh)
    cfg = LBFGSConfig(max_iters=100, tol=1e-8)
    r = sharded_minimize(p.f, x0, cfg, mesh=mesh, value_and_grad=vg)
    r_ref = minimize(p.f, x0, cfg, grad=p.grad)
    assert int(r.status) == Status.CONVERGED
    assert abs(float(r.f) - float(r_ref.f)) < 1e-10


def test_vmap_minimize_record_trace():
    """Regression: cfg.record_trace in the batched solver used to run the
    full-length traced scan and then DROP the trace (res.trace was None);
    now the per-lane trace comes back batched."""
    p = get_problem("coupled_quadratic")
    x0s = jnp.asarray(np.random.default_rng(9).uniform(-1, 1, (3, 48)))
    cfg = LBFGSConfig(max_iters=40, tol=1e-8, record_trace=True)
    res = vmap_minimize(p.f, x0s, cfg, grad=p.grad)
    assert res.trace is not None
    assert res.trace.f.shape == (3, 40)
    # trace prefix matches the per-lane single solve
    r1 = minimize(p.f, x0s[0], cfg, grad=p.grad)
    k = int(r1.iterations)
    np.testing.assert_allclose(np.asarray(res.trace.f[0, :k]),
                               np.asarray(r1.trace.f[:k]), rtol=1e-10)
