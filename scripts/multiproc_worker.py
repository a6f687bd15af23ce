#!/usr/bin/env python
"""One process of a real multi-process ``jax.distributed`` job (CPU backend).

Launched by run_multiproc.py (N processes on this host, localhost
coordinator, 4 virtual CPU devices each).  This executes the full
multi-process code path a multi-host GPU job runs — ``multihost.initialize`` with an
explicit coordinator, a global mesh spanning BOTH processes' devices,
cross-process collectives, and a sharded solve through the public
``sharded_minimize`` API — and asserts the result matches this process's own
single-process (unsharded) solve.

The reference has no distributed story at all (SURVEY.md §2: no NCCL/MPI
anywhere); this is the from-scratch communication layer's end-to-end
execution evidence.

Usage (see run_multiproc.py):
    multiproc_worker.py <process_id> <num_processes> <coordinator> <out.json>
"""
import json
import os
import sys

# 4 virtual CPU devices per process; must precede backend init.
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4")

import jax  # noqa: E402

# config.update after import pins the CPU backend whatever JAX_PLATFORMS says.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402


def main() -> int:
    pid, nproc = int(sys.argv[1]), int(sys.argv[2])
    coordinator, out_path = sys.argv[3], sys.argv[4]

    from tpu_lbfgs import LBFGSConfig, Status, get_problem, minimize
    from tpu_lbfgs.dist import multihost, sharded_minimize

    # --- bootstrap: the code under test (dist/multihost.py:58) --------------
    multihost.initialize(coordinator_address=coordinator,
                         num_processes=nproc, process_id=pid,
                         cpu_collectives="gloo")
    assert jax.process_count() == nproc, jax.process_count()
    assert jax.process_index() == pid, jax.process_index()
    n_dev = len(jax.devices())
    n_local = len(jax.local_devices())
    assert n_dev == nproc * n_local, (n_dev, n_local)
    assert multihost.is_coordinator() == (pid == 0)

    # --- explicit cross-process collective ----------------------------------
    mesh = multihost.global_mesh()
    expected = float(sum(range(n_dev)))
    psum_val = jax.jit(jax.shard_map(
        lambda: jnp.zeros((1,))
        + lax.psum(lax.axis_index("d").astype(jnp.float64), "d"),
        mesh=mesh, in_specs=(), out_specs=P("d"), check_vma=False))()
    got = float(np.asarray(psum_val.addressable_shards[0].data)[0])
    assert got == expected, (got, expected)

    # --- sharded checkpoint across the process boundary ---------------------
    # Each process writes ONLY its addressable shards; the restore rebuilds
    # the cross-process state with no host gather (io.checkpoint sharded
    # layout).  This is the multi-host checkpoint story executed for real.
    import tempfile

    from tpu_lbfgs.core.solver import init_state, make_value_and_grad
    from tpu_lbfgs.dist.mesh import state_shardings
    from tpu_lbfgs.io import load_state_sharded, save_state_sharded

    ck_dir = os.path.join(tempfile.gettempdir(),
                          f"tpu_lbfgs_mp_ck_{coordinator.split(':')[-1]}")
    pq = get_problem("quadratic")
    vgq = make_value_and_grad(pq.f, pq.grad)
    st_sh = state_shardings(mesh)
    make = jax.jit(lambda x: init_state(vgq, x, 5), out_shardings=st_sh)
    # d scales with the job so the (R, 128) history rows divide the mesh.
    x0q = jax.device_put(np.linspace(-1.0, 1.0, 128 * 8 * n_dev),
                         jax.sharding.NamedSharding(mesh, P("d")))
    st = make(x0q)
    # save_state_sharded is collective in multi-process jobs: it barriers
    # internally so every shard file is durable before process 0 publishes
    # index.json, and again before returning — no caller-side sync needed.
    save_state_sharded(ck_dir, st)
    st2 = load_state_sharded(ck_dir, mesh)
    from jax.experimental import multihost_utils
    for f_name in ("x", "g", "s_hist"):
        a = getattr(st, f_name).addressable_shards
        b = getattr(st2, f_name).addressable_shards
        for sa, sb in zip(a, b):
            np.testing.assert_array_equal(np.asarray(sa.data),
                                          np.asarray(sb.data))
    multihost_utils.sync_global_devices("ckpt-verified")

    # --- sharded solve over the global (cross-process) mesh -----------------
    # d=1024 divides exactly over the 8 global shards (no padding path).
    p = get_problem("coupled_quadratic")
    cfg = LBFGSConfig(max_iters=200, tol=1e-8, direction="compact")
    x0 = np.random.default_rng(42).uniform(-1.0, 1.0, 1024)
    res = sharded_minimize(p.f, x0, cfg, mesh=mesh, grad=p.grad)
    f_sharded = float(res.f)
    iters_sharded = int(res.iterations)
    assert int(res.status) == Status.CONVERGED, int(res.status)

    # Reference: the same solve unsharded, locally in this same process.
    ref = minimize(p.f, jnp.asarray(x0), cfg, grad=p.grad)
    f_ref = float(ref.f)
    assert int(ref.status) == Status.CONVERGED
    # Reduction order differs between the sharded and local programs; the
    # converged objective agrees to fp64 reduction-reordering tolerance.
    assert abs(f_sharded - f_ref) <= 1e-9 * max(1.0, abs(f_ref)), \
        (f_sharded, f_ref)
    assert abs(iters_sharded - int(ref.iterations)) <= 2, \
        (iters_sharded, int(ref.iterations))

    # This process's addressable shards of the solution match the local
    # solution's same slices (each shard is a contiguous d/n_dev chunk).
    x_ref = np.asarray(ref.x)
    chunk = x_ref.shape[0] // n_dev
    for shard in res.x.addressable_shards:
        lo = shard.index[0].start or 0
        np.testing.assert_allclose(np.asarray(shard.data),
                                   x_ref[lo:lo + chunk], atol=1e-7)

    record = {
        "process_id": pid,
        "num_processes": int(jax.process_count()),
        "global_devices": n_dev,
        "local_devices": n_local,
        "psum_axis_index": got,
        "mesh": {k: int(v) for k, v in mesh.shape.items()},
        "sharded": {"f": f_sharded, "iterations": iters_sharded,
                    "g_norm": float(res.g_norm), "status": int(res.status)},
        "local_reference": {"f": f_ref, "iterations": int(ref.iterations),
                            "g_norm": float(ref.g_norm)},
        "ok": True,
    }
    with open(out_path, "w") as fh:
        json.dump(record, fh, indent=1)
    print(f"proc {pid}: ok (f={f_sharded:.3e}, {iters_sharded} iters, "
          f"psum={got:.0f})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
