"""Multi-process bootstrap for jobs that span several hosts or processes.

The reference has no multi-device story at all; this is the from-scratch
communication layer of SURVEY.md §2: ``jax.distributed`` for process
bootstrap, one global mesh spanning all processes' devices, the same
sharded solve program in every process (SPMD); XLA hands the collectives
to the backend's library (NCCL between GPUs).  The GPUs of one host are
joined all to all, so the mesh follows the algorithm alone.

The 8-virtual-device CPU tests (tests/test_multihost.py) and the
multi-process CPU driver (scripts/run_multiproc.py) validate the program.
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh


def _multihost_intent() -> Optional[str]:
    """Environment evidence that this process is PART OF a multi-process
    job: a configured coordinator.  When it exists, an auto-detection
    failure is a broken bootstrap — not a benign plain-single-host case —
    and must propagate: swallowing it would silently degrade the job to N
    independent single-host solves."""
    import os

    for var in ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS"):
        if os.environ.get(var):
            return var
    return None


def _launcher_size_hint() -> Optional[str]:
    """Generic launcher-size vars (SLURM/MPI/PMI task counts).  These prove
    the LAUNCHER started multiple tasks, not that the tasks intend a shared
    JAX pod — an embarrassingly-parallel array job of N independent
    single-host solves sets them too.  Evidence for a WARNING, never for
    failing the run."""
    import os

    for var in ("SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE", "PMI_SIZE"):
        v = os.environ.get(var, "")
        if v.isdigit() and int(v) > 1:
            return f"{var}={v}"
    return None


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               cpu_collectives: Optional[str] = None) -> None:
    """Initialize the multi-host runtime.

    With no arguments, relies on jax's cluster auto-detection via the
    environment (a no-op on a plain single host, where auto-detection finds
    nothing and jax raises about the missing coordinator — that specific
    case is suppressed, UNLESS the environment shows this process belongs
    to a multi-process job, in which case the failure is a real broken
    bootstrap and propagates).  With explicit coordinator arguments, any failure is
    REAL (wrong address, port clash, process-count mismatch) and
    propagates; calling twice is idempotent.

    cpu_collectives: cross-process collectives implementation for the CPU
    backend ("gloo" or "mpi") — required for a multi-process CPU job (GPUs
    use NCCL and ignore this).  Exercised end-to-end by
    scripts/run_multiproc.py.
    """
    if jax.distributed.is_initialized():
        return
    if cpu_collectives is not None:
        jax.config.update("jax_cpu_collectives_implementation",
                          cpu_collectives)
    if coordinator_address is None and num_processes is None:
        try:
            jax.distributed.initialize()
        except (RuntimeError, ValueError) as e:
            # Only the single-host-without-coordinator case is benign; it
            # presents as "couldn't auto-detect" / missing-arguments errors.
            msg = str(e).lower()
            benign = ("coordinator_address" in msg or "auto" in msg
                      or "unable to detect" in msg
                      or "already initialized" in msg
                      or "must be defined" in msg
                      # Backend already live (some computation ran first):
                      # nothing to coordinate on a single host — a no-op.
                      # With an EXPLICIT coordinator this same error is real
                      # (too-late initialize) and takes the propagating
                      # branch below instead.
                      or "before any jax calls" in msg)
            intent = _multihost_intent()
            if benign and intent is not None:
                raise RuntimeError(
                    f"multi-host bootstrap failed but the environment says "
                    f"this process is part of a multi-host job ({intent}); "
                    f"refusing to silently degrade to an independent "
                    f"single-host run") from e
            if not benign:
                raise
            hint = _launcher_size_hint()
            if hint is not None:
                # Could be an N-task job missing its coordinator vars OR an
                # intentional array job of independent solves — warn, do not
                # fail (a job with a coordinator var DOES fail above).
                import warnings

                warnings.warn(
                    f"jax.distributed auto-detection found no coordinator "
                    f"but {hint} says the launcher started multiple tasks; "
                    f"continuing as an independent single-host run (pass "
                    f"explicit coordinator_address/num_processes/process_id "
                    f"if these tasks should form one job)", RuntimeWarning,
                    stacklevel=2)
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_mesh(axis_name: str = "d",
                devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over every device in the job (all processes), in
    ``jax.devices()`` order."""
    devices = list(jax.devices()) if devices is None else list(devices)
    return Mesh(np.asarray(devices), (axis_name,))


def global_mesh_2d(batch_size: int, axis_names: tuple[str, str] = ("b", "d"),
                   devices: Optional[Sequence] = None) -> Mesh:
    """2-D (batch, vector) mesh over all processes' devices, in
    ``jax.devices()`` order."""
    devices = list(jax.devices()) if devices is None else list(devices)
    n = len(devices)
    if n % batch_size != 0:
        raise ValueError(
            f"{n} devices not divisible by batch axis {batch_size}")
    shape = (batch_size, n // batch_size)
    return Mesh(np.asarray(devices).reshape(shape), axis_names)


def is_coordinator() -> bool:
    return jax.process_index() == 0


def process_count() -> int:
    return jax.process_count()
