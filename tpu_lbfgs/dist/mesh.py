"""Device-mesh construction and sharding specs for the solver state.

The reference is single-process single-GPU (no NCCL/MPI anywhere — SURVEY.md
§2 distributed inventory); this layer is designed from scratch: a named mesh
over the devices, the parameter vector / gradient / history sharded on the ``d`` axis,
and every dot-product reduction compiled by XLA's SPMD partitioner into a
local partial + psum.  The solver core stays annotation-free — sharding is
applied at the jit boundary via in/out shardings, the idiomatic pjit recipe.

Axes:
  "d"  — the parameter-vector axis (the TP/SP-like partition of optimizer
         state; SURVEY.md §5: "the d-axis becomes the sharded axis").
  "b"  — optional instance-batch axis (the DP-like axis) for sharded+batched
         solves.
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..types import LBFGSState, SolveResult, Trace


def make_mesh(devices: Optional[Sequence] = None,
              axis_name: str = "d") -> Mesh:
    """1-D mesh over all (or the given) devices for vector-axis sharding."""
    devices = jax.devices() if devices is None else list(devices)
    return Mesh(np.asarray(devices), (axis_name,))


def make_mesh_2d(batch_size: int, devices: Optional[Sequence] = None,
                 axis_names: tuple[str, str] = ("b", "d")) -> Mesh:
    """2-D (batch, vector) mesh: batch_size devices on the DP-like axis, the
    rest on the vector axis."""
    devices = jax.devices() if devices is None else list(devices)
    n = len(devices)
    if n % batch_size != 0:
        raise ValueError(f"{n} devices not divisible by batch axis {batch_size}")
    arr = np.asarray(devices).reshape(batch_size, n // batch_size)
    return Mesh(arr, axis_names)


def state_shardings(mesh: Mesh, d_axis: str = "d",
                    batch_axis: Optional[str] = None) -> LBFGSState:
    """Pytree of NamedShardings matching LBFGSState.

    x, g: (d,) sharded on d_axis; history (m, R, L) sharded on the row-block
    axis R (R-blocks of 128 elements partition d contiguously, exactly
    aligned with the (d,) chunks); all scalars and (m,)/(m, m) ring metadata
    replicated.  With batch_axis set, every leaf gains a leading batch
    dimension sharded on that axis.
    """
    b = (batch_axis,) if batch_axis else ()

    def sh(*spec):
        return NamedSharding(mesh, P(*b, *spec))

    vec = sh(d_axis)
    hist = sh(None, d_axis, None)
    scalar = sh()
    small = sh(None)
    small2 = sh(None, None)
    return LBFGSState(
        x=vec, f=scalar, g=vec, g_norm=scalar,
        s_hist=hist, y_hist=hist, sy_hist=small, yy_hist=small,
        SY=small2, YY=small2, Sg=small, Yg=small,
        n_pairs=scalar, k=scalar, status=scalar, alpha=scalar,
        n_fev=scalar, n_gev=scalar, guards=small)


def result_shardings(mesh: Mesh, d_axis: str = "d",
                     batch_axis: Optional[str] = None,
                     trace_len: Optional[int] = None) -> SolveResult:
    b = (batch_axis,) if batch_axis else ()

    def sh(*spec):
        return NamedSharding(mesh, P(*b, *spec))

    trace = None
    if trace_len is not None:
        trace = Trace(f=sh(None), g_norm=sh(None), alpha=sh(None),
                      n_fev=sh(None), n_gev=sh(None), guards=sh(None, None))
    return SolveResult(x=sh(d_axis), f=sh(), g_norm=sh(), iterations=sh(),
                       status=sh(), n_fev=sh(), n_gev=sh(), trace=trace,
                       guards=sh(None))
