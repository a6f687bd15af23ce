"""Sharded solves: the parameter vector and curvature history partitioned
over the device mesh, reductions finished by XLA-inserted psums.

Design (SURVEY.md §7 layer 5): the solver core is written in plain jnp ops on
whole arrays; this layer only places data.  Under jit with sharded
in/out specs, the SPMD partitioner turns every ``jnp.vdot`` into a local
partial dot + all-reduce, every axpy into purely local work, and the
``compact`` direction's (2m, d) contraction into ONE all-reduce of a
(2m, m+1) block per iteration — compare the reference's per-scalar cuBLAS
Ddot round-trips (L-BFGS.cu:219-274).
"""
from __future__ import annotations

import warnings
from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import LBFGSConfig
from ..core.solver import (
    _solve_traced,
    _state_to_result,
    init_state,
    make_value_and_grad,
    resolve_history_dtype,
    solve_bounded,
    solve_from_state,
)
from ..types import SolveResult
from .mesh import make_mesh, result_shardings, state_shardings
from .pallas_sharded import (
    SHARDED_PALLAS_PROBLEMS,
    shardmap_fused_tail,
    shardmap_fused_vg,
)


def _pad_for_mesh(f, vg, x0, n_shards: int, mult: Optional[int] = None,
                  dir_poly=None):
    """Zero-pad x0 to a multiple of ``mult`` (default 128 * n_shards) and
    wrap the objective to ignore the padding.  Padded coordinates have
    exactly zero gradient, so they never move and the padded solve is
    step-for-step identical to the original (the line search, history, and
    all reductions see zeros there).

    ``dir_poly`` (optional) is wrapped the same way — it must see the
    UNPADDED (x, d): chain objectives like Rosenbrock have an a-dependent
    crossing term at the pad boundary (100*(0 - (x_{d-1}+a*p_{d-1})^2)^2)
    that would corrupt the line-search polynomial even though the padded
    coordinates themselves never move.

    The 128 factor keeps the history in its (m, R, 128) layout
    (types.hist_block) with the row-block axis R divisible by the mesh, so
    the (d,) shards and the history R-shards cover identical element ranges.
    """
    d = x0.shape[-1]
    if mult is None:
        mult = 128 * n_shards
    d_pad = ((d + mult - 1) // mult) * mult
    if d_pad == d:
        return f, vg, x0, d, dir_poly
    pad = d_pad - d
    zeros = jnp.zeros(x0.shape[:-1] + (pad,), x0.dtype)
    x0p = jnp.concatenate([x0, zeros], axis=-1)

    def f_p(x):
        return f(x[..., :d])

    def vg_p(x):
        val, g = vg(x[..., :d])
        return val, jnp.concatenate(
            [g, jnp.zeros(g.shape[:-1] + (pad,), g.dtype)], axis=-1)

    dir_poly_p = None
    if dir_poly is not None:
        def dir_poly_p(x, p, *a, **kw):
            return dir_poly(x[..., :d], p[..., :d], *a, **kw)

    return f_p, vg_p, x0p, d, dir_poly_p


def _resolve_shard_local(cfg: LBFGSConfig, d_pad: int, n_shards: int,
                         dtype, with_matvec, batch_local: int = 1):
    """Resolve history_dtype="auto" and with_matvec="auto" on the PER-DEVICE
    footprint: d_local = d_pad / n_shards on the vector axis, times
    ``batch_local`` lanes (instance batch / batch-axis mesh size on a 2-D
    (b, d) mesh) — each device holds its own (batch_local, 2, m, d_local)
    ring slice, so any size rule keys on that, not on the global d.
    Returns (cfg-with-concrete-history-dtype, with_matvec bool)."""
    from ..problems.suite import auto_with_matvec

    d_local = d_pad // n_shards
    hdtype = resolve_history_dtype(cfg.history_dtype, cfg.m, d_local, dtype,
                                   batch=batch_local)
    cfg = cfg.replace(history_dtype=hdtype)
    if with_matvec == "auto":
        # The tail's matvecs (t1 = S@y_new, t2 = Y@y_new) are consumed only
        # by the incremental-products direction; elsewhere they would be
        # pure wasted bandwidth.
        with_matvec = (cfg.direction == "compact_incremental"
                       and auto_with_matvec(cfg.m, d_local, hdtype,
                                            batch=batch_local))
    return cfg, bool(with_matvec)


def sharded_minimize(f: Callable, x0, cfg: LBFGSConfig = LBFGSConfig(),
                     mesh: Optional[Mesh] = None, grad=None,
                     value_and_grad=None, d_axis: str = "d",
                     dir_poly=None, problem: Optional[str] = None,
                     with_matvec="auto") -> SolveResult:
    """Single-instance solve with x, g, and the (m, d) history sharded on the
    vector axis across the mesh.  Dimensions not divisible by the mesh are
    transparently zero-padded (exactly equivalent — see _pad_for_mesh).

    ``problem``: optional suite-problem name.  With ``cfg.use_pallas`` and an
    f32 x0, the solve then runs the fused tail PER SHARD inside shard_map
    (dist.pallas_sharded; the Triton kernel on the GPU).  Without a problem
    name the tail cannot shard (the kernel is a single-device program; XLA
    would materialize full gathers around it), so the solve falls back to
    the auto-partitioned jnp path with a warning.

    ``with_matvec``: compute the incremental-products history matvecs in
    the fused tail (one packed psum finishes them); "auto" resolves through
    problems.suite.auto_with_matvec on the per-shard footprint.  Only
    meaningful on the shard_map tail path.
    """
    mesh = mesh if mesh is not None else make_mesh(axis_name=d_axis)
    vg = make_value_and_grad(f, grad, value_and_grad)

    n_shards = int(mesh.shape[d_axis])
    x0 = jnp.asarray(x0)
    fused_tail = None
    phi_batch = None
    phi_dphi_batch = None
    pallas_shard = (cfg.use_pallas and n_shards > 1
                    and problem in SHARDED_PALLAS_PROBLEMS
                    and x0.dtype == jnp.float32)
    if n_shards > 1 and cfg.use_pallas and not pallas_shard:
        warnings.warn(
            "sharded_minimize: use_pallas=True has no shard-composable "
            "fused tail for this objective (pass problem=<suite name> with f32 "
            "x0 to enable the shard_map Pallas path); falling back to the "
            "auto-partitioned jnp path.", stacklevel=2)
        cfg = cfg.replace(use_pallas=False)

    if pallas_shard:
        f, vg, x0_arr, d_orig, dir_poly = _pad_for_mesh(
            f, vg, x0, n_shards, dir_poly=dir_poly)
        cfg, wm = _resolve_shard_local(cfg, x0_arr.shape[-1], n_shards,
                                       x0_arr.dtype, with_matvec)
        # Shard-local evaluation replaces both the objective interface and
        # the iteration tail; the in-loop jnp ops (direction algebra,
        # line-search scalars) stay auto-partitioned.
        vg = shardmap_fused_vg(problem, mesh, d_orig, d_axis)
        fused_tail = shardmap_fused_tail(problem, mesh, d_orig, d_axis,
                                         with_matvec=wm,
                                         accurate_dots=cfg.accurate_dots)
    else:
        f, vg, x0_arr, d_orig, dir_poly = _pad_for_mesh(
            f, vg, x0, n_shards, dir_poly=dir_poly)
        cfg, _ = _resolve_shard_local(cfg, x0_arr.shape[-1], n_shards,
                                      x0_arr.dtype, False)

    st_sh = state_shardings(mesh, d_axis)
    x_sh = NamedSharding(mesh, P(d_axis))
    x0 = jax.device_put(x0_arr, x_sh)

    @partial(jax.jit, out_shardings=st_sh)
    def make_state(x0):
        return init_state(vg, x0, cfg.m, cfg.history_dtype)

    trace_len = cfg.max_iters if cfg.record_trace else None
    res_sh = result_shardings(mesh, d_axis, trace_len=trace_len)

    @partial(jax.jit, in_shardings=(st_sh,), out_shardings=res_sh)
    def run(state):
        if cfg.record_trace:
            out, trace = _solve_traced(cfg, f, vg, state, dir_poly,
                                       fused_tail, phi_batch, phi_dphi_batch)
            return _state_to_result(out, trace)
        out = solve_from_state(cfg, f, vg, state, dir_poly, fused_tail,
                               phi_batch, phi_dphi_batch)
        return _state_to_result(out, None)

    res = run(make_state(x0))
    if res.x.shape[-1] != d_orig:
        # Slice under jit so the unpadded result stays distributed (an eager
        # slice of a sharded array gathers to replicated).
        out_sh = NamedSharding(mesh, P(d_axis)) \
            if d_orig % n_shards == 0 else None
        slicer = jax.jit(lambda v: v[:d_orig], out_shardings=out_sh)
        res = res._replace(x=slicer(res.x))
    return res


def sharded_vmap_minimize(f: Callable, x0_batch,
                          cfg: LBFGSConfig = LBFGSConfig(),
                          mesh: Optional[Mesh] = None, grad=None,
                          value_and_grad=None, batch_axis: str = "b",
                          d_axis: str = "d", dir_poly=None,
                          problem: Optional[str] = None,
                          with_matvec="auto",
                          lockstep: str = "while") -> SolveResult:
    """Batched AND sharded: instance batch split over the DP-like mesh axis,
    each instance's vector split over the d axis.  This is the full 2-D
    parallelism story (dp x tp analogue) for the optimizer.

    ``lockstep``: "bounded" runs every instance for the full max_iters
    budget cond-free (batch.vmapped semantics — skips the vmapped
    while_loop's per-iteration lane masking); "while" (default) freezes
    lanes as they finish.

    ``problem``: as in sharded_minimize — with ``cfg.use_pallas``, an f32
    batch, and a suite problem name, the per-shard fused tail runs inside
    shard_map, batched over the instance axis via
    ``jax.vmap(..., spmd_axis_name=batch_axis)`` (the vmapped shard_map's
    in/out specs gain the batch axis; a pallas_call batches into an extra
    grid dimension).  Otherwise the auto-partitioned jnp path runs, with a
    warning when the fused tail was requested but cannot compose.
    """
    if mesh is None:
        raise ValueError("sharded_vmap_minimize requires an explicit 2-D mesh "
                         "(make_mesh_2d)")
    if lockstep not in ("while", "bounded"):
        raise ValueError(f"lockstep must be 'while' or 'bounded', "
                         f"got {lockstep!r}")
    if lockstep == "bounded" and cfg.record_trace:
        raise ValueError("lockstep='bounded' is incompatible with "
                         "cfg.record_trace (the traced scan freezes "
                         "finished lanes); trace with lockstep='while'")
    vg = make_value_and_grad(f, grad, value_and_grad)

    n_shards = int(mesh.shape[d_axis])
    x0_batch = jnp.asarray(x0_batch)
    fused_tail = None
    phi_dphi_batch = None
    pallas_shard = (cfg.use_pallas and n_shards > 1
                    and problem in SHARDED_PALLAS_PROBLEMS
                    and x0_batch.dtype == jnp.float32)
    if n_shards > 1 and cfg.use_pallas and not pallas_shard:
        warnings.warn(
            "sharded_vmap_minimize: use_pallas=True has no shard-composable "
            "fused tail for this objective (pass problem=<suite name> with f32 "
            "x0 to enable the shard_map Pallas path); falling back to the "
            "auto-partitioned jnp path.", stacklevel=2)
        cfg = cfg.replace(use_pallas=False)

    phi_batch = None
    # Per-device lane count: the instance batch splits over the mesh's batch
    # axis; residency rules see what one device actually holds.
    batch_local = -(-x0_batch.shape[0] // int(mesh.shape[batch_axis]))
    if pallas_shard:
        f, vg, x0_batch, d_orig, dir_poly = _pad_for_mesh(
            f, vg, x0_batch, n_shards, dir_poly=dir_poly)
        cfg, wm = _resolve_shard_local(cfg, x0_batch.shape[-1], n_shards,
                                       x0_batch.dtype, with_matvec,
                                       batch_local=batch_local)
        vg = shardmap_fused_vg(problem, mesh, d_orig, d_axis)
        fused_tail = shardmap_fused_tail(problem, mesh, d_orig, d_axis,
                                         with_matvec=wm,
                                         accurate_dots=cfg.accurate_dots)
    else:
        f, vg, x0_batch, d_orig, dir_poly = _pad_for_mesh(
            f, vg, x0_batch, n_shards, dir_poly=dir_poly)
        cfg, _ = _resolve_shard_local(cfg, x0_batch.shape[-1], n_shards,
                                      x0_batch.dtype, False,
                                      batch_local=batch_local)

    # spmd_axis_name: shards every vmapped shard_map's batch dimension on the
    # mesh's batch axis (a no-op for the plain-jnp path, whose partitioning
    # the out_shardings already pin).
    vmap_kw = {"spmd_axis_name": batch_axis} if pallas_shard else {}

    st_sh = state_shardings(mesh, d_axis, batch_axis=batch_axis)
    x_sh = NamedSharding(mesh, P(batch_axis, d_axis))
    x0_batch = jax.device_put(x0_batch, x_sh)
    trace_len = cfg.max_iters if cfg.record_trace else None
    res_sh = result_shardings(mesh, d_axis, batch_axis=batch_axis,
                              trace_len=trace_len)

    @partial(jax.jit, out_shardings=st_sh)
    def make_states(x0s):
        return jax.vmap(lambda x: init_state(vg, x, cfg.m, cfg.history_dtype),
                        **vmap_kw)(x0s)

    @partial(jax.jit, in_shardings=(st_sh,), out_shardings=res_sh)
    def run(states):
        def one(state):
            if cfg.record_trace:
                out, trace = _solve_traced(cfg, f, vg, state, dir_poly,
                                           fused_tail, phi_batch,
                                           phi_dphi_batch)
                return _state_to_result(out, trace)
            solve = solve_bounded if lockstep == "bounded" \
                else solve_from_state
            out = solve(cfg, f, vg, state, dir_poly, fused_tail,
                        phi_batch, phi_dphi_batch)
            return _state_to_result(out, None)

        return jax.vmap(one, **vmap_kw)(states)

    res = run(make_states(x0_batch))
    if res.x.shape[-1] != d_orig:
        out_sh = NamedSharding(mesh, P(batch_axis, d_axis)) \
            if d_orig % n_shards == 0 else None
        slicer = jax.jit(lambda v: v[..., :d_orig], out_shardings=out_sh)
        res = res._replace(x=slicer(res.x))
    return res
