"""Batched L-BFGS: thousands of independent problem instances per chip.

The reference has no batch story at all (SURVEY.md §2 parallelism inventory:
"Batch parallelism over problem instances: Absent") — each run optimizes one
vector.  Here the whole solver is a pure state->state map, so ``jax.vmap``
lifts it wholesale: the while_loop condition becomes "any lane still running"
and JAX freezes finished lanes automatically (their body results are
select-ed away), which is exactly the per-lane convergence masking SURVEY.md
§7 calls for.  Target workload: 4096 independent d=1e3 instances per chip
(BASELINE.json config 4).
"""
from __future__ import annotations

from functools import lru_cache
from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax import Array

from ..config import LBFGSConfig
from ..core.solver import (
    _solve_traced,
    _state_to_result,
    init_state,
    make_value_and_grad,
    solve_bounded,
    solve_from_state,
)
from ..types import SolveResult


def _solve_one(cfg, fp, vg, x0, dp, lockstep="while"):
    state = init_state(vg, x0, cfg.m, cfg.history_dtype)
    if cfg.record_trace:
        out, trace = _solve_traced(cfg, fp, vg, state, dp)
        return _state_to_result(out, trace)
    if lockstep == "bounded":
        out = solve_bounded(cfg, fp, vg, state, dp)
    else:
        out = solve_from_state(cfg, fp, vg, state, dp)
    return _state_to_result(out, None)


@lru_cache(maxsize=128)
def _compiled_vmap_run(cfg: LBFGSConfig, f, grad, value_and_grad, dir_poly,
                       with_params: bool, lockstep: str = "while"):
    """Jitted batched-solve factory, cached on the configuration and the
    callables' identities (same pattern as core.solver._compiled_run):
    sweep loops calling vmap_minimize repeatedly with stable function
    references hit jax's compilation cache instead of paying the full
    batched-solver compile per call."""
    if with_params:
        def run_one(x0, params):
            fp = lambda x: f(x, params)
            gp = (lambda x: grad(x, params)) if grad is not None else None
            vgp = (lambda x: value_and_grad(x, params)) \
                if value_and_grad is not None else None
            vg = make_value_and_grad(fp, gp, vgp)
            dp = (lambda x, d: dir_poly(x, d, params)) if dir_poly else None
            return _solve_one(cfg, fp, vg, x0, dp, lockstep)
    else:
        vg = make_value_and_grad(f, grad, value_and_grad)

        def run_one(x0):
            return _solve_one(cfg, f, vg, x0, dir_poly, lockstep)

    return jax.jit(jax.vmap(run_one))


def vmap_minimize(f: Callable, x0_batch: Array,
                  cfg: LBFGSConfig = LBFGSConfig(),
                  grad=None, value_and_grad=None,
                  problem_params: Optional[Array] = None,
                  dir_poly=None, lockstep: str = "while") -> SolveResult:
    """Solve B independent instances in lockstep on one chip.

    Args:
      f: objective ``f(x)`` — or ``f(x, params)`` when ``problem_params`` is
         given (params batched along axis 0, one pytree leaf row per lane).
      x0_batch: (B, d) starting points.
      problem_params: optional per-instance parameters.

    Returns a SolveResult whose leaves carry a leading batch axis
    (including a per-lane trace when cfg.record_trace — NOTE the traced
    formulation runs all cfg.max_iters scan steps, as in minimize()).

    lockstep: "while" (default) freezes each lane the moment it finishes —
    the vmapped while_loop, whose lane masking costs a full-state select per
    iteration; "bounded" runs every lane for exactly cfg.max_iters cond-free
    iterations (solve_bounded: no per-iteration lane masking; failed
    lanes identical, early-converging lanes keep polishing past tol).

    cfg.history_dtype="auto" resolves on the TOTAL batched footprint
    (resolve_history_dtype gets the batch size), not the per-instance ring.

    Repeat calls with the same cfg and stable callable references reuse the
    compiled batched program.
    """
    if lockstep not in ("while", "bounded"):
        raise ValueError(f"lockstep must be 'while' or 'bounded', "
                         f"got {lockstep!r}")
    if lockstep == "bounded" and cfg.record_trace:
        # The traced scan freezes lanes at convergence (while semantics);
        # silently dropping the requested bounded polish would return
        # different f/x than the untraced bounded run.
        raise ValueError("lockstep='bounded' is incompatible with "
                         "cfg.record_trace (the traced scan freezes "
                         "finished lanes); trace with lockstep='while'")
    x0_batch = jnp.asarray(x0_batch)
    if cfg.history_dtype == "auto":
        # Resolve OUTSIDE the vmapped trace (where only the (d,) slice is
        # visible) so the residency rule sees the batch dimension; the
        # resolved concrete dtype keys the compilation cache as usual.
        from ..core.solver import resolve_history_dtype

        cfg = cfg.replace(history_dtype=resolve_history_dtype(
            "auto", cfg.m, x0_batch.shape[-1], x0_batch.dtype,
            batch=x0_batch.shape[0]))
    run = _compiled_vmap_run(cfg, f, grad, value_and_grad, dir_poly,
                             problem_params is not None, lockstep)
    if problem_params is not None:
        return run(x0_batch, problem_params)
    return run(x0_batch)
