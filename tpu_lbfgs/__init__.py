"""tpu-lbfgs: an L-BFGS optimization framework whose whole solve runs on the
accelerator.

JAX/XLA/Pallas implementation with the capabilities of the CUDA/C++
reference ``ndzajic1/cuda-lbfgs`` (see SURVEY.md): the whole solve runs
inside one jitted while_loop (no per-iteration host round-trips beyond the
loop predicate), batches of independent instances vmap on one device, and
the parameter vector & curvature history shard across device meshes with
psum reductions.
"""

from .config import (
    LBFGSConfig,
    REFERENCE_PARALLEL,
    REFERENCE_SEQUENTIAL,
)
from .core.solver import (
    init_state,
    iterate,
    make_value_and_grad,
    minimize,
    finalize_result,
    make_solve_segment,
    refresh_products,
    solve_bounded,
    solve_from_state,
)
from .problems.suite import (
    Problem,
    fused_tail_for,
    fused_value_and_grad,
    get_problem,
    multi_phi_dphi_for,
    multi_phi_for,
    problem_names,
    reference_x0,
    register_problem,
)
from .types import Guard, LBFGSState, LineSearchResult, SolveResult, Status, Trace

__version__ = "0.1.0"

__all__ = [
    "LBFGSConfig",
    "REFERENCE_PARALLEL",
    "REFERENCE_SEQUENTIAL",
    "LBFGSState",
    "LineSearchResult",
    "SolveResult",
    "Status",
    "Guard",
    "Trace",
    "Problem",
    "fused_tail_for",
    "fused_value_and_grad",
    "get_problem",
    "multi_phi_dphi_for",
    "multi_phi_for",
    "problem_names",
    "reference_x0",
    "register_problem",
    "init_state",
    "iterate",
    "minimize",
    "make_value_and_grad",
    "finalize_result",
    "make_solve_segment",
    "refresh_products",
    "solve_bounded",
    "solve_from_state",
    "__version__",
]
