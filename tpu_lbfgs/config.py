"""Solver configuration.

The reference configures everything at compile time via constexpr headers
(`sequential-implementation/config.h:4-17`, `parallel-implementation/constants.h:4-21`)
plus hardcoded driver parameters. Here a single hashable frozen dataclass carries the
full configuration so it can be a static argument to ``jax.jit`` — changing a field
recompiles exactly the affected program, nothing else.

Reference constants mirrored (with their CPU/GPU discrepancies made explicit):
  C1 = 1e-4                     (both config.h:5 and constants.h:5)
  C2 = 0.9 sequential (config.h:6) vs 0.7 parallel (constants.h:6); the parallel
       backtracking-Wolfe bisection re-hardcodes 0.9 locally
       (parallel-implementation/line_search.cpp:54)
  INITIAL_STEP_SIZE = 1.0, BACKTRACKING_ALPHA = 0.5, BACKTRACKING_TOL = 1e-8
  WOLFE_INTERP_MIN = 1e-10, WOLFE_INTERP_MAX = 10.0
"""
from __future__ import annotations

import dataclasses
from typing import Optional

# Reference constants (see module docstring for provenance).
C1_DEFAULT = 1e-4
C2_SEQUENTIAL = 0.9
C2_PARALLEL = 0.7
INITIAL_STEP_SIZE = 1.0
BACKTRACKING_SHRINK = 0.5
BACKTRACKING_TOL = 1e-8
WOLFE_INTERP_MIN = 1e-10
WOLFE_INTERP_MAX = 10.0

LINE_SEARCH_METHODS = (
    "backtracking",
    "backtracking_speculative",
    "backtracking_wolfe",
    "backtracking_wolfe_speculative",
    "backtracking_wolfe_bisect",
    "armijo_interpolation",
    "wolfe_interpolation",
    "wolfe_interpolation_speculative",
)

DIRECTION_METHODS = ("two_loop", "compact", "compact_incremental")

# Fidelity modes: "reference" replicates the reference's exact decision rules,
# including its documented quirks (SURVEY.md §7 "fidelity traps"); "fixed" uses
# the textbook-correct variants.
FIDELITY_MODES = ("reference", "fixed")


@dataclasses.dataclass(frozen=True)
class LBFGSConfig:
    """Static configuration for the L-BFGS solver.

    Hashable so the whole config can be a `static_argnum` of jit: every distinct
    config compiles its own specialized XLA program (no dynamic dispatch on-device).
    """

    # History depth; the reference uses m=10 everywhere (main.cpp:51, L-BFGS.cu:400).
    m: int = 10
    max_iters: int = 1000
    # Convergence tolerance on ||g||_2 (lbfgs.cpp:80-84). Reference drivers use
    # 1e-8 (CPU, main.cpp:52) and 1e-1 (GPU, L-BFGS-Backtracking.cu:446).
    tol: float = 1e-5

    # --- line search -----------------------------------------------------------
    line_search: str = "backtracking"
    c1: float = C1_DEFAULT
    c2: float = C2_SEQUENTIAL
    initial_step: float = INITIAL_STEP_SIZE
    shrink: float = BACKTRACKING_SHRINK
    grow: float = 1.1  # backtracking_wolfe step-growth factor (line_search.cpp:46)
    backtracking_tol: float = BACKTRACKING_TOL
    interp_min: float = WOLFE_INTERP_MIN
    interp_max: float = WOLFE_INTERP_MAX
    # Interpolation / Wolfe searches cap at 20 trials (line_search.cpp:72,143).
    ls_max_iters: int = 20
    # The sequential backtracking_wolfe has NO iteration cap in the reference
    # (line_search.cpp:33-55) and can in principle cycle; a jitted while_loop
    # needs a bound, so we add a generous safety cap (documented deviation).
    ls_safety_cap: int = 256
    # Alpha floor local to the parallel bisection Wolfe search
    # (parallel-implementation/line_search.cpp:57).
    bisect_tol: float = 1e-10
    # Strong-Wolfe interpolation: True uses the guarded safeCubicInterpolate
    # (parallel line_search.cpp:231-296); False the raw cubic the sequential
    # implementation uses (sequential line_search.cpp:8-12), which can NaN.
    safe_cubic: bool = True
    # "reference" fidelity replicates the sign-flipped Armijo rule
    # (line_search.cpp:24) and the parallel implementations' alpha floor rescue
    # (return 0.5 when alpha underflows; parallel line_search.cpp:38-41).
    fidelity: str = "reference"
    # Rescue floor used by the parallel implementation's backtracking/interp
    # searches; None disables (sequential behavior).
    alpha_rescue_floor: Optional[float] = None
    alpha_rescue_value: float = 0.5

    # --- direction -------------------------------------------------------------
    # "two_loop": lax.scan two-loop recursion (reference-parity semantics).
    # "compact":  Byrd–Nocedal–Schnabel compact representation: two (m,d)
    #             contraction passes + O(m^2) triangular solves, one fused
    #             reduction per phase when sharded.
    # "compact_incremental": compact with the history products (S'Y, Y'Y,
    #             S'g, Y'g) maintained across iterations from gradient
    #             differences and small-matrix identities — the direction's
    #             only (m,d)-sized work is the final combine, roughly halving
    #             history traffic.  fp drift accumulates in the off-diagonal
    #             products; diagonals stay exact.
    direction: str = "two_loop"
    # compact_incremental only: every ~K iterations, recompute SY/YY/Sg/Yg
    # from the stored history (solver.refresh_products), bounding the
    # additive f32 drift in the off-diagonal products.  Implemented as
    # CHUNKED while_loop segments with the recompute BETWEEN segments
    # (solve_from_state), so the contractions cost ~2m/K extra passes
    # amortized and no conditional sits in the per-iteration loop (see
    # tests/test_refresh.py for the drift bound this buys).
    # None (default) is fine for typical runs: the no-cancellation
    # incremental updates (u1 = S@y_new directly) plus the curvature
    # pair-skip keep every observed f32 workload finite
    # (tests/test_robustness.py).  Under record_trace the bounded scan is
    # segmented the same way (solver._solve_traced), so traced diagnostics
    # run the identical algorithm.
    refresh_interval: Optional[int] = None
    # When set, the two-loop individually skips pairs with sy <= threshold —
    # the GPU reference's behavior (L-BFGS.cu:222-223, threshold 1e-10).  When
    # None, any non-finite rho aborts the whole direction to steepest descent —
    # the CPU reference's behavior (lbfgs.cpp:102-107).
    pair_skip_threshold: Optional[float] = None
    # Curvature threshold for accepting an (s,y) pair. CPU reference: sy > 0
    # (lbfgs.cpp:182); GPU reference skips pairs with sy <= 1e-10 inside the
    # two-loop instead (L-BFGS.cu:222-223).
    curvature_threshold: float = 0.0
    # Powell damping (N&W eq. 18.15, with B0 = I/gamma as is standard for
    # L-BFGS): instead of REJECTING a low-curvature pair (the reference's
    # only option), blend y_bar = theta*y + (1-theta)*B0 s whenever
    # s.y < damping * s.B0 s, guaranteeing s.y_bar >= damping * s.B0 s > 0 —
    # every step then contributes curvature information.  Typical value 0.2;
    # None (default) keeps exact reference semantics.  Composes with every
    # stack (jnp, Pallas, fused tail, sharded): the blend is applied to the
    # RAW tail outputs post-kernel — blended scalars are algebraic in the
    # raw reductions, the only array work is one ring-row blend, and the
    # incremental Sg/Yg products advance with the raw gradient difference
    # (two extra S@s/Y@s contractions build the damped SY/YY column).
    # Activations counted in Guard.DAMPED.  Extension beyond the reference —
    # no oracle parity.
    damping: Optional[float] = None
    # The solver bails when the line search returns alpha below this
    # (lbfgs.cpp:164-168).
    step_fail_tol: float = 1e-10
    # Candidate-batch width for line_search="backtracking_speculative": the
    # whole ladder alpha0 * shrink^[0..spec_width) is evaluated in ONE batched
    # phi call per round.  The reference's paper describes evaluating
    # "multiple step sizes in parallel" but its code never implements it
    # (cuda_lbfgs.pdf §II vs the serial loop at L-BFGS-Backtracking.cu:314-341);
    # here the ladder is one vmapped evaluation.  The accepted alpha is
    # bit-identical to sequential backtracking.
    spec_width: int = 8

    # How line searches evaluate phi(alpha) = f(x + alpha*d):
    #   "direct"     — evaluate f (and grad for Wolfe) at each trial point;
    #                  exact reference semantics.
    #   "polynomial" — expand phi as a closed-form polynomial in alpha whose
    #                  coefficients are fused reductions over (x, d) computed
    #                  ONCE per line search (Problem.dir_poly required); every
    #                  trial is then O(1) scalar work and phi' is exact with
    #                  zero gradient evaluations.  Mathematically identical,
    #                  fp-tolerance parity.
    ls_eval: str = "direct"

    # --- execution -------------------------------------------------------------
    # Run the fused iteration tail (kernels.tail: a Triton kernel on the
    # GPU, its XLA twin elsewhere) where the caller provides it: the bench
    # harness, the CLI's --pallas and the sharded solves build it for f32
    # suite problems.
    use_pallas: bool = False
    # Store the (m, d) curvature history in bfloat16 (compute stays f32):
    # halves the direction phase's memory traffic.  The curvature scalars
    # sy/yy are computed in full precision BEFORE the cast, so the
    # update/skip decisions are unaffected; the direction itself becomes
    # slightly approximate (quasi-Newton methods tolerate inexact H well —
    # expect a few % more iterations).  None = same dtype as x.
    # "auto" is resolved per solve by core.solver.resolve_history_dtype
    # (currently the input dtype; ROADMAP S5).
    history_dtype: Optional[str] = None  # None | "bfloat16" | "auto"
    # Compensated (Neumaier) reductions for the curvature-pair scalars
    # (s.y, y.y, ||g||^2) — recovers f32 bits lost to partial-sum rounding at
    # very large d without f64 arithmetic (utils/accurate.py).  The fused
    # tail compensates its cross-block sum of per-block partials; a
    # fused_tail must be built with accurate_dots=True (fused_tail_for) or
    # the solver raises.
    accurate_dots: bool = False
    # Record per-iteration trace (f, ||g||, alpha, evals) — uses a bounded scan.
    record_trace: bool = False

    def __post_init__(self):
        if self.line_search not in LINE_SEARCH_METHODS:
            raise ValueError(
                f"unknown line_search {self.line_search!r}; "
                f"expected one of {LINE_SEARCH_METHODS}"
            )
        if self.direction not in DIRECTION_METHODS:
            raise ValueError(
                f"unknown direction {self.direction!r}; "
                f"expected one of {DIRECTION_METHODS}"
            )
        if self.fidelity not in FIDELITY_MODES:
            raise ValueError(
                f"unknown fidelity {self.fidelity!r}; expected one of {FIDELITY_MODES}"
            )
        if self.ls_eval not in ("direct", "polynomial"):
            raise ValueError(
                f"unknown ls_eval {self.ls_eval!r}; expected 'direct' or "
                "'polynomial'")
        if self.m <= 0:
            raise ValueError("history depth m must be positive")
        if self.refresh_interval is not None and self.refresh_interval < 1:
            # refresh_interval=0 would make solve_from_state's inner segment
            # unable to advance k -> the outer while_loop spins forever (a
            # device hang inside jit); "never refresh" is spelled None.
            raise ValueError(
                f"refresh_interval must be >= 1 or None (got "
                f"{self.refresh_interval!r})")
        if self.damping is not None and not (0.0 < self.damping < 1.0):
            raise ValueError(
                f"damping must be in (0, 1) or None (got {self.damping!r})")
        if self.history_dtype not in (None, "bfloat16", "float32", "auto"):
            raise ValueError(
                f"unknown history_dtype {self.history_dtype!r}; expected "
                "None, 'bfloat16', 'float32', or 'auto'")

    def replace(self, **kw) -> "LBFGSConfig":
        return dataclasses.replace(self, **kw)


# Config matching the reference's sequential driver (main.cpp:24-58).
REFERENCE_SEQUENTIAL = LBFGSConfig(
    m=10, max_iters=15000, tol=1e-8, line_search="backtracking", c2=C2_SEQUENTIAL,
)

# Config matching the reference's GPU drivers (e.g. L-BFGS-Backtracking.cu:429-457):
# loose tol, per-pair curvature skip inside the two-loop (L-BFGS.cu:222-223),
# C2=0.7, and the alpha floor rescue.
REFERENCE_PARALLEL = LBFGSConfig(
    m=10, max_iters=50000, tol=1e-1, line_search="backtracking", c2=C2_PARALLEL,
    alpha_rescue_floor=1e-4, pair_skip_threshold=1e-10,
)
