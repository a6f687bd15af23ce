"""Drop-in ``scipy.optimize.minimize``-style entry point.

Users coming from the reference (or from SciPy's L-BFGS-B, which the
reference's experiment notebook compares against) get the familiar
signature; the solve itself is the jitted on-device solver.

    from tpu_lbfgs.scipy_compat import minimize
    res = minimize(f, x0, jac=grad, options={"maxiter": 500, "gtol": 1e-5})
    res.x, res.fun, res.nit, res.success

Differences from SciPy: bound constraints are not supported (the reference
implements plain L-BFGS, not L-BFGS-B); ``jac=None`` uses jax.grad (exact,
not finite differences).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import jax.numpy as jnp
import numpy as np

from .config import LBFGSConfig
from .core.solver import minimize as _minimize
from .types import Status


@dataclass
class OptimizeResult:
    """Mirrors scipy.optimize.OptimizeResult's common fields."""
    x: np.ndarray
    fun: float
    jac: Optional[np.ndarray]
    nfev: int
    njev: int
    nit: int
    status: int
    success: bool
    message: str
    extra: dict = field(default_factory=dict)

    def __getitem__(self, key: str) -> Any:   # scipy allows dict access
        return getattr(self, key)


_MESSAGES = {
    Status.CONVERGED: "CONVERGENCE: GRADIENT NORM BELOW GTOL",
    Status.MAX_ITERS: "STOP: TOTAL NO. of ITERATIONS REACHED LIMIT",
    Status.LINE_SEARCH_FAILED: "ABNORMAL TERMINATION IN LNSRCH",
}


def minimize(fun: Callable, x0, args=(), method: str = "tpu-lbfgs",
             jac: Optional[Callable] = None, tol: Optional[float] = None,
             options: Optional[dict] = None,
             config: Optional[LBFGSConfig] = None) -> OptimizeResult:
    """SciPy-shaped wrapper around the on-device solver.

    options: maxiter (default 1000), gtol (||g|| tolerance, default 1e-5),
    maxcor (history depth m, default 10), linesearch (any
    config.LINE_SEARCH_METHODS name), plus any LBFGSConfig field by name.
    ``config`` overrides everything when given.
    """
    if method.lower() not in ("tpu-lbfgs", "l-bfgs", "lbfgs", "l-bfgs-b"):
        # "l-bfgs-b" is accepted for drop-in migration (bounds unsupported —
        # the reference implements plain L-BFGS).
        raise ValueError(f"unsupported method {method!r}")
    opts = dict(options or {})
    if config is None:
        cfg_kw = dict(
            max_iters=int(opts.pop("maxiter", 1000)),
            tol=float(opts.pop("gtol", tol if tol is not None else 1e-5)),
            m=int(opts.pop("maxcor", 10)),
            line_search=opts.pop("linesearch", "backtracking"),
            fidelity=opts.pop("fidelity", "fixed"),
        )
        # Remaining keys: forward real LBFGSConfig fields; warn-and-ignore
        # anything else (SciPy's own behavior for unknown options) so
        # standard L-BFGS-B options like ftol/maxfun/maxls/eps/disp don't
        # crash a drop-in migration.
        import dataclasses
        import warnings

        known = {f.name for f in dataclasses.fields(LBFGSConfig)}
        unknown = sorted(k for k in opts if k not in known)
        if unknown:
            warnings.warn(
                f"tpu-lbfgs ignores unsupported options: {unknown} "
                f"(no L-BFGS-B bound/ftol semantics — plain L-BFGS, "
                f"gradient-norm stopping)", RuntimeWarning, stacklevel=2)
        cfg_kw.update({k: v for k, v in opts.items() if k in known})
        config = LBFGSConfig(**cfg_kw)

    # SciPy's jac=True idiom: fun returns (f, grad).  jac=False means
    # finite differences in SciPy; here jax.grad (exact) is the equivalent.
    value_and_grad = None
    if jac is True:
        value_and_grad, fun, jac = fun, None, None
    elif jac is False:
        jac = None
    elif isinstance(jac, str):
        # SciPy's finite-difference specs ('2-point', '3-point', 'cs'):
        # exact autodiff is the equivalent here, same as jac=None/False.
        import warnings

        warnings.warn(
            f"jac={jac!r} requests finite differences; using exact jax.grad "
            f"instead", RuntimeWarning, stacklevel=2)
        jac = None

    if args:
        if value_and_grad is not None:
            base_vg = value_and_grad
            value_and_grad = lambda x: base_vg(x, *args)
        else:
            base_f, base_j = fun, jac
            fun = lambda x: base_f(x, *args)
            jac = (lambda x: base_j(x, *args)) if base_j else None

    if value_and_grad is not None and fun is None:
        fun = lambda x: value_and_grad(x)[0]

    res = _minimize(fun, jnp.asarray(x0), config, grad=jac,
                    value_and_grad=value_and_grad)
    status = int(res.status)
    return OptimizeResult(
        x=np.asarray(res.x),
        fun=float(res.f),
        jac=None,
        nfev=int(res.n_fev),
        njev=int(res.n_gev),
        nit=int(res.iterations),
        status=status,
        success=status == Status.CONVERGED,
        message=_MESSAGES.get(status, Status.NAMES.get(status, "unknown")),
        extra={"g_norm": float(res.g_norm)},
    )
