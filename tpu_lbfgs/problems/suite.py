"""Benchmark objective-function suite.

Re-implementation of the reference problem suite:
  - quadratic        sum (x_i - 1)^2            (parallel-implementation/functions.cpp:6-24)
  - rosenbrock       coupled chained Rosenbrock (functions.cpp:26-49,
                      sequential-implementation/benchmark.cpp:58-81)
  - coupled_quadratic dense quadratic with tridiagonal coupling, COEFFICIENT=1000
                      (sequential-implementation/benchmark.cpp:16-56)

Each problem provides a jit/vmap/grad-compatible ``f`` plus a hand-derived
analytic gradient kept as a cross-check against ``jax.grad`` (the reference
ships analytic gradients only; its GPU Rosenbrock gradient kernel in
benchmark.cu:30-48 is mathematically wrong and is deliberately NOT replicated —
SURVEY.md §2 item 20).

All functions are written with vectorized jnp ops (no Python loops over
coordinates), are dtype-polymorphic, and reduce with a single ``jnp.sum``
so XLA emits one fused reduction per evaluation.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax import Array


@dataclasses.dataclass(frozen=True)
class Problem:
    name: str
    f: Callable[[Array], Array]
    grad: Callable[[Array], Array]          # analytic gradient
    minimum_value: Optional[float] = None   # known f at the minimizer
    minimizer: Optional[Callable[[int, jnp.dtype], Array]] = None
    # Directional polynomial: coeffs c (ascending) with
    # f(x + a*d) = sum_k c[k] a^k, computed in ONE fused pass over (x, d).
    # Enables cfg.ls_eval="polynomial": every line-search trial becomes O(1)
    # scalar work and phi' is exact with no gradient evaluations — the
    # reference instead re-evaluates f on the host per trial
    # (L-BFGS-Backtracking.cu:322-327).
    dir_poly: Optional[Callable[[Array, Array], Array]] = None

    def value_and_grad(self, x: Array) -> tuple[Array, Array]:
        """f and analytic gradient in one call (one pass over x each)."""
        return self.f(x), self.grad(x)


# --- quadratic: sum (x_i - 1)^2 --------------------------------------------------

def quadratic_f(x: Array) -> Array:
    r = x - 1.0
    return jnp.sum(r * r)


def quadratic_grad(x: Array) -> Array:
    return 2.0 * (x - 1.0)


# --- chained Rosenbrock ----------------------------------------------------------

def rosenbrock_f(x: Array) -> Array:
    # sum_i 100 (x_{i+1} - x_i^2)^2 + (1 - x_i)^2 over i in [0, d-2]
    xi = x[:-1]
    xn = x[1:]
    t1 = xn - xi * xi
    t2 = 1.0 - xi
    return jnp.sum(100.0 * t1 * t1 + t2 * t2)


def rosenbrock_grad(x: Array) -> Array:
    # Each interior coordinate receives a contribution from term i (as x_i) and
    # term i-1 (as x_{i+1}); expressed as two shifted vector updates instead of
    # the reference's scalar accumulation loop (functions.cpp:38-49).
    xi = x[:-1]
    xn = x[1:]
    t2 = xn - xi * xi                       # x_{i+1} - x_i^2
    g = jnp.zeros_like(x)
    g = g.at[:-1].add(2.0 * (xi - 1.0) - 400.0 * xi * t2)
    g = g.at[1:].add(200.0 * t2)
    return g


# --- coupled quadratic (tridiagonal), COEFFICIENT = 1000 -------------------------

COUPLED_COEFFICIENT = 1000.0


def coupled_quadratic_f(x: Array, coeff: float = COUPLED_COEFFICIENT) -> Array:
    # coeff * sum x_i^2 + (coeff/10) * sum x_i x_{i+1}
    return coeff * jnp.sum(x * x) + (coeff / 10.0) * jnp.sum(x[:-1] * x[1:])


def coupled_quadratic_grad(x: Array, coeff: float = COUPLED_COEFFICIENT) -> Array:
    g = 2.0 * coeff * x
    g = g.at[:-1].add((coeff / 10.0) * x[1:])
    g = g.at[1:].add((coeff / 10.0) * x[:-1])
    return g


# --- fused value-and-grad forms -------------------------------------------------
# f and the analytic gradient from shared intermediates, which XLA fuses
# into one pass over x.

def quadratic_value_and_grad(x: Array):
    r = x - 1.0
    return jnp.sum(r * r), 2.0 * r


def rosenbrock_value_and_grad(x: Array):
    xi, xn = x[:-1], x[1:]
    t1 = xn - xi * xi
    t2 = 1.0 - xi
    f = jnp.sum(100.0 * t1 * t1 + t2 * t2)
    g = jnp.zeros_like(x)
    g = g.at[:-1].add(2.0 * (xi - 1.0) - 400.0 * xi * t1)
    g = g.at[1:].add(200.0 * t1)
    return f, g


def coupled_quadratic_value_and_grad(x: Array,
                                     coeff: float = COUPLED_COEFFICIENT):
    f = coeff * jnp.sum(x * x) + (coeff / 10.0) * jnp.sum(x[:-1] * x[1:])
    g = 2.0 * coeff * x
    g = g.at[:-1].add((coeff / 10.0) * x[1:])
    g = g.at[1:].add((coeff / 10.0) * x[:-1])
    return f, g


FUSED_VG = {
    "quadratic": quadratic_value_and_grad,
    "rosenbrock": rosenbrock_value_and_grad,
    "coupled_quadratic": coupled_quadratic_value_and_grad,
}


# --- directional polynomials -----------------------------------------------------
# phi(a) = f(x + a*d) expanded in a; coefficients are fused reductions over
# (x, d).  Derivations:
#   quadratic:  sum (r + a*d)^2, r = x-1:
#     c0 = r.r, c1 = 2 r.d, c2 = d.d
#   rosenbrock: per term i with A = x' - x^2, B = d' - 2xd, C = -d^2,
#     e = 1 - x (primes = index i+1):
#     100 (A + B a + C a^2)^2 + (e - a d)^2 ->
#     c0 = 100 A^2 + e^2
#     c1 = 200 A B - 2 e d
#     c2 = 100 (B^2 + 2 A C) + d^2
#     c3 = 200 B C
#     c4 = 100 C^2
#   coupled_quadratic: K sum (x+ad)^2 + (K/10) sum (x+ad)(x'+a d') ->
#     c0 = f(x), c1 = 2K x.d + (K/10)(x.d' + x'.d),
#     c2 = K d.d + (K/10) d.d'

def quadratic_dir_poly(x: Array, d: Array) -> Array:
    r = x - 1.0
    return jnp.stack([jnp.vdot(r, r), 2.0 * jnp.vdot(r, d), jnp.vdot(d, d)])


def sphere_dir_poly(x: Array, d: Array) -> Array:
    return jnp.stack([jnp.vdot(x, x), 2.0 * jnp.vdot(x, d), jnp.vdot(d, d)])


def rosenbrock_dir_poly(x: Array, d: Array) -> Array:
    xi, xn = x[:-1], x[1:]
    di, dn = d[:-1], d[1:]
    A = xn - xi * xi
    B = dn - 2.0 * xi * di
    C = -di * di
    e = 1.0 - xi
    c0 = jnp.sum(100.0 * A * A + e * e)
    c1 = jnp.sum(200.0 * A * B - 2.0 * e * di)
    c2 = jnp.sum(100.0 * (B * B + 2.0 * A * C) + di * di)
    c3 = jnp.sum(200.0 * B * C)
    c4 = jnp.sum(100.0 * C * C)
    return jnp.stack([c0, c1, c2, c3, c4])


def coupled_quadratic_dir_poly(x: Array, d: Array,
                               coeff: float = COUPLED_COEFFICIENT) -> Array:
    k10 = coeff / 10.0
    c0 = coeff * jnp.vdot(x, x) + k10 * jnp.sum(x[:-1] * x[1:])
    c1 = (2.0 * coeff * jnp.vdot(x, d)
          + k10 * (jnp.sum(x[:-1] * d[1:]) + jnp.sum(x[1:] * d[:-1])))
    c2 = coeff * jnp.vdot(d, d) + k10 * jnp.sum(d[:-1] * d[1:])
    return jnp.stack([c0, c1, c2])


# --- extras (not in the reference, useful for tests) -----------------------------

def sphere_f(x: Array) -> Array:
    return jnp.sum(x * x)


def sphere_grad(x: Array) -> Array:
    return 2.0 * x


_PROBLEMS = {
    "quadratic": Problem(
        "quadratic", quadratic_f, quadratic_grad,
        minimum_value=0.0,
        minimizer=lambda d, dtype: jnp.ones((d,), dtype),
        dir_poly=quadratic_dir_poly,
    ),
    "rosenbrock": Problem(
        "rosenbrock", rosenbrock_f, rosenbrock_grad,
        minimum_value=0.0,
        minimizer=lambda d, dtype: jnp.ones((d,), dtype),
        dir_poly=rosenbrock_dir_poly,
    ),
    "coupled_quadratic": Problem(
        "coupled_quadratic", coupled_quadratic_f, coupled_quadratic_grad,
        minimum_value=0.0,
        minimizer=lambda d, dtype: jnp.zeros((d,), dtype),
        dir_poly=coupled_quadratic_dir_poly,
    ),
    "sphere": Problem(
        "sphere", sphere_f, sphere_grad,
        minimum_value=0.0,
        minimizer=lambda d, dtype: jnp.zeros((d,), dtype),
        dir_poly=sphere_dir_poly,
    ),
}


def get_problem(name: str) -> Problem:
    try:
        return _PROBLEMS[name]
    except KeyError:
        raise KeyError(f"unknown problem {name!r}; available: {sorted(_PROBLEMS)}")


def problem_names() -> list[str]:
    return sorted(_PROBLEMS)


def register_problem(problem: Problem) -> None:
    _PROBLEMS[problem.name] = problem


def fused_value_and_grad(name: str):
    """Objective + analytic gradient from shared intermediates (one fused
    pass over x) for the suite problems that have one, else the problem's
    (f, grad) pair.  Pass as ``value_and_grad=`` to minimize()."""
    if name in FUSED_VG:
        return FUSED_VG[name]
    return get_problem(name).value_and_grad


def multi_phi_for(name: str):
    """Batched line-search trial evaluator phi_batch(x, d, alphas) -> (K,):
    the objective at all K trial points, vmapped.  Pass as ``phi_batch=``
    to minimize()/solve for line_search="backtracking_speculative" under
    ls_eval="direct"."""
    f = get_problem(name).f

    def phi_batch(x, d, alphas):
        return jax.vmap(lambda a: f(x + a * d))(alphas)

    return phi_batch


def multi_phi_dphi_for(name: str):
    """Batched (phi, phi') trial evaluator phi_dphi_batch(x, d, alphas) ->
    ((K,), (K,)): objective and directional derivative at all K trial
    points, vmapped.  Pass as ``phi_dphi_batch=`` to minimize()/solve for
    the speculative Wolfe searches under ls_eval="direct"."""
    vg = fused_value_and_grad(name)

    def phi_dphi_batch(x, d, alphas):
        def one(a):
            f_new, g_new = vg(x + a * d)
            return f_new, jnp.vdot(g_new, d)

        return jax.vmap(one)(alphas)

    return phi_dphi_batch


def auto_with_matvec(m: int, d: int, history_dtype=None,
                     batch: int = 1) -> bool:
    """Resolve with_matvec="auto": whether the fused tail should also
    compute the history matvecs.  False: no size rule for computing them
    in the tail has been measured on the GPU yet (ROADMAP S5).  ``m``,
    ``d``, the resolved ``history_dtype`` and ``batch`` (per-device lane
    count) are the inputs such a rule keys on; callers pass them
    already."""
    return False


def fused_tail_for(name: str, with_matvec=False, m: int = 10,
                   d: Optional[int] = None, history_dtype=None,
                   batch: int = 1, accurate_dots: bool = False,
                   interpret: bool = False):
    """The fused post-line-search tail (trial point + f/grad + pair update +
    scalar reductions + optional history matvecs in ONE pass) for a suite
    problem; pass as ``fused_tail=`` to minimize()/solve.  A Triton kernel
    in programs compiled for CUDA, its plain-XLA twin elsewhere and for
    problems without a kernel body (kernels.tail).

    with_matvec: also compute S@y_new and Y@y_new in the same pass (read by
    direction="compact_incremental" only); "auto" resolves through
    auto_with_matvec, which needs ``m`` and ``d``.
    accurate_dots: build the Neumaier-compensated variant — REQUIRED when
    pairing with cfg.accurate_dots (the solver rejects a plain tail).
    interpret: run the Triton kernel in the Pallas interpreter (tests)."""
    from ..kernels import make_fused_tail

    if with_matvec == "auto":
        with_matvec = d is not None and auto_with_matvec(m, d, history_dtype,
                                                         batch=batch)
    return make_fused_tail(name, fused_value_and_grad(name),
                           with_matvec=with_matvec,
                           accurate_dots=accurate_dots, interpret=interpret)


def reference_x0(d: int, seed: int, low: float = -1000.0, high: float = 1000.0,
                 dtype=jnp.float64) -> Array:
    """Starting point matching the reference driver's initialization.

    The reference draws x0 ~ U(-1000, 1000) with std::mt19937 (main.cpp:36-45);
    exact bit-parity with the C++ RNG is neither possible nor needed — parity
    runs feed identical x0 arrays to both implementations.  Experiment seeds:
    42, 365, 12345, 777777, 10000 (main.cpp:33).
    """
    key = jax.random.PRNGKey(seed)
    return jax.random.uniform(key, (d,), dtype=dtype, minval=low, maxval=high)
