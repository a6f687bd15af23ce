"""Known-minimum quadratic fixtures: the resurrected `matrices.h`.

The reference ships 2,085 lines of hardcoded SPD matrices, linear terms, and
precomputed minima for d in {2,...,500} (sequential-implementation/matrices.h)
that were clearly intended as an accuracy harness but are never referenced by
any code (SURVEY.md §2 item 7).  Here the same idea is done properly: seeded
generators produce SPD quadratic problems

    f(x) = 1/2 x'Ax - b'x        minimizer x* = A^{-1} b,  f* = -1/2 b'x*

on the fly, with the ground truth computed by a direct solve — no thousands
of lines of checked-in constants, any dimension, reproducible by seed.
"""
from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from .suite import Problem

FIXTURE_DIMS = (2, 3, 4, 5, 10, 50, 100, 500)  # matrices.h's dimension set


@dataclass(frozen=True)
class QuadraticFixture:
    """SPD quadratic with known ground truth."""
    dim: int
    seed: int
    A: np.ndarray          # (d, d) SPD
    b: np.ndarray          # (d,)
    minimizer: np.ndarray  # x* = A^{-1} b
    minimum_value: float   # f(x*)

    def problem(self, dtype=jnp.float64) -> Problem:
        A = jnp.asarray(self.A, dtype)
        b = jnp.asarray(self.b, dtype)
        # Full precision: an f32 product could otherwise run in TF32.
        hi = jax.lax.Precision.HIGHEST

        def f(x):
            return 0.5 * jnp.vdot(x, jnp.matmul(A, x, precision=hi),
                                  precision=hi) \
                - jnp.vdot(b, x, precision=hi)

        def grad(x):
            return jnp.matmul(A, x, precision=hi) - b

        return Problem(
            name=f"spd_quadratic_d{self.dim}_s{self.seed}", f=f, grad=grad,
            minimum_value=self.minimum_value,
            minimizer=lambda d, dt: jnp.asarray(self.minimizer, dt))


def make_spd_fixture(dim: int, seed: int = 0,
                     condition: float = 100.0) -> QuadraticFixture:
    """SPD matrix with controlled condition number via eigenvalue shaping
    (log-uniform spectrum in [1, condition]), random orthogonal basis."""
    rng = np.random.default_rng(seed * 100003 + dim)
    Q, _ = np.linalg.qr(rng.normal(size=(dim, dim)))
    eigs = np.exp(rng.uniform(0.0, np.log(condition), dim))
    A = (Q * eigs) @ Q.T
    A = 0.5 * (A + A.T)  # exact symmetry
    b = rng.normal(size=dim)
    x_star = np.linalg.solve(A, b)
    f_star = float(0.5 * x_star @ (A @ x_star) - b @ x_star)
    return QuadraticFixture(dim=dim, seed=seed, A=A, b=b,
                            minimizer=x_star, minimum_value=f_star)


def fixture_suite(seed: int = 0, dims=FIXTURE_DIMS,
                  condition: float = 100.0):
    return [make_spd_fixture(d, seed, condition) for d in dims]
