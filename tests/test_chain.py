"""The fused batched small-matrix chain (kernels/chain.py): the Triton
kernel under custom_vmap (interpret mode here) must reproduce the vmapped
jnp formulation exactly (same masking, same fallback bits), across ring
states including empty and partial history, rejected pairs, and
pathological scalars, at any batch size."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_lbfgs.kernels import chain as chain_mod
from tpu_lbfgs.kernels.chain import chain_jnp, make_compact_chain

M = 5
B = 1000   # not a multiple of the kernel's lane block: masked lanes


def _random_inputs(rng, B, dtype=jnp.float32, pathological=False):
    SY = rng.uniform(0.1, 2.0, (B, M, M))
    # Diagonally dominant R: random triangular pivots down to 0.1 amplify
    # substitution-vs-library-solve rounding beyond any fixed tolerance;
    # conditioning is not what this test pins (the pathological variant
    # covers the guard paths).
    SY[:, np.arange(M), np.arange(M)] += 2.0
    YY = rng.uniform(0.1, 2.0, (B, M, M))
    Sg = rng.uniform(-1, 1, (B, M))
    Yg = rng.uniform(-1, 1, (B, M))
    syh = rng.uniform(0.1, 2.0, (B, M))
    yyh = rng.uniform(0.1, 2.0, (B, M))
    n_pairs = rng.integers(0, 4 * M, (B,))
    gn = rng.uniform(0.1, 10.0, (B,))
    if pathological:
        # zero pivots (bad rho), negative newest sy (bad gamma), NaNs
        for i in range(0, B, 7):
            SY[i, i % M, i % M] = 0.0
        for i in range(3, B, 11):
            syh[i] = -1.0
        for i in range(5, B, 13):
            SY[i, 0, 1] = np.nan
    return tuple(jnp.asarray(a, dtype) for a in
                 (SY, YY, Sg, Yg, syh, yyh)) + \
        (jnp.asarray(n_pairs, jnp.int32), jnp.asarray(gn, dtype))


@pytest.mark.parametrize("skip_thr", [None, 1e-10])
@pytest.mark.parametrize("pathological", [False, True])
def test_chain_kernel_matches_vmapped_jnp(skip_thr, pathological,
                                          monkeypatch):
    import tpu_lbfgs.core.direction as direction_mod

    rng = np.random.default_rng(17)
    args = _random_inputs(rng, B, jnp.float32, pathological)
    chain = make_compact_chain(M, skip_thr, interpret=True)
    got = jax.jit(jax.vmap(chain))(*args)
    # Reference: the GATHER-semantics jnp formulation.  The kernel's
    # select-chains replicate gather NaN propagation exactly; the one-hot
    # matmul path (the unbatched default) leaks a poisoned entry across
    # its contraction — MORE fallbacks on garbage lanes, never fewer, and
    # only on lanes whose direction is garbage either way.
    monkeypatch.setattr(direction_mod, "_ONEHOT", False)
    want = jax.jit(jax.vmap(
        lambda *a: chain_jnp(*a, m=M, skip_thr=skip_thr)))(*args)
    names = ("v_phys", "u_phys", "gamma", "g_dot_d", "fallback")
    for name, a, b in zip(names, got, want):
        a, b = np.asarray(a), np.asarray(b)
        if name == "fallback":
            np.testing.assert_array_equal(a, b, err_msg=name)
            continue
        mask = ~np.asarray(want[-1])          # compare non-fallback lanes
        am = a[mask] if a.ndim == 1 else a[mask, :]
        bm = b[mask] if b.ndim == 1 else b[mask, :]
        np.testing.assert_allclose(am, bm, rtol=2e-5, atol=2e-6,
                                   err_msg=name)


def test_chain_f64_and_odd_batch_fall_back():
    """f64 batches (even with interpret=True) and every batch off CUDA take
    the vmapped-jnp path: bit-equal to direct vmap of the impl."""
    rng = np.random.default_rng(18)
    for dtype, b, interp in ((jnp.float64, B, True),
                             (jnp.float32, 96, False)):
        args = _random_inputs(rng, b, dtype)
        chain = make_compact_chain(M, None, interpret=interp)
        got = jax.jit(jax.vmap(chain))(*args)
        want = jax.jit(jax.vmap(
            lambda *a: chain_jnp(*a, m=M, skip_thr=None)))(*args)
        for a, b_ in zip(got, want):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b_))


def test_chain_unbatched_is_plain_jnp():
    """A non-vmapped call traces chain_jnp directly (single-instance
    solves keep their exact program)."""
    rng = np.random.default_rng(19)
    args = tuple(a[0] for a in _random_inputs(rng, 4, jnp.float64))
    chain = make_compact_chain(M, None)
    got = chain(*args)
    want = chain_jnp(*args, m=M, skip_thr=None)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_batched_solver_trajectory_with_chain_kernel(monkeypatch):
    """End-to-end: the vmapped compact_incremental solver (which routes its
    small-matrix head through the chain, here the interpreted Triton
    kernel) matches per-lane single solves."""
    from tpu_lbfgs import LBFGSConfig, get_problem, minimize
    from tpu_lbfgs.batch.vmapped import vmap_minimize

    real = chain_mod.make_compact_chain
    monkeypatch.setattr(chain_mod, "make_compact_chain",
                        lambda m, thr: real(m, thr, interpret=True))

    p = get_problem("rosenbrock")
    cfg = LBFGSConfig(line_search="backtracking",
                      direction="compact_incremental", ls_eval="polynomial",
                      fidelity="fixed", pair_skip_threshold=1e-10,
                      max_iters=40, tol=0.0)
    x0s = jnp.asarray(
        np.random.default_rng(20).uniform(-2, 2, (96, 256)), jnp.float32)
    rb = vmap_minimize(p.f, x0s, cfg, grad=p.grad, dir_poly=p.dir_poly,
                       lockstep="bounded")
    for lane in (0, 47, 95):
        r1 = minimize(p.f, x0s[lane], cfg, grad=p.grad, dir_poly=p.dir_poly)
        # f32 trajectories through differently-rounded programs (in-kernel
        # substitution vs the library solve) legitimately drift over 40
        # iterations; same tolerance class as the other Pallas-vs-jnp
        # trajectory tests.
        np.testing.assert_allclose(float(rb.f[lane]), float(r1.f),
                                   rtol=5e-3, atol=1e-4,
                                   err_msg=f"lane {lane}")
