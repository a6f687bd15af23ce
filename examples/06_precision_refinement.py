"""Two-stage precision refinement: f32 on the GPU, f64 polish on the host.

The BASELINE.json north-star asks for time-to-||g|| <= 1e-5 at d ~ 1e6.
That tolerance is below the float32 gradient-ENTRY noise floor at this d
(each entry carries ~1e-7 of evaluation rounding near the minimum; a million
entries put the achievable norm around 1e-3 no matter how accurately the
reduction is summed), so no single-precision run can get there.

The split: let the GPU do ~100k fast f32 iterations down to
||g|| <= 1e-3, then hand the iterate to the C++ f64 oracle on the host —
L-BFGS's superlinear local convergence needs only ~10 double-precision
iterations from there (~1 s at d = 2^20).

Run:  python examples/06_precision_refinement.py [d]   (default 2^20; the
coarse stage needs ~100k iterations there.  Needs a GPU: the timing
harness refuses to measure anything else.)
"""
import sys

from tpu_lbfgs.bench.harness import time_to_tolerance_refined

d = int(sys.argv[1]) if len(sys.argv) > 1 else 1 << 20

r = time_to_tolerance_refined(problem="rosenbrock", d=d, coarse_tol=1e-3,
                              tol=1e-5, refine_backend="native")
print(f"stage 1 (f32, device): {r['coarse_iterations']} iterations, "
      f"{r['coarse_wall_s']:.2f}s")
print(f"stage 2 (f64, host):   {r['refine_iterations']} iterations, "
      f"{r['refine_wall_s']:.2f}s")
print(f"total: ||g|| = {r['g_norm']:.2e} (target 1e-5), f = {r['f']:.2e}, "
      f"status = {r['status']}, wall = {r['wall_s']:.2f}s")
