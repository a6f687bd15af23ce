// tpu-lbfgs native oracle: a clean-room C++17 implementation of the reference
// L-BFGS algorithm (see SURVEY.md; semantics documented against
// sequential-implementation/lbfgs.cpp and both line_search.cpp files).
//
// Dual role:
//   1. Trajectory-parity oracle for the JAX solver (exact reference decision
//      rules, fp64, host control flow).
//   2. CPU performance baseline for bench.py — the stand-in for the
//      reference's sequential implementation on this machine, against which
//      the device speedup is measured (BASELINE.md: reference GPU ~ 1.2x its CPU).
//
// Exposed via a C ABI for ctypes (no pybind11 in this environment).
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -o liboracle.so oracle.cpp

#include <algorithm>
#include <cmath>
#include <cstring>
#include <deque>
#include <limits>
#include <vector>

namespace {

using Vec = std::vector<double>;

struct Params {
  double c1, c2, initial_step, shrink, grow;
  double backtracking_tol, interp_min, bisect_tol;
  int ls_max_iters, ls_safety_cap;
  double rescue_floor;  // < 0 disables
  double rescue_value;
  double step_fail_tol, curvature_threshold;
  bool safe_cubic;
  bool reference_fidelity;
};

// ---- problem suite (mirrors tpu_lbfgs.problems.suite) ----------------------

double quadratic_f(const double* x, int n) {
  double acc = 0.0;
  for (int i = 0; i < n; ++i) {
    const double r = x[i] - 1.0;
    acc += r * r;
  }
  return acc;
}

void quadratic_g(const double* x, double* g, int n) {
  for (int i = 0; i < n; ++i) g[i] = 2.0 * (x[i] - 1.0);
}

double rosenbrock_f(const double* x, int n) {
  double acc = 0.0;
  for (int i = 0; i + 1 < n; ++i) {
    const double a = x[i + 1] - x[i] * x[i];
    const double b = 1.0 - x[i];
    acc += 100.0 * a * a + b * b;
  }
  return acc;
}

void rosenbrock_g(const double* x, double* g, int n) {
  std::fill(g, g + n, 0.0);
  for (int i = 0; i + 1 < n; ++i) {
    const double t = x[i + 1] - x[i] * x[i];
    g[i] += 2.0 * (x[i] - 1.0) - 400.0 * x[i] * t;
    g[i + 1] += 200.0 * t;
  }
}

double coupled_quadratic_f(const double* x, int n) {
  const double c = 1000.0;
  double diag = 0.0, cross = 0.0;
  for (int i = 0; i < n; ++i) diag += x[i] * x[i];
  for (int i = 0; i + 1 < n; ++i) cross += x[i] * x[i + 1];
  return c * diag + (c / 10.0) * cross;
}

void coupled_quadratic_g(const double* x, double* g, int n) {
  const double c = 1000.0;
  for (int i = 0; i < n; ++i) g[i] = 2.0 * c * x[i];
  for (int i = 0; i + 1 < n; ++i) {
    g[i] += (c / 10.0) * x[i + 1];
    g[i + 1] += (c / 10.0) * x[i];
  }
}

// ---- small helpers ---------------------------------------------------------

double dot(const Vec& a, const Vec& b) {
  double acc = 0.0;
  for (size_t i = 0; i < a.size(); ++i) acc += a[i] * b[i];
  return acc;
}

double norm2(const Vec& a) { return std::sqrt(dot(a, a)); }

struct Objective {
  int problem_id;
  double (*f_cb)(const double*, int, void*);
  void (*g_cb)(const double*, double*, int, void*);
  void* ctx;
  mutable long n_fev = 0, n_gev = 0;

  double f(const Vec& x) const {
    ++n_fev;
    switch (problem_id) {
      case 0: return quadratic_f(x.data(), (int)x.size());
      case 1: return rosenbrock_f(x.data(), (int)x.size());
      case 2: return coupled_quadratic_f(x.data(), (int)x.size());
      default: return f_cb(x.data(), (int)x.size(), ctx);
    }
  }

  Vec grad(const Vec& x) const {
    ++n_gev;
    Vec g(x.size());
    switch (problem_id) {
      case 0: quadratic_g(x.data(), g.data(), (int)x.size()); break;
      case 1: rosenbrock_g(x.data(), g.data(), (int)x.size()); break;
      case 2: coupled_quadratic_g(x.data(), g.data(), (int)x.size()); break;
      default: g_cb(x.data(), g.data(), (int)x.size(), ctx); break;
    }
    return g;
  }
};

Vec axpy(const Vec& x, double a, const Vec& d) {
  Vec out(x.size());
  for (size_t i = 0; i < x.size(); ++i) out[i] = x[i] + a * d[i];
  return out;
}

// ---- interpolators ---------------------------------------------------------

double cubic_interp(double a0, double a1, double p0, double dp0, double p1,
                    double dp1) {
  const double d1 = dp0 + dp1 - 3.0 * (p1 - p0) / (a1 - a0);
  const double disc = d1 * d1 - dp0 * dp1;
  const double root =
      disc >= 0 ? std::sqrt(disc) : std::numeric_limits<double>::quiet_NaN();
  const double d2 = std::copysign(root, a1 - a0);
  return a0 + (a1 - a0) * (dp0 + d2 - d1) / (dp0 - dp1 + 2.0 * d2);
}

double quadratic_interp(double a0, double phi_new, double dphi0, double phi0) {
  // Matches quadraticInterpolate(alpha, 0, f_new, g.d, f_x): the curve points
  // are (a0, phi_new) and (0, phi0), so the denominator is phi0 - phi_new.
  return a0 - 0.5 * dphi0 * a0 * a0 / (phi0 - phi_new - dphi0 * a0);
}

double safe_cubic_interp(double a0, double a1, double p0, double dp0,
                         double p1, double dp1) {
  if (a0 > a1) {
    std::swap(a0, a1);
    std::swap(p0, p1);
    std::swap(dp0, dp1);
  }
  const double mid = 0.5 * (a0 + a1);
  const double span = a1 - a0;
  if (span == 0.0) return mid;
  const double d1 = dp0 + dp1 - 3.0 * (p1 - p0) / span;
  if (!std::isfinite(d1)) return mid;
  const double disc = d1 * d1 - dp0 * dp1;
  if (disc < 0) return mid;
  const double d2 = std::copysign(std::sqrt(disc), span);
  const double denom = dp0 - dp1 + 2.0 * d2;
  if (std::fabs(denom) < 1e-10) return mid;
  const double result = a0 + span * (dp0 + d2 - d1) / denom;
  if (!std::isfinite(result)) return mid;
  return std::max(a0 + 0.1 * span, std::min(a1 - 0.1 * span, result));
}

// ---- line searches ---------------------------------------------------------

double ls_backtracking(const Params& P, const Objective& obj, const Vec& x,
                       const Vec& d, double f_x, double gdd) {
  double alpha = P.initial_step;
  for (;;) {
    const double f_new = obj.f(axpy(x, alpha, d));
    const bool accept = P.reference_fidelity
                            ? (f_x - f_new) >= P.c1 * alpha * gdd
                            : f_new <= f_x + P.c1 * alpha * gdd;
    if (accept) break;
    alpha *= P.shrink;
    if (alpha < P.backtracking_tol) break;
  }
  if (P.rescue_floor >= 0 && alpha < P.rescue_floor) return P.rescue_value;
  return alpha;
}

double ls_backtracking_wolfe(const Params& P, const Objective& obj,
                             const Vec& x, const Vec& d, double f_x,
                             double gdd) {
  double alpha = P.initial_step;
  for (int it = 0; it < P.ls_safety_cap; ++it) {
    const Vec x_new = axpy(x, alpha, d);
    const Vec g_new = obj.grad(x_new);
    const double f_new = obj.f(x_new);
    if (f_new > f_x + P.c1 * alpha * gdd) {
      alpha *= P.shrink;
    } else if (dot(g_new, d) < P.c2 * gdd) {
      alpha *= P.grow;
    } else {
      break;
    }
    if (alpha < P.backtracking_tol) break;
  }
  return alpha;
}

double ls_backtracking_wolfe_bisect(const Params& P, const Objective& obj,
                                    const Vec& x, const Vec& d, double f_x,
                                    double gdd) {
  double alpha = P.initial_step;
  double lo = 0.0, hi = std::numeric_limits<double>::max();
  for (int it = 0; it < P.ls_max_iters; ++it) {
    const Vec x_new = axpy(x, alpha, d);
    const double f_new = obj.f(x_new);
    if (f_new <= f_x + P.c1 * alpha * gdd) {
      const double gnd = dot(obj.grad(x_new), d);
      if (gnd >= P.c2 * gdd) break;
      lo = alpha;
    } else {
      hi = alpha;
    }
    alpha = hi < std::numeric_limits<double>::max() ? 0.5 * (lo + hi)
                                                    : 2.0 * lo;
    if (alpha < P.bisect_tol) break;
  }
  return alpha;
}

double ls_armijo_interpolation(const Params& P, const Objective& obj,
                               const Vec& x, const Vec& d, double f_x,
                               double gdd) {
  double alpha = P.initial_step;
  double alpha_prev = 0.0;
  double f_prev = f_x;
  for (int it = 0; it < P.ls_max_iters; ++it) {
    const double alpha_tested = alpha;
    const double f_new = obj.f(axpy(x, alpha, d));
    if (f_new <= f_x + P.c1 * alpha * gdd) return alpha;
    if (alpha < P.interp_min) return P.interp_min;
    if (alpha_prev > 0) {
      if (std::fabs(alpha - alpha_prev) < 1e-10) {
        alpha *= 0.5;
      } else {
        const double grad_alpha = (f_new - f_x - gdd * alpha) / (alpha * alpha);
        double a = cubic_interp(alpha_prev, alpha, f_prev, gdd, f_new,
                                grad_alpha);
        if (a < 0.1 * alpha_prev || a > 0.9 * alpha_prev) a = 0.5 * alpha_prev;
        alpha = a;
      }
    } else {
      double a = quadratic_interp(alpha, f_new, gdd, f_x);
      if (a < 0.1 * P.initial_step || a > 0.9 * P.initial_step)
        a = 0.5 * P.initial_step;
      alpha = a;
    }
    alpha_prev = P.reference_fidelity ? alpha : alpha_tested;
    f_prev = f_new;
  }
  if (P.rescue_floor >= 0 && alpha < P.rescue_floor) return P.rescue_value;
  return alpha;
}

double ls_wolfe_interpolation(const Params& P, const Objective& obj,
                              const Vec& x, const Vec& d, double f_x,
                              double gdd) {
  auto interp = [&](double a0, double a1, double p0, double dp0, double p1,
                    double dp1) {
    return P.safe_cubic ? safe_cubic_interp(a0, a1, p0, dp0, p1, dp1)
                        : cubic_interp(a0, a1, p0, dp0, p1, dp1);
  };
  double alpha = P.initial_step;
  double lo = 0.0, hi = std::numeric_limits<double>::infinity();
  double f_lo = f_x, dphi_lo = gdd;
  for (int it = 0; it < P.ls_max_iters; ++it) {
    const Vec x_new = axpy(x, alpha, d);
    const double f_new = obj.f(x_new);
    if (f_new > f_x + P.c1 * alpha * gdd || (f_new >= f_lo && it > 0)) {
      hi = alpha;
      alpha = interp(lo, hi, f_lo, dphi_lo, f_new,
                     (f_new - f_x - gdd * alpha) / (alpha * alpha));
      continue;
    }
    const double dphi_new = dot(obj.grad(x_new), d);
    if (std::fabs(dphi_new) <= -P.c2 * gdd) return alpha;
    if (dphi_new >= 0) {
      hi = alpha;
      alpha = interp(lo, hi, f_lo, dphi_lo, f_new, dphi_new);
    } else {
      lo = alpha;
      f_lo = f_new;
      dphi_lo = dphi_new;
      alpha = std::isinf(hi) ? 2.0 * alpha
                             : interp(lo, hi, f_lo, dphi_lo, f_new, dphi_new);
    }
    if (alpha < P.interp_min) return P.interp_min;
  }
  return alpha;
}

using LineSearchFn = double (*)(const Params&, const Objective&, const Vec&,
                                const Vec&, double, double);

LineSearchFn line_search_table[] = {
    ls_backtracking,          // 0
    ls_backtracking_wolfe,    // 1
    ls_backtracking_wolfe_bisect,  // 2
    ls_armijo_interpolation,  // 3
    ls_wolfe_interpolation,   // 4
};

// ---- two-loop direction ----------------------------------------------------

Vec direction(const Objective& obj, const Vec& g,
              const std::deque<Vec>& s_hist, const std::deque<Vec>& y_hist) {
  const size_t h = s_hist.size();
  if (h == 0) {
    Vec d(g.size());
    for (size_t i = 0; i < g.size(); ++i) d[i] = -g[i];
    return d;
  }
  Vec q = g;
  std::vector<double> alphas(h, 0.0);
  for (int i = (int)h - 1; i >= 0; --i) {
    const double sy = dot(y_hist[i], s_hist[i]);
    const double rho = 1.0 / sy;
    if (!std::isfinite(rho)) {
      Vec d(g.size());
      for (size_t j = 0; j < g.size(); ++j) d[j] = -g[j];
      return d;
    }
    alphas[i] = rho * dot(s_hist[i], q);
    for (size_t j = 0; j < q.size(); ++j) q[j] -= alphas[i] * y_hist[i][j];
  }
  const double sy_last = dot(s_hist.back(), y_hist.back());
  const double yy_last = dot(y_hist.back(), y_hist.back());
  const double gamma = sy_last / yy_last;
  if (gamma <= 0 || !std::isfinite(gamma)) {
    Vec d(g.size());
    for (size_t j = 0; j < g.size(); ++j) d[j] = -g[j];
    return d;
  }
  Vec r(q.size());
  for (size_t j = 0; j < q.size(); ++j) r[j] = gamma * q[j];
  for (size_t i = 0; i < h; ++i) {
    const double rho = 1.0 / dot(y_hist[i], s_hist[i]);
    const double beta = rho * dot(y_hist[i], r);
    for (size_t j = 0; j < r.size(); ++j)
      r[j] += s_hist[i][j] * (alphas[i] - beta);
  }
  for (size_t j = 0; j < r.size(); ++j) r[j] = -r[j];
  return r;
}

}  // namespace

// ---- C ABI -----------------------------------------------------------------

extern "C" {

// Status codes match tpu_lbfgs.types.Status.
int tl_lbfgs_solve(
    int problem_id, double (*f_cb)(const double*, int, void*),
    void (*g_cb)(const double*, double*, int, void*), void* ctx,
    const double* x0, int n, int m, int max_iters, double tol,
    int line_search_id, int reference_fidelity, const double* p,
    double* x_out, double* f_out, double* gnorm_out, int* iters_out,
    int* status_out, long* nfev_out, long* ngev_out, double* trace_f,
    double* trace_gnorm, double* trace_alpha) {
  Params P;
  P.c1 = p[0];
  P.c2 = p[1];
  P.initial_step = p[2];
  P.shrink = p[3];
  P.grow = p[4];
  P.backtracking_tol = p[5];
  P.interp_min = p[6];
  P.bisect_tol = p[7];
  P.ls_max_iters = (int)p[8];
  P.ls_safety_cap = (int)p[9];
  P.rescue_floor = p[10];
  P.rescue_value = p[11];
  P.step_fail_tol = p[12];
  P.curvature_threshold = p[13];
  P.safe_cubic = p[14] != 0.0;
  P.reference_fidelity = reference_fidelity != 0;

  Objective obj{problem_id, f_cb, g_cb, ctx};
  Vec x(x0, x0 + n);
  double f_current = obj.f(x);
  Vec g = obj.grad(x);

  std::deque<Vec> s_hist, y_hist;
  int status = 3;  // MAX_ITERS
  int k = 0;
  for (; k < max_iters; ++k) {
    const double g_norm = norm2(g);
    if (trace_f) trace_f[k] = f_current;
    if (trace_gnorm) trace_gnorm[k] = g_norm;
    if (g_norm < tol) {
      status = 1;  // CONVERGED
      break;
    }
    Vec d = direction(obj, g, s_hist, y_hist);
    double gdd = dot(g, d);
    if (gdd >= 0) {
      for (int i = 0; i < n; ++i) d[i] = -g[i];
      gdd = dot(g, d);
    }
    const double alpha =
        line_search_table[line_search_id](P, obj, x, d, f_current, gdd);
    if (trace_alpha) trace_alpha[k] = alpha;

    const Vec x_new = axpy(x, alpha, d);
    f_current = obj.f(x_new);
    if (alpha < P.step_fail_tol) {
      status = 2;  // LINE_SEARCH_FAILED
      break;
    }
    Vec g_new = obj.grad(x_new);
    Vec s(n), y(n);
    for (int i = 0; i < n; ++i) {
      s[i] = x_new[i] - x[i];
      y[i] = g_new[i] - g[i];
    }
    const double sy = dot(s, y);
    if (sy > P.curvature_threshold) {
      if ((int)s_hist.size() >= m) {
        s_hist.pop_front();
        y_hist.pop_front();
      }
      s_hist.push_back(std::move(s));
      y_hist.push_back(std::move(y));
    }
    x = x_new;
    g = std::move(g_new);
  }

  std::memcpy(x_out, x.data(), n * sizeof(double));
  *f_out = obj.f(x);
  *gnorm_out = norm2(g);
  *iters_out = k;
  *status_out = status;
  *nfev_out = obj.n_fev;
  *ngev_out = obj.n_gev;
  return 0;
}

// Standalone problem evaluation (for tests / benchmarking the baseline).
double tl_problem_f(int problem_id, const double* x, int n) {
  switch (problem_id) {
    case 0: return quadratic_f(x, n);
    case 1: return rosenbrock_f(x, n);
    case 2: return coupled_quadratic_f(x, n);
    default: return 0.0;
  }
}

void tl_problem_grad(int problem_id, const double* x, double* g, int n) {
  switch (problem_id) {
    case 0: quadratic_g(x, g, n); break;
    case 1: rosenbrock_g(x, g, n); break;
    case 2: coupled_quadratic_g(x, g, n); break;
    default: std::fill(g, g + n, 0.0); break;
  }
}

}  // extern "C"
