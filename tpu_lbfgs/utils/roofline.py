"""Per-iteration memory-traffic model and roofline accounting.

The whole solver is memory-bound (SURVEY.md §5 tracing row: "roofline
accounting — bytes moved per two-loop step vs memory bandwidth").  This model counts
the HBM bytes each configuration streams per iteration so benchmarks can
report achieved fraction of roofline, and so regressions in pass count show
up as model-vs-measured gaps.

Pass counting (1 pass = d elements read or written once):

direction "two_loop" (lax.scan; reference semantics):
    first loop per pair: read s_i, q; write q; read y_i  -> 4 passes x m
    second loop per pair: read y_i, r; write r; read s_i -> 4 passes x m
    gamma scale + negate: ~2
direction "compact":
    contractions S.Y', Y.Y', S.g, Y.g: reads S twice, Y three times, g once
      (upper bound; XLA may share streams)                -> 5m + 1
    combine gamma*g + v@S - gamma*(u@Y): read S, Y, g; write r -> 2m + 2
line search "direct": per trial read x, d + objective read (fused trial
    point) ~2 passes; Wolfe trials add a gradient pass.
line search "polynomial": one coefficient pass (read x, d) total.
iteration tail: read x, d, g, g_new; write x_new, s, y   -> 7
post-search vg at x_new: read x_new, write g_new (+1 fused objective) -> 2-3
ring row writes: 2 rows = 2m/m... counted as 2 passes of d.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..config import LBFGSConfig

# Published peak device-memory bandwidth, GB/s, keyed by JAX's
# ``device_kind``.  Source: NVIDIA H100 Tensor Core GPU data sheet, SXM5
# part: 80 GB HBM3 at 3.35 TB/s (rated at the 700 W power limit).
HBM_BW_GBPS = {
    "NVIDIA H100 80GB HBM3": 3350.0,
}


def peak_bw_gbps(device_kind: str) -> float:
    """Published peak memory bandwidth of a device, GB/s.  A device that is
    not in the table is an error, not a default."""
    try:
        return HBM_BW_GBPS[device_kind]
    except KeyError:
        raise ValueError(f"no published peak bandwidth for device kind "
                         f"{device_kind!r}; known: {sorted(HBM_BW_GBPS)}")


@dataclass
class TrafficModel:
    """Per-iteration HBM traffic, split by phase, in f32-pass equivalents
    (1.0 = d elements at 4 bytes read or written once; a bfloat16 history
    pass counts 0.5).

    ``batch``: vmapped instance count — passes are PER INSTANCE and the
    lockstep iteration streams them for every lane, so total bytes scale by
    batch.  The model counts d-sized streams only; the per-instance O(m^2)
    small-matrix work (triangular solves, SY/YY updates) is assumed
    compute-negligible — when a measured batch cell falls far below this
    bound, profile whether the batched small ops are the real limiter."""
    passes_direction: float
    passes_line_search: float
    passes_tail: float
    passes_vg: float
    d: int
    dtype_bytes: int
    batch: int = 1

    @property
    def passes_total(self) -> float:
        return (self.passes_direction + self.passes_line_search
                + self.passes_tail + self.passes_vg)

    @property
    def bytes_per_iter(self) -> float:
        """Total HBM bytes per lockstep iteration (all ``batch`` lanes)."""
        return self.passes_total * self.d * self.dtype_bytes * self.batch

    def peak_iters_per_s(self, device_kind: str) -> float:
        """Roofline-bound lockstep iterations/s (one iteration advances
        every lane once) at the device's published peak bandwidth."""
        return peak_bw_gbps(device_kind) * 1e9 / self.bytes_per_iter

    def peak_instance_iters_per_s(self, device_kind: str) -> float:
        """Roofline-bound instance-iterations/s = batch x lockstep rate —
        the unit the batch benchmarks report."""
        return self.peak_iters_per_s(device_kind) * self.batch

    def roofline_fraction(self, measured_iters_per_s: float,
                          device_kind: str) -> float:
        """measured_iters_per_s in LOCKSTEP iterations/s (for batch cells,
        instance-it/s divided by batch — or use
        measured_instance_rate / peak_instance_iters_per_s, identical)."""
        return measured_iters_per_s / self.peak_iters_per_s(device_kind)


def traffic_model(cfg: LBFGSConfig, d: int, dtype_bytes: int = 4,
                  avg_ls_trials: float = 2.2,
                  obj_passes: float = 1.0,
                  fused_tail: bool = None,
                  hist_resident: bool = False,
                  batch: int = 1) -> TrafficModel:
    """Estimate HBM passes per iteration for a configuration.

    avg_ls_trials: measured average line-search trials per iteration
    (n_fev / iterations from a run); obj_passes: passes one objective
    evaluation costs beyond reading its input (1 for the suite's fused or
    elementwise-chain objectives); fused_tail: whether the single-stream
    fused tail is active (defaults to cfg.use_pallas).

    hist_resident: count history READS as free (a ring held in a cache
    across the while_loop); default False — every history pass streams.
    Ring-row WRITES always stream.

    batch: vmapped instance count — the returned model's bytes/iter scale
    by it (TrafficModel.batch).

    History passes assume the (m, R, 128) storage (types.hist_block); a
    bfloat16 history pass costs 0.5 f32-equivalents.
    """
    m = cfg.m
    if fused_tail is None:
        fused_tail = cfg.use_pallas
    hw = 1.0
    from ..core.solver import resolve_history_dtype

    hd = resolve_history_dtype(cfg.history_dtype, m, d,
                               "float32" if dtype_bytes == 4 else "float64",
                               batch=batch)
    if hd is not None:
        import jax.numpy as jnp
        hw = jnp.dtype(hd).itemsize / dtype_bytes
    hw_write = hw     # ring-row writes stream regardless of residency
    if hist_resident:
        hw = 0.0      # resident history: READS are free

    if cfg.direction == "two_loop":
        # per pair, both loops: read s_i, y_i (history) + read/write q or r.
        p_dir = (4.0 * m) * hw + (4.0 * m) + 2.0
    elif cfg.direction == "compact_incremental":
        # matvecs S@g_new, Y@g_new (tail side) + combine read S, Y, g, write d.
        # g.d comes from the DirAux coefficient identity: no vdot pass.
        p_dir = (2.0 * m) * hw + 1.0 + (2.0 * m) * hw + 2.0
    else:  # compact: recompute S.Y', Y.Y', S.g, Y.g then combine
        p_dir = (5.0 * m) * hw + 1.0 + (2.0 * m) * hw + 2.0

    if cfg.ls_eval == "polynomial":
        p_ls = 2.0  # one (x, d) coefficient pass
    else:
        per_trial = 2.0 + obj_passes
        if cfg.line_search == "backtracking_speculative":
            # the whole candidate ladder shares one (x, d) stream per round
            per_trial = (2.0 + obj_passes) / max(avg_ls_trials, 1.0)
        elif cfg.line_search in ("backtracking_wolfe",
                                 "backtracking_wolfe_bisect",
                                 "wolfe_interpolation"):
            per_trial += 1.0  # gradient per trial
        p_ls = per_trial * avg_ls_trials
        if cfg.direction == "two_loop":
            # Only the two-loop path reduces jnp.vdot(g, d) for phi'(0);
            # the compact paths get it from the DirAux coefficient identity.
            p_ls += 2.0

    if fused_tail:
        # One stream: read x, d, g; write x_new, g_new, s_row, y_row
        # (rows in history dtype); f/grad computed in-kernel.
        p_tail = 3.0 + 2.0 + 2.0 * hw_write
        p_vg = 0.0
        p_ring = 4.0 * hw_write  # conditional row select + write
    else:
        # x_new compute (read x, d, write x_new), vg at x_new, fused
        # iteration_tail (read x, d, g, g_new; write x_new, s, y).
        p_tail = 3.0 + 7.0
        p_vg = 2.0 + obj_passes
        p_ring = 4.0 * hw_write
    return TrafficModel(p_dir, p_ls, p_tail + p_ring, p_vg, d, dtype_bytes,
                        batch=batch)
