"""Machinery tests for the reference-protocol runner (bench/reference_protocol.py).

The real experiment (5 seeds x 4 strategies x d up to 2^20, far starts, to
convergence) runs on the GPU via `python -m tpu_lbfgs.bench
--reference-protocol`; these tests exercise the same code paths at small d
on the CPU backend: cell execution, budget limiting, summary statistics,
and the markdown rendering of the report table.
"""
import numpy as np
import pytest

from tpu_lbfgs.bench.reference_protocol import (
    TABLE_I_STRATEGIES,
    markdown_table,
    run_cpu_cell,
    run_device_cell,
    run_protocol,
)


@pytest.fixture(autouse=True)
def cpu_measure(monkeypatch):
    """Device cells refuse anything but a GPU (harness.require_gpu); these
    tests check the protocol machinery on the CPU, not device numbers."""
    from tpu_lbfgs.bench import harness, reference_protocol

    monkeypatch.setattr(reference_protocol, "require_gpu",
                        harness.device_record)


def test_table_i_strategy_names_are_valid():
    from tpu_lbfgs.config import LINE_SEARCH_METHODS

    for label, key in TABLE_I_STRATEGIES:
        assert key in LINE_SEARCH_METHODS, (label, key)


def test_cpu_cell_converges_far_start_quadratic():
    cell = run_cpu_cell("quadratic", 256, "backtracking", seeds=(42, 365))
    assert cell["seeds_run"] == 2
    assert all(s == "converged" for s in cell["statuses"])
    # Reference sequential config: ||g|| <= 1e-8 in f64.
    assert cell["max_final_g_norm"] <= 1e-8
    assert cell["mean_iterations"] >= 1


def test_cpu_cell_budget_limits_seeds():
    # A zero budget still runs the first seed (the check needs one measured
    # wall to project from) but no more.
    cell = run_cpu_cell("quadratic", 256, "backtracking",
                        seeds=(42, 365, 12345), budget_s=0.0)
    assert cell["seeds_run"] == 1
    assert cell["seeds_total"] == 3


def test_device_cell_far_start_quadratic_converges_f32():
    # The quadratic stays in f32 range from U(-1000,1000) starts; the cell
    # must converge to the GPU-config tolerance (1e-1) in a handful of
    # iterations and report per-seed data.
    cell = run_device_cell("quadratic", 256, "backtracking", seeds=(42,),
                           use_pallas=False)
    assert cell["seeds_run"] == 1
    assert cell["statuses"] == ["converged"]
    assert cell["max_final_g_norm"] <= 1e-1
    assert cell["mean_iterations"] <= 50
    assert "compile_s" in cell


def test_device_cell_far_start_rosenbrock_wolfe_matches_oracle_iters():
    # Wolfe backtracking survives far starts in f32 (growth phase escapes the
    # floor); its iteration count should be the same order as the f64 oracle
    # run of the same protocol (a coarse parity check: both ~8k at d=512).
    dev = run_device_cell("rosenbrock", 512, "backtracking_wolfe",
                          seeds=(42,), use_pallas=False)
    assert dev["statuses"] == ["converged"]
    cpu = run_cpu_cell("rosenbrock", 512, "backtracking_wolfe", seeds=(42,))
    assert cpu["statuses"] == ["converged"]
    ratio = dev["mean_iterations"] / cpu["mean_iterations"]
    assert 0.5 <= ratio <= 2.0, (dev["mean_iterations"], cpu["mean_iterations"])


def test_run_protocol_quick_grid_and_report(tmp_path):
    out = tmp_path / "ref.json"
    # isolate=False: in-process CPU-oracle cells (no child processes).
    report = run_protocol(problem="quadratic", dims=(256, 512),
                          seeds=(42, 365), cpu=True, device=True,
                          cpu_budget_s=60.0, out=str(out), quick=True,
                          isolate=False)
    # quick: first dim only, first 2 seeds, 4 strategies x 3 backends
    # (device-f32 verbatim parallel cfg, device-f32 no-rescue, cpu oracle).
    assert len(report["cells"]) == 12
    assert {c["d"] for c in report["cells"]} == {256}
    backends = {c["backend"] for c in report["cells"] if "backend" in c}
    assert {"device-f32-parcfg", "device-f32-norescue",
            "cpu-native-f64"} <= backends
    assert out.exists()
    md = markdown_table(report)
    assert md.count("\n") == 13  # header + rule + 12 rows
    assert "Armijo Backtracking" in md and "cpu-native-f64" in md


def test_markdown_table_renders_error_and_skip_rows():
    report = {"cells": [
        {"d": 10, "strategy": "S", "backend": "device", "error": "boom"},
        {"d": 10, "strategy": "S", "backend": "cpu", "skipped": "budget"},
    ]}
    md = markdown_table(report)
    assert "boom" in md and "skipped (budget)" in md


def test_norescue_recovers_where_parallel_quirk_overflows():
    """The numerical finding the protocol table encodes: from U(-1000,1000)
    starts in f32, the parallel reference's alpha-underflow rescue (step 0.5,
    parallel line_search.cpp:38-41) overflows and kills plain-Armijo cells,
    while disabling it (sequential underflow semantics) follows the f64
    oracle's recovery path and converges to the GPU tolerance."""
    quirky = run_device_cell("rosenbrock", 512, "backtracking", seeds=(42,),
                             use_pallas=False)
    assert quirky["statuses"] == ["line_search_failed"]
    clean = run_device_cell("rosenbrock", 512, "backtracking", seeds=(42,),
                            use_pallas=False, no_rescue=True)
    assert clean["statuses"] == ["converged"]
    assert clean["max_final_g_norm"] <= 1e-1


def test_quick_grid_has_no_f64_probe_and_speedups_skip_failed_cells(tmp_path):
    """(a) f64 device cells run only when asked for (device_f64); (b) the
    per-iteration speedup summary keys on STATUS: line_search_failed-at-
    iteration-1 cells are excluded, but a quadratic legitimately converging
    at 1 iteration IS a real rate and must be summarized."""
    report = run_protocol(problem="quadratic", dims=(256,), seeds=(42,),
                          cpu=True, device=True, cpu_budget_s=60.0,
                          out=str(tmp_path / "r.json"), quick=True,
                          isolate=False)
    assert not any(c["backend"].startswith("device-f64")
                   for c in report["cells"])
    for s in report["per_iteration_speedups"]:
        # every summarized pair comes from cells that converged or hit
        # max_iters — never from failed-at-iteration-1 cells
        for backend in ("device-f32-norescue", "cpu-native-f64"):
            c = next(c for c in report["cells"]
                     if c["d"] == s["d"] and c["strategy"] == s["strategy"]
                     and c["backend"] == backend)
            assert any(st in ("converged", "max_iters")
                       for st in c["statuses"])
        # (the ratio's magnitude is dispatch-dominated at d=256 — only the
        # provenance matters here)
    # converged-at-1-iteration quadratic cells are summarized, not dropped
    assert len(report["per_iteration_speedups"]) == 4


def test_cell_ran_requires_every_seed_to_iterate():
    """iters_per_s is a mean over ALL seeds: a cell where one seed hit
    max_iters but the rest failed at iteration 1 would publish a ratio
    diluted by dispatch-dominated walls — _cell_ran excludes it."""
    from tpu_lbfgs.bench.reference_protocol import _cell_ran

    good = {"iters_per_s": 100.0, "statuses": ["converged", "max_iters"]}
    mixed = {"iters_per_s": 100.0,
             "statuses": ["line_search_failed"] * 7 + ["max_iters"]}
    empty = {"iters_per_s": 100.0, "statuses": []}
    skipped = {"skipped": "budget"}
    assert _cell_ran(good)
    assert not _cell_ran(mixed)
    assert not _cell_ran(empty)
    assert not _cell_ran(skipped)


def test_cell_rate_keeps_mixed_cells_partial_data():
    """_cell_rate (ADVICE r3): a mixed cell's iterated seeds contribute a
    real rate instead of the whole cell being discarded; fully-failed and
    skipped cells still yield None."""
    from tpu_lbfgs.bench.reference_protocol import _cell_rate

    clean = {"iters_per_s": 100.0, "statuses": ["converged", "max_iters"]}
    mixed = {"iters_per_s": 5.0,
             "statuses": ["line_search_failed", "max_iters"],
             "per_seed_wall_s": [0.004, 10.0],
             "per_seed_iterations": [1, 1000]}
    dead = {"iters_per_s": 3.0,
            "statuses": ["line_search_failed", "line_search_failed"],
            "per_seed_wall_s": [0.004, 0.004],
            "per_seed_iterations": [1, 1]}
    skipped = {"skipped": "budget"}
    assert _cell_rate(clean) == (100.0, 2)
    rate, used = _cell_rate(mixed)
    assert used == 1 and abs(rate - 100.0) < 1e-9   # only the iterated seed
    assert _cell_rate(dead) == (None, 0)
    assert _cell_rate(skipped) == (None, 0)


def test_f64_device_cell_runs_in_process():
    """The f64 sequential-config device cell (native f64 on the GPU) runs
    the whole solve as one jitted program in this process and converges to
    the sequential reference's tolerance; the x64 flag is restored after."""
    import jax

    before = jax.config.jax_enable_x64
    cell = run_device_cell("rosenbrock", 2048, "backtracking", seeds=(42,),
                           dtype="float64", budget_s=120.0,
                           use_pallas=False, x0_range=(-2.0, 2.0))
    assert jax.config.jax_enable_x64 == before
    assert cell["backend"] == "device-f64-seqcfg-scaled"
    assert cell["statuses"] == ["converged"]
    assert cell["max_final_g_norm"] <= 1e-8
    assert cell["compile_s"] > 0 and cell["seeds_run"] == 1
