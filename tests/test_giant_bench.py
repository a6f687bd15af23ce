"""Smoke tests for the giant-instance bench cell (bench/giant.py) and the
measurement entry points' device check.

The real sweeps run on the GPU (one process per config); here we check both
driver paths execute and the roofline accounting is self-consistent at a
small d on the CPU backend, and that every measurement entry point refuses
to time the CPU.
"""
import json

import pytest

from tpu_lbfgs.bench.giant import main

H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture
def cpu_measure(monkeypatch):
    """Let the cell run on the CPU: its device check would refuse, and its
    roofline needs a device kind from the peak table.  The numbers are CPU
    numbers, asserted only for arithmetic consistency."""
    from tpu_lbfgs.bench import harness

    monkeypatch.setattr(harness, "require_gpu",
                        lambda: {**harness.device_record(), "kind": H100})


def test_giant_cell_jit_path(capsys, cpu_measure):
    main(["--d", "65536", "--iters", "10", "--repeats", "1"])
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["iters_per_s"] > 0
    roof = row["roofline"]
    assert roof["modeled_passes_per_iter"] > 0
    # achieved = modeled bytes * rate; check the arithmetic holds.
    assert roof["achieved_gbps_on_model"] == pytest.approx(
        roof["modeled_gb_per_iter"] * row["iters_per_s"])
    assert row["device"]["kind"] == H100


def test_giant_cell_donated_path(capsys, cpu_measure):
    main(["--d", "65536", "--iters", "10", "--repeats", "2", "--donate",
          "--history-dtype", "bfloat16"])
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["donated_segments"] is True
    assert row["history_dtype"] == "bfloat16"
    assert len(row["repeat_walls_s"]) == 2
    assert row["iters_per_s"] > 0


def _bench_py_main():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "bench.py")
    spec = importlib.util.spec_from_file_location("bench_script", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main()


@pytest.mark.parametrize("entry", ["harness", "giant", "bench_main",
                                   "bench_py"])
def test_measurement_entry_points_refuse_cpu(entry, monkeypatch):
    """No measurement path falls back to the CPU: each raises before
    timing anything when JAX's first device is not a GPU."""
    from tpu_lbfgs.bench import harness
    from tpu_lbfgs.utils import cache

    monkeypatch.setattr(cache, "enable_compile_cache", lambda: "unused")
    run = {
        "harness": lambda: harness.bench_device(d=1024, iters=2),
        "giant": lambda: main(["--d", "1024", "--iters", "2"]),
        "bench_main": lambda: __import__(
            "tpu_lbfgs.bench.__main__", fromlist=["main"]).main(["--quick"]),
        "bench_py": _bench_py_main,
    }[entry]
    with pytest.raises(RuntimeError, match="needs a GPU"):
        run()
