from .harness import (
    REFERENCE_GPU_SPEEDUP,
    REFERENCE_SEEDS,
    BenchResult,
    bench_batch,
    bench_cpu_native,
    bench_device,
    device_record,
    require_gpu,
    time_to_tolerance,
)
from .scaling import bench_sharded, scaling_sweep
