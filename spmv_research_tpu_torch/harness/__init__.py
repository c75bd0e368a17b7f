from .config import BenchConfig
from .metrics import ErrorMetrics, error_metrics, check_accuracy, EPSILON_GATE
from .bench import (
    BenchResult, bench_spmv, csv_labels, csv_row_real, csv_row_synthetic,
)
from .workloads import (BenchGateError, WorkloadResult, bench_cg,
                        bench_sddmm, bench_spgemm, bench_spmm,
                        bench_trisolve)
from .sweep import SweepDoneLog, load_matrix, run_sweep
