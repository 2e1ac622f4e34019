from lsbench_tpu_torch.harness.bench import BenchRecord, run_bench

__all__ = ["BenchRecord", "run_bench"]
