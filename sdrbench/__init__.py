"""The benchmark of leansdr_tpu_torch: see run.py and BENCHMARK.json."""
