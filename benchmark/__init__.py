"""Benchmark of the PyTorch and CUDA port (``animate3d_tpu_torch``) on one
NVIDIA H100: ``python benchmark/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout. Every
configuration, traffic mix and per-layer metric is a file of its own that
``run.py`` finds by the name ``BENCHMARK.json`` gives it."""
