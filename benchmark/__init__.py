"""The benchmark of the PyTorch / CUDA port (``sputnik_tpu_torch``) on one
NVIDIA H100: ``python3 benchmark/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` runs one cell of ``BENCHMARK.json`` once."""
