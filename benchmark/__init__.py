"""The benchmark of the PyTorch and CUDA port (``difffe_tpu_torch``).

``python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON
line; ``benchmark/control.py`` takes the readings that the limits of
``correct`` are set from.
"""
