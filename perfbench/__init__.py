"""The benchmark of the PyTorch and CUDA port (``repro_torch``): one command
runs one cell of ``BENCHMARK.json`` once.  See ``run.py``."""
