"""The benchmark of the PyTorch / CUDA port (``repro_torch``): one command,
``perfbench/run.py``, runs one cell; ``BENCHMARK.json`` at the checkout's
root lists the cells, configurations and metrics, each a file here."""
