"""The benchmark of the PyTorch and CUDA port: `run.py` is its command;
cells, configurations, metric readers and references are found by name
(`cells.py`)."""
