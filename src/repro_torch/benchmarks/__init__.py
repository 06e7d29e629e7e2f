"""The paper's Fig. 8-10 sweeps for the PyTorch port (``python -m
repro_torch.benchmarks.fig9_throughput`` and so on)."""
