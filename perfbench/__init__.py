"""The benchmark of the PyTorch and CUDA port: harness, references, configurations, traffic, readers of per-layer metrics, limits of the check."""
