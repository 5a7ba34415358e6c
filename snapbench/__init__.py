"""The benchmark of the PyTorch and CUDA SNAP port (``repro_torch``)."""
