"""The benchmark of the PyTorch and CUDA port (``python3 -m portbench.run``)."""
