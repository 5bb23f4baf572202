"""The benchmark of the PyTorch and CUDA port (``repro_torch``): one cell
a run, driven by ``run.py``; see README.md."""
