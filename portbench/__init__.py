"""The PyTorch / CUDA port's benchmark (``bench.py``); it drives
``groundgrid_torch`` and never imports JAX or ``groundgrid_tpu``."""
