"""The benchmark of ``ray_tpu_torch``, the PyTorch and CUDA port: one
command runs one cell once (``portbench/run.py``)."""
