"""The ray_tpu_torch command line (``python -m ray_tpu_torch``)."""
