"""The benchmark of vectordb_tpu_torch on NVIDIA GPUs (see run.py)."""
