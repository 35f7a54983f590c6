"""The benchmark of waldboost_tpu_torch on NVIDIA GPUs (see run.py)."""
