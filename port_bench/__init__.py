"""The benchmark of stt_tpu_torch on one NVIDIA H100 (see run.py)."""
