"""The benchmark of stereo_tpu_torch (run.py runs one cell)."""
