"""The benchmark of draco_tpu_torch: one cell a run, driven by data (see run.py)."""
