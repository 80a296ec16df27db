"""Utilities of draco_tpu_torch (port of ``draco_tpu.util``)."""
