"""Configuration properties (host-only, copied from draco_tpu.core)."""
