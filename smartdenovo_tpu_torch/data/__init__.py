"""Packed read store (copy of smartdenovo_tpu/data)."""
