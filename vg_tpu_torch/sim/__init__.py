"""Copied from vg_tpu/sim/__init__.py."""
