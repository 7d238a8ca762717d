"""Copied from vg_tpu/eval/__init__.py."""
