"""Copied from vg_tpu/surject/__init__.py."""
