"""Copied from vg_tpu/call/__init__.py."""
