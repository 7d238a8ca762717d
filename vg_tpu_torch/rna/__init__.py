"""Copied from vg_tpu/rna/__init__.py."""
