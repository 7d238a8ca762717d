"""Copied from vg_tpu/cli/__init__.py."""
from .main import main
