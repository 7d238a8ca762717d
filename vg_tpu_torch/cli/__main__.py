"""Copied from vg_tpu/cli/__main__.py."""
import sys

from .main import main

sys.exit(main())
