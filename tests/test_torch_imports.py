"""vg_tpu_torch imports torch and nothing of JAX or vg_tpu: every module
of the package, and chip_smoke.py's own imports, in a fresh interpreter
(this test process already holds JAX through conftest.py), then the
command line and the one-rank dry run of the sharded steps run in it (the
spawned rank checks its own modules); and no source names such an import,
by statement, `__import__` or `importlib.import_module`."""
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent

PROBE = r"""
import importlib, pkgutil, sys
import vg_tpu_torch
# a package's __main__ runs its command line when imported: the CLI is
# driven below instead
names = [m.name for m in pkgutil.walk_packages(vg_tpu_torch.__path__,
                                               "vg_tpu_torch.")
         if not m.name.endswith(".__main__")]
for name in names:
    importlib.import_module(name)
import chip_smoke
# chip_smoke imports the port lazily, phase by phase: pull those in too
import vg_tpu_torch.io.gam, vg_tpu_torch.map.paired, vg_tpu_torch.native
import vg_tpu_torch.parallel.pipeline, vg_tpu_torch.map.memmapper
import vg_tpu_torch.surject.surjector, vg_tpu_torch.call.caller
import vg_tpu_torch.sim.simulator, vg_tpu_torch.io.bam
# the command line: what its subcommands import runs only when they run
import contextlib, io, os, tempfile
from vg_tpu_torch.cli.main import build_parser, main
with contextlib.redirect_stdout(io.StringIO()) as out:
    assert main(["version"]) == 0
assert out.getvalue().startswith("vg_tpu_torch ")
build_parser()
with tempfile.TemporaryDirectory() as d:
    with open(os.path.join(d, "ref.fa"), "w") as f:
        f.write(">chr1\n" + "ACGTTGCA" * 40 + "\n")
    with contextlib.redirect_stderr(io.StringIO()):
        assert main(["construct", "-r", os.path.join(d, "ref.fa"),
                     "-o", os.path.join(d, "g.gfa")]) == 0
    assert open(os.path.join(d, "g.gfa")).read().startswith("H\t")
# the sharded steps in a spawned rank, which raises if it imported jax
from vg_tpu_torch.parallel.dryrun import main as dryrun_main
with contextlib.redirect_stdout(io.StringIO()) as out:
    assert dryrun_main(["--nproc", "1", "--device", "cpu"]) == 0
assert "OK on 1 ranks" in out.getvalue()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "vg_tpu"))
print(len(names))
print(" ".join(bad))
"""


def test_port_imports_no_jax_and_no_vg_tpu():
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    n_modules, bad = (out.stdout.splitlines() + ["", ""])[:2]
    assert int(n_modules) >= 98, out.stdout
    assert bad == "", f"imported: {bad}"


FORBIDDEN = ("jax", "jaxlib", "vg_tpu")
# __import__("...") and importlib.import_module("...") by a literal name
DYNAMIC = re.compile(r"""(?:__import__|import_module)\(\s*["']([\w.]+)""")


def _offends(line: str) -> bool:
    words = line.split()
    if (len(words) >= 2 and words[0] in ("import", "from")
            and words[1].split(".")[0] in FORBIDDEN):
        return True
    return any(m.split(".")[0] in FORBIDDEN for m in DYNAMIC.findall(line))


def test_port_sources_name_no_jax_import():
    """No module of the port, and not chip_smoke.py, imports JAX or
    vg_tpu, even lazily inside a function (the subprocess above only sees
    what importing runs), by statement, __import__ or import_module."""
    offenders = []
    paths = [*(ROOT / "vg_tpu_torch").rglob("*.py"), ROOT / "chip_smoke.py"]
    for path in paths:
        for n, line in enumerate(path.read_text().splitlines(), 1):
            if _offends(line):
                offenders.append(f"{path.relative_to(ROOT)}:{n}: {line}")
    assert not offenders, "\n".join(offenders)


def test_source_scan_flags_dynamic_imports():
    """The scan catches the forms it is meant to: vg_tpu/cli/main.py:101
    builds a VcfFile through __import__("vg_tpu.io.vcf", ...), which a
    verbatim copy would have carried into the port."""
    for line in ('__import__("vg_tpu.io.vcf", fromlist=["VcfFile"])',
                 "  x = importlib.import_module('jax.numpy')",
                 'import_module("jaxlib")', "import jax.numpy as jnp",
                 "from vg_tpu.io import gam"):
        assert _offends(line), line
    for line in ('__import__("vg_tpu_torch.io.vcf")',
                 "importlib.import_module(name)", "import torch",
                 "from ..io.vcf import VcfFile", '"jax" in text'):
        assert not _offends(line), line
