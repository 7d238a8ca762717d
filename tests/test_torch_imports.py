"""vg_tpu_torch imports torch and nothing of JAX or vg_tpu: every module
of the package, and chip_smoke.py's own imports, in a fresh interpreter
(this test process already holds JAX through conftest.py)."""
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent

PROBE = r"""
import importlib, pkgutil, sys
import vg_tpu_torch
names = [m.name for m in pkgutil.walk_packages(vg_tpu_torch.__path__,
                                               "vg_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
# chip_smoke imports the port lazily, phase by phase: pull those in too
import vg_tpu_torch.io.gam, vg_tpu_torch.map.paired, vg_tpu_torch.native
import vg_tpu_torch.parallel.pipeline, vg_tpu_torch.map.memmapper
import vg_tpu_torch.surject.surjector, vg_tpu_torch.call.caller
import vg_tpu_torch.sim.simulator, vg_tpu_torch.io.bam
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
    assert int(n_modules) >= 65, out.stdout
    assert bad == "", f"imported: {bad}"


def test_port_sources_name_no_jax_import():
    """No module of the port, and not chip_smoke.py, imports JAX or
    vg_tpu, even lazily inside a function (the subprocess above only sees
    what importing runs)."""
    offenders = []
    paths = [*(ROOT / "vg_tpu_torch").rglob("*.py"), ROOT / "chip_smoke.py"]
    for path in paths:
        for n, line in enumerate(path.read_text().splitlines(), 1):
            words = line.split()
            if (len(words) >= 2 and words[0] in ("import", "from")
                    and words[1].split(".")[0] in ("jax", "jaxlib",
                                                   "vg_tpu")):
                offenders.append(f"{path.relative_to(ROOT)}:{n}: {line}")
    assert not offenders, "\n".join(offenders)
