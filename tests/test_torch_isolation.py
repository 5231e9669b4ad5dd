"""The port stands alone: importing every ``repro_torch`` module loads no
``jax`` and no module of the reference package, and no port source (nor
``chip_smoke.py``) imports either."""
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b"
                       r"|import\s+repro\.|from\s+repro\b|from\s+repro\.)",
                       re.MULTILINE)


def _port_modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT / "src").with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_importing_the_port_loads_no_jax_and_no_reference():
    mods = list(_port_modules())
    assert "repro_torch.launch.serve" in mods and "repro_torch.convert" in mods
    assert "repro_torch.distributed.sharding" in mods
    assert "repro_torch.core.vbyte.device_encode" in mods
    assert {"repro_torch.launch.dryrun", "repro_torch.launch.roofline_math",
            "repro_torch.launch.cost_model"} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'repro' or m.startswith('repro.')]\n"
            "print(len(bad), bad[:5])\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_source_imports_jax_or_the_reference():
    sources = list(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert (ROOT / "chip_smoke.py").exists()
    for path in sources:
        hit = FORBIDDEN.search(path.read_text())
        assert hit is None, f"{path.relative_to(ROOT)}: {hit.group(0).strip()}"
