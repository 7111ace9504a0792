"""dssm_tpu_torch stands alone: no module of it, nor chip_smoke.py, imports
jax, orbax or dssm_tpu, and every module imports with jax made unimportable."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "dssm_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "orbax", "dssm_tpu")


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PKG):
        files += [os.path.join(root, n) for n in sorted(names)
                  if n.endswith(".py")]
    return files


def _modules():
    mods = []
    for path in _port_files()[1:]:
        rel = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
        mods.append(rel[: -len(".__init__")] if rel.endswith("__init__")
                    else rel)
    return mods


def test_port_has_modules():
    assert "dssm_tpu_torch.kernels.gather" in _modules()
    assert len(_port_files()) > 20


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_forbidden_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in FORBIDDEN, f"{path}:{node.lineno} imports {name}"


def test_every_module_imports_without_jax():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'orbax', 'dssm_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import importlib\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "print('ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "ok"
