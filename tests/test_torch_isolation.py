"""dssm_tpu_torch stands alone: no module of it, nor chip_smoke.py, imports
jax, optax, flax, orbax or dssm_tpu, and every module imports with them made
unimportable."""

import ast
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "dssm_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "optax", "flax", "orbax", "dssm_tpu")


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
    mods = _modules()
    for name in ("kernels.gather", "kernels.joint", "kernels.loss",
                 "loss.cosine_softmax", "train.state", "train.sparse_update",
                 "train.loop", "io.checkpoint", "io.metrics", "cli.train"):
        assert f"dssm_tpu_torch.{name}" in mods
    assert len(_port_files()) > 30


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
        f"for m in {FORBIDDEN!r}:\n"
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


def test_not_ported_messages_name_roadmap_items():
    """Every "(ROADMAP.md, Queue N: name)" in the port names a bold item
    title of that queue as ROADMAP.md stands."""
    with open(os.path.join(REPO, "ROADMAP.md")) as f:
        roadmap = f.read()
    titles = {}
    for n, body in re.findall(r"### Queue (\d)(.*?)(?=\n### |\Z)", roadmap,
                              re.S):
        titles[n] = [re.sub(r"\s+", " ", t).lower() for t in
                     re.findall(r"^\s*\d+\. \*\*(.+?)\*\*", body, re.S | re.M)]
    assert len(titles["1"]) >= 8 and len(titles["2"]) >= 4
    refs = []
    for path in _port_files():
        with open(path) as f:
            text = re.sub(r'"\s*\n\s*#?\s*f?"?', "", f.read())
        refs += [(path, n, name) for n, name in re.findall(
            r"ROADMAP\.md, Queue (\d): ?([^)\"]+)\)", text)]
    assert len(refs) >= 12
    for path, n, name in refs:
        name = re.sub(r"\s+", " ", name).strip().lower()
        assert any(name in t for t in titles[n]), (
            f"{os.path.relpath(path, REPO)}: Queue {n} has no item "
            f"titled {name!r}")
