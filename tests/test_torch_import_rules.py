"""Import rules of the PyTorch port (``waifu2x_tensorrt_tpu_torch``).

An AST scan, because the test process has jax loaded already (the conftest
imports it), so ``sys.modules`` cannot tell who imported it:
- no module of the port, and not ``chip_smoke.py`` or the measurement
  scripts under ``tools/``, imports jax, flax or the JAX package;
- ``triton``, ``cv2`` and ``PIL`` are imported only inside functions (the
  card's machine need not have OpenCV or Pillow);
- importing every module of the port builds nothing, neither the CUDA
  kernels nor the native framepipe;
- the port builds and loads its own framepipe, never the JAX package's
  ``native/build/``;
- the layers import downwards only: no module under ``ops/`` imports from
  ``models/``, ``engine/`` or the CLI, no module under ``models/`` from
  ``engine/`` or the CLI; the program store (``engine/exe_cache.py``)
  imports no kernel wrapper and names none (it reads ``ops.kernels()``).
"""

import ast
import importlib
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "waifu2x_tensorrt_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "waifu2x_tensorrt_tpu")
SOURCES = (sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
           + sorted((ROOT / "tools").glob("*.py")))


def _imports(tree):
    """(module name, is_top_level) for every import statement."""
    top = set(id(n) for n in tree.body)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, id(node) in top
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module, id(node) in top


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [name for name, _ in _imports(tree) if _forbidden(name)]
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_triton_only_inside_functions(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    # top-level statements, plus those of class bodies (run at import)
    eager = list(tree.body)
    for node in tree.body:
        if isinstance(node, ast.ClassDef):
            eager.extend(node.body)
    for node in eager:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else [node.module or ""])
            assert not any(n.split(".")[0] == "triton" for n in names), \
                f"{path.name} imports triton at import time"


LAZY = ("cv2", "PIL")


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_optional_modules_only_inside_functions(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    eager = list(tree.body)
    for node in tree.body:
        if isinstance(node, ast.ClassDef):
            eager.extend(node.body)
    for node in eager:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else [node.module or ""])
            assert not any(n.split(".")[0] in LAZY for n in names), \
                f"{path.name} imports {names} at import time"


# a package of the port: the packages and modules it may not import
ABOVE = {"ops": ("models", "engine", "cli"), "models": ("engine", "cli")}


def _full_imports(tree):
    """Every module or name an import statement brings in, dotted."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield from (f"{node.module}.{alias.name}"
                        for alias in node.names)


@pytest.mark.parametrize(
    "path", [p for d in ABOVE for p in sorted((PKG / d).rglob("*.py"))],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_layers_import_downwards(path):
    above = [f"{PKG.name}.{a}" for a in ABOVE[path.relative_to(PKG).parts[0]]]
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [name for name in _full_imports(tree)
           if any(name == a or name.startswith(a + ".") for a in above)]
    assert not bad, f"{path.name} imports {bad}"


def test_program_store_names_no_kernel():
    from waifu2x_tensorrt_tpu_torch import ops

    tree = ast.parse((PKG / "engine" / "exe_cache.py").read_text())
    assert not [name for name in _full_imports(tree)
                if name.startswith(f"{PKG.name}.ops.")]
    names = ({n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
             | {n.attr for n in ast.walk(tree)
                if isinstance(n, ast.Attribute)})
    wrappers = {w.__name__ for w in ops.kernels().values()}
    assert len(wrappers) == 11 and not names & wrappers


def test_framepipe_is_the_ports_own():
    from waifu2x_tensorrt_tpu_torch.utils import native_build

    assert native_build.SRC == PKG / "native" / "framepipe.cpp"
    assert native_build.BUILD_DIR == ROOT / "build" / "framepipe"
    assert native_build.lib_path().parent == native_build.BUILD_DIR
    pattern = re.compile(r"native['\"]?\s*[/,]\s*['\"]?build")
    for path in sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        assert not pattern.search(path.read_text()), \
            f"{path.name} names the JAX package's native/build/"


def test_forbidden_name_check_is_exact():
    assert _forbidden("jax.numpy") and _forbidden("waifu2x_tensorrt_tpu.ops")
    assert not _forbidden("waifu2x_tensorrt_tpu_torch.ops")
    assert not _forbidden("jaxtyping")


def _module_names():
    for path in sorted(PKG.rglob("*.py")):
        name = ".".join(path.relative_to(ROOT).with_suffix("").parts)
        yield name[: -len(".__init__")] if name.endswith(".__init__") \
            else name


def test_every_module_imports():
    for name in _module_names():
        importlib.import_module(name)


def test_importing_builds_nothing():
    """In a fresh interpreter: importing every module of the port loads no
    kernel library, tries no framepipe build and writes nothing under
    build/kernels/."""
    from waifu2x_tensorrt_tpu_torch.ops import build

    before = (sorted(build.BUILD_DIR.glob("*"))
              if build.BUILD_DIR.exists() else [])
    code = "\n".join(
        [f"import {n}" for n in _module_names()]
        + ["from waifu2x_tensorrt_tpu_torch.ops import build",
           "assert build._lib is None",
           "from waifu2x_tensorrt_tpu_torch.utils import native_build",
           "assert native_build._cached is None",
           "assert not native_build._load_failed"])
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    after = (sorted(build.BUILD_DIR.glob("*"))
             if build.BUILD_DIR.exists() else [])
    assert after == before
