"""The port's public names against the JAX package's, on the CPU.

Each JAX subpackage ``__init__.py`` (``compress``, ``core``, ``models``,
``train``) is parsed with ``ast``, so that this file imports nothing of the
JAX package: the port's ``__init__`` of the same subpackage exports every
name it re-exports, as the object of the port module of the same name. No
JAX name is left out of the port (none is TPU-only). Both packages carry
``__version__``; the README's usage imports; and in a fresh process each
subpackage imports first without an import cycle and without JAX.
"""

import ast
import importlib
import subprocess
import sys
from pathlib import Path

import pytest

import gaussianimage_plus_tpu_torch

ROOT = Path(__file__).resolve().parents[1]
SUBPACKAGES = ("compress", "core", "models", "train")


def _jax_init(sub: str = "") -> ast.Module:
    return ast.parse((ROOT / "gaussianimage_plus_tpu" / sub / "__init__.py").read_text())


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_exports_the_jax_names(sub):
    port = importlib.import_module(f"gaussianimage_plus_tpu_torch.{sub}")
    names = 0
    for node in _jax_init(sub).body:
        if isinstance(node, ast.ImportFrom):
            module = importlib.import_module(f"gaussianimage_plus_tpu_torch.{sub}.{node.module}")
            for alias in node.names:
                assert getattr(port, alias.name, None) is getattr(module, alias.name), (
                    f"{sub}: {alias.name} of {node.module}")
                names += 1
    assert names > 0


def test_version_and_readme_usage():
    version = [ast.literal_eval(n.value) for n in _jax_init().body
               if isinstance(n, ast.Assign) and n.targets[0].id == "__version__"]
    assert version == [gaussianimage_plus_tpu_torch.__version__] == ["0.1.0"]
    from gaussianimage_plus_tpu_torch.models import GaussianConfig, render  # noqa: F401


@pytest.mark.parametrize("sub", SUBPACKAGES + ("parallel",))
def test_subpackage_imports_first_without_jax(sub):
    code = (f"import sys, gaussianimage_plus_tpu_torch.{sub}; "
            "assert not any(m == 'jax' or m.startswith(('jax.', 'gaussianimage_plus_tpu.')) "
            "for m in sys.modules), 'JAX imported'")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)
