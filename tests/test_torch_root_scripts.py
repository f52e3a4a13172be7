"""The root scripts that drive the port, read as source on the CPU.

* ``profile_window_check.py`` reads only what exists: every ``cs.<name>``
  it takes from ``chip_smoke`` is defined there, and every name it imports
  from the port's package is there, so a helper moved out of
  ``chip_smoke.py`` cannot break the tool unseen (it runs on a card only).
* Neither it nor ``chip_smoke.py`` imports JAX or the JAX package.
"""

import ast
import importlib
import importlib.util
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = "semantic_segmentation_of_stylegan2_artifacts_tpu_torch"
JAX_PKG = "semantic_segmentation_of_stylegan2_artifacts_tpu"
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", JAX_PKG)


def _tree(script: str) -> ast.Module:
    return ast.parse((REPO / script).read_text(), filename=script)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)  # constants and functions only: its main is guarded
    return module


def _imported(tree: ast.Module):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_profile_window_check_reads_what_exists():
    tree = _tree("profile_window_check.py")
    cs = _chip_smoke()
    reads = {node.attr for node in ast.walk(tree) if isinstance(node, ast.Attribute)
             and isinstance(node.value, ast.Name) and node.value.id == "cs"}
    assert reads, "the tool reads nothing from chip_smoke"
    assert sorted(name for name in reads if not hasattr(cs, name)) == []
    port_imports = [node for node in ast.walk(tree) if isinstance(node, ast.ImportFrom)
                    and node.module and node.module.startswith(PORT)]
    assert port_imports
    for node in port_imports:
        module = importlib.import_module(node.module)
        for alias in node.names:
            assert hasattr(module, alias.name) or importlib.util.find_spec(
                f"{node.module}.{alias.name}") is not None, (node.module, alias.name)


@pytest.mark.parametrize("script", ["chip_smoke.py", "profile_window_check.py"])
def test_script_imports_no_jax(script):
    bad = [name for name in _imported(_tree(script))
           if name in BANNED or name.startswith(tuple(b + "." for b in BANNED))]
    assert bad == []
