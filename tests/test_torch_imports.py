"""The port stands alone: nothing under ``src/repro_torch/`` and nothing in
``chip_smoke.py`` imports JAX or the JAX package ``repro`` (checked on the
syntax tree, so an import inside a function counts too)."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported(path: pathlib.Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_jax_or_reference_import(path):
    bad = _imported(path) & set(FORBIDDEN)
    assert not bad, f"{path} imports {sorted(bad)}"


def test_scan_sees_the_package():
    assert len(FILES) > 20
    assert "torch" in _imported(ROOT / "src" / "repro_torch" / "kernels"
                                / "fwht" / "ops.py")


def test_kernel_sources_are_in_the_package():
    srcs = sorted(p.name for p in (ROOT / "src" / "repro_torch" / "kernels")
                  .glob("*/csrc/*.cu"))
    assert srcs == ["fwht.cu", "masked_mean.cu"]
