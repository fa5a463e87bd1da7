"""The port stands alone: nothing under ``src/repro_torch/`` and nothing in
``chip_smoke.py`` or ``tools/`` imports JAX or the JAX package ``repro``
(checked on the syntax tree, so an import inside a function counts too)."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"] + sorted((ROOT / "tools").glob("*.py"))
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
    pkg = ROOT / "src" / "repro_torch"
    for path in ("sim/__init__.py", "sim/tta.py", "core/compression.py",
                 "core/ring.py", "core/ubt.py", "sim/netsim.py",
                 "obs/trace.py", "obs/report.py", "runtime/control.py",
                 "core/recovery.py", "train/checkpoint.py",
                 "models/parallel.py", "launch/mesh.py"):
        assert pkg / path in FILES
    assert "torch" in _imported(ROOT / "src" / "repro_torch" / "kernels"
                                / "fwht" / "ops.py")


def test_kernel_sources_are_in_the_package():
    from repro_torch.kernels import build
    kdir = ROOT / "src" / "repro_torch" / "kernels"
    srcs = sorted(p.name for p in kdir.glob("*/csrc/*.cu"))
    assert srcs == ["dequant_mean.cu", "fwht.cu", "grid_quant.cu",
                    "ht_quant.cu", "masked_mean.cu", "threefry.cu"]
    assert sorted(build.sources()) == ["dequant_mean", "fwht", "grid_quant",
                                       "ht_quant", "masked_mean", "threefry"]
    assert [p.relative_to(kdir).as_posix() for p in build.headers()] == \
        ["fwht/csrc/butterfly.cuh"]
    # every include of a source names a header of the package
    for src in kdir.glob("*/csrc/*.cu"):
        for line in src.read_text().splitlines():
            if line.startswith('#include "'):
                inc = (src.parent / line.split('"')[1]).resolve()
                assert inc in [h.resolve() for h in build.headers()], line


def test_library_hash_covers_shared_headers(tmp_path, monkeypatch):
    """Editing a shared header renames every library built from a source,
    so a stale build is never loaded."""
    import shutil

    from repro_torch.kernels import build
    kdir = tmp_path / "kernels"
    shutil.copytree(ROOT / "src" / "repro_torch" / "kernels", kdir,
                    ignore=shutil.ignore_patterns("*.py", "__pycache__"))
    monkeypatch.setattr(build, "KERNELS_DIR", kdir)
    srcs = {p.stem: p for p in kdir.glob("*/csrc/*.cu")}
    before = {name: build._target(p).name for name, p in srcs.items()}
    hdr = kdir / "fwht" / "csrc" / "butterfly.cuh"
    hdr.write_text(hdr.read_text() + "\n// edited\n")
    after = {name: build._target(p).name for name, p in srcs.items()}
    assert all(before[n] != after[n] for n in srcs)
    assert all(after[n].startswith(n + "-") for n in srcs)


def test_ptxas_report_gives_registers_by_kernel():
    """``build.registers`` reads each entry's registers a thread from an
    ``nvcc -Xptxas -v`` log, as chip_smoke.py reports them."""
    from repro_torch.kernels import build
    log = """ptxas info    : Compiling entry function '_Z1aILi10EEv' for 'sm_90a'
ptxas info    : Function properties for _Z1aILi10EEv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 56 registers, used 1 barriers, 8 bytes cmem[0]
ptxas info    : Compiling entry function '_Z1bv' for 'sm_90a'
ptxas info    : Used 168 registers, used 1 barriers
"""
    assert build.registers(log) == {"_Z1aILi10EEv": 56, "_Z1bv": 168}
    assert build.registers("") == {}
