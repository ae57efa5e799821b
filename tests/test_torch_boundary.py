"""Import boundary of the port: ``src/repro_torch`` and ``chip_smoke.py``
import neither ``jax`` nor the JAX package ``repro``, and every kernel the
port launches has its CUDA source in the package."""

import ast
import pathlib

import pytest
import test_torch_threads  # noqa: F401  (one thread budget per worker)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    return [pytest.param(f, id=str(f.relative_to(ROOT))) for f in files]


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0], node.lineno


@pytest.mark.parametrize("path", _sources())
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(mod, line) for mod, line in _imported_roots(tree)
           if mod in FORBIDDEN]
    assert not bad, f"{path}: imports {bad}"


def test_cuda_sources_present():
    from repro_torch.kernels.block_circulant import kernel

    csrc = PORT / "kernels" / "block_circulant" / "csrc"
    assert kernel.SOURCES == {"bc_dw": csrc / "bc_dw.cu",
                              "bc_matmul": csrc / "bc_matmul.cu"}
    assert sorted(p.name for p in csrc.glob("*.cu")) == ["bc_dw.cu",
                                                         "bc_matmul.cu"]
    assert sorted(kernel.LAUNCHES) == sorted(kernel.SOURCES)
    for name, entry in (("bc_matmul", "bc_matmul_forward"),
                        ("bc_dw", "bc_dw_launch")):
        assert f"extern \"C\" int {entry}" in kernel.SOURCES[name].read_text()
