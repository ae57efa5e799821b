"""The kernels' build key, on the CPU (no nvcc needed): each library is
keyed by its source and every header beside it, so an edit to the shared
FFT header (``csrc/bc_fft.cuh``) rebuilds every kernel rather than loading
a stale library."""

import shutil

from repro_torch.kernels.block_circulant import kernel
import test_torch_threads  # noqa: F401  (one thread budget per worker)


def _copy_csrc(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(next(iter(kernel.SOURCES.values())).parent, csrc)
    return {name: csrc / src.name for name, src in kernel.SOURCES.items()}


def test_header_edit_changes_every_key(tmp_path):
    srcs = _copy_csrc(tmp_path)
    headers = sorted(srcs["bc_dw"].parent.glob("*.cuh"))
    assert [h.name for h in headers] == ["bc_fft.cuh"]
    before = {name: kernel._source_key(s) for name, s in srcs.items()}
    assert before == {name: kernel._source_key(s)
                      for name, s in kernel.SOURCES.items()}
    headers[0].write_text(headers[0].read_text() + "// edited\n")
    after = {name: kernel._source_key(s) for name, s in srcs.items()}
    assert all(after[name] != before[name] for name in srcs)


def test_source_edit_changes_only_its_key(tmp_path):
    srcs = _copy_csrc(tmp_path)
    before = {name: kernel._source_key(s) for name, s in srcs.items()}
    srcs["bc_dw"].write_text(srcs["bc_dw"].read_text() + "// edited\n")
    after = {name: kernel._source_key(s) for name, s in srcs.items()}
    assert after["bc_dw"] != before["bc_dw"]
    assert after["bc_matmul"] == before["bc_matmul"]


def test_build_reuses_only_a_library_of_the_current_key(tmp_path,
                                                         monkeypatch):
    """``build`` names each library by its key: a library of the current
    sources and headers is reused without compiling; after a header edit
    its name no longer matches."""
    srcs = _copy_csrc(tmp_path)
    build_dir = tmp_path / "build"
    build_dir.mkdir()
    monkeypatch.setattr(kernel, "SOURCES", srcs)
    monkeypatch.setattr(kernel, "_BUILD_DIR", build_dir)
    libs = {name: build_dir / f"{name}-{kernel._source_key(s)}.so"
            for name, s in srcs.items()}
    for lib in libs.values():
        lib.write_bytes(b"")
    assert kernel.build() == {name: (lib, "") for name, lib in libs.items()}
    header = srcs["bc_dw"].parent / "bc_fft.cuh"
    header.write_text(header.read_text() + "// edited\n")
    for name, s in srcs.items():
        assert not (build_dir / f"{name}-{kernel._source_key(s)}.so").exists()
