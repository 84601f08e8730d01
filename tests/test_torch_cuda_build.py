"""The port's kernel build names each library by everything that goes
into it: the source, every header under ``csrc/`` and the flags. An
edited header must rebuild, or a source that includes it would reuse a
stale library."""

import shutil

import pytest

from dpu_operator_tpu_torch import cuda_build


def test_library_name_follows_source_headers_and_flags(tmp_path,
                                                       monkeypatch):
    monkeypatch.setattr(cuda_build, "CSRC_DIR", tmp_path)
    (tmp_path / "kern.cu").write_text('#include "proto.cuh"\n')
    header = tmp_path / "proto.cuh"
    header.write_text("// v1\n")
    first = cuda_build.library_path("kern")
    assert first == cuda_build.library_path("kern")
    assert first.parent == cuda_build.BUILD_DIR
    assert first.name.startswith("libkern_") and first.suffix == ".so"

    header.write_text("// v2\n")
    second = cuda_build.library_path("kern")
    assert second != first

    (tmp_path / "other.cuh").write_text("// new header\n")
    third = cuda_build.library_path("kern")
    assert third not in (first, second)

    (tmp_path / "kern.cu").write_text('#include "proto.cuh"\n// edit\n')
    assert cuda_build.library_path("kern") not in (first, second, third)

    monkeypatch.setattr(cuda_build, "NVCC_FLAGS",
                        cuda_build.NVCC_FLAGS + ["-lineinfo"])
    assert cuda_build.library_path("kern") != third


@pytest.mark.parametrize("name", ["ring_attn", "ring_collectives"])
def test_ring_sources_rebuild_when_the_protocol_header_changes(
        name, tmp_path, monkeypatch):
    """Both ring sources include ``ring_stream.cuh``: an edit to the
    protocol must give each of them a new library."""
    real = cuda_build.CSRC_DIR
    assert '#include "ring_stream.cuh"' in (real / f"{name}.cu").read_text()
    csrc = tmp_path / "csrc"
    shutil.copytree(real, csrc)
    monkeypatch.setattr(cuda_build, "CSRC_DIR", csrc)
    first = cuda_build.library_path(name)
    assert first.name.startswith(f"lib{name}_")
    with open(csrc / "ring_stream.cuh", "a") as f:
        f.write("// edited\n")
    assert cuda_build.library_path(name) != first
