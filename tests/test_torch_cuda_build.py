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


RING_SOURCES = ["ring_attn", "ring_collectives", "all_to_all",
                "collective_matmul"]


@pytest.mark.parametrize("name", RING_SOURCES)
def test_ring_sources_rebuild_when_the_protocol_header_changes(
        name, tmp_path, monkeypatch):
    """Every source built on ``ring_stream.cuh`` includes it: an edit to
    the protocol or the launcher must give each of them a new library."""
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


@pytest.mark.parametrize("name", RING_SOURCES)
def test_ring_sources_share_the_headers_launcher(name):
    """The cooperative launcher lives once, in ``ring_stream.cuh``: every
    source built on it launches through ``ring::launch_ring`` and keeps no
    launcher of its own."""
    header = (cuda_build.CSRC_DIR / "ring_stream.cuh").read_text()
    assert "int launch_ring(" in header and "struct Ring {" in header
    src = (cuda_build.CSRC_DIR / f"{name}.cu").read_text()
    assert "ring::launch_ring(" in src
    assert "cudaLaunchCooperativeKernel" not in src
    assert "int launch_ring(" not in src and "struct Ring {" not in src


TILE_SOURCES = ["tile_mma", "collective_matmul"]


@pytest.mark.parametrize("name", TILE_SOURCES)
def test_tile_sources_rebuild_when_the_product_header_changes(
        name, tmp_path, monkeypatch):
    """Every matmul kernel multiplies with the one tile product of
    ``tile_product.cuh``: an edit to it must give each a new library."""
    real = cuda_build.CSRC_DIR
    assert '#include "tile_product.cuh"' in (real / f"{name}.cu").read_text()
    csrc = tmp_path / "csrc"
    shutil.copytree(real, csrc)
    monkeypatch.setattr(cuda_build, "CSRC_DIR", csrc)
    first = cuda_build.library_path(name)
    with open(csrc / "tile_product.cuh", "a") as f:
        f.write("// edited\n")
    assert cuda_build.library_path(name) != first


@pytest.mark.parametrize("form", ["void tile_product", "struct Smem",
                                  "void load_stage", "wmma::mma_sync",
                                  "cp.async.cg.shared.global",
                                  "void tile_product_wgmma",
                                  "SmemWgmma {", "wgmma.mma_async.sync",
                                  "cp.async.bulk.tensor",
                                  "mbarrier.try_wait",
                                  "cuTensorMapEncodeTiled",
                                  "void tile_product_tf32x3",
                                  "SmemTf32 {", "uint32_t tf32(",
                                  "void split_mma(",
                                  "mma.sync.aligned.m16n8k8.row.col.f32"
                                  ".tf32.tf32.f32"])
def test_only_the_header_defines_the_tile_product(form):
    """The tile product lives once: no source keeps a copy of its own
    staging, shared-memory layout or tensor-core loop, nor of the TF32
    split that ring attention and the f32 collective matmuls share."""
    assert form in (cuda_build.CSRC_DIR / "tile_product.cuh").read_text()
    for src in sorted(cuda_build.CSRC_DIR.glob("*.cu")):
        assert form not in src.read_text(), src.name


def _body(src, signature):
    """The text of the function whose definition starts with
    ``signature``, to its closing brace at the start of a line."""
    start = src.index(signature)
    return src[start:src.index("\n}\n", start)]


def test_bf16_products_multiply_on_wgmma_and_the_chain_on_wmma():
    """The bf16 collective matmuls and the tile kernel (the burn tile and
    the benchmark matmul) call the TMA-fed wgmma form, and no longer the
    wmma one; the burn chain keeps wmma, so the header keeps that form.
    The f32 collective matmuls call the split-TF32 form, and the f32 FMA
    form and its staging are gone from every source."""
    src = (cuda_build.CSRC_DIR / "collective_matmul.cu").read_text()
    assert "tile::tile_product_wgmma(" in src
    assert "tile::tile_product<" not in src
    assert "tile::tile_product_tf32x3(" in src
    for path in cuda_build.CSRC_DIR.iterdir():
        text = path.read_text()
        for gone in ("tile_product_f32", "load_stage_f32", "SmemF32",
                     "kF32Tile", "kF32BK"):
            assert gone not in text, (path.name, gone)
    mma = (cuda_build.CSRC_DIR / "tile_mma.cu").read_text()
    tile = _body(mma, "    tile_kernel(")
    assert "tile::tile_product_wgmma(" in tile
    assert "tile::tile_product<" not in tile
    chain = _body(mma, "    chain_kernel(")
    assert "tile::tile_product<" in chain
    assert "tile_product_wgmma" not in chain


def test_collective_matmul_kernels_take_their_maps_as_grid_constants():
    """A tensor map must stay where the launch put it: a by-value
    parameter whose address is taken is otherwise copied to local memory,
    where TMA cannot read it. So in every kernel that reads one: the
    collective matmuls' and the tile kernel."""
    for source, kernels in (("collective_matmul.cu",
                             ("ag_matmul_kernel(", "mm_rs_kernel(")),
                            ("tile_mma.cu", ("    tile_kernel(",))):
        src = (cuda_build.CSRC_DIR / source).read_text()
        for kernel in kernels:
            decl = src[src.index(kernel):src.index(")", src.index(kernel))]
            assert "const __grid_constant__" in decl, decl


def test_nvcc_flags_are_unchanged_by_the_tensor_maps():
    """The tensor-map encoder is found through the CUDA runtime
    (cudaGetDriverEntryPoint), so the build links nothing new."""
    assert cuda_build.NVCC_FLAGS == [
        "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-prec-div=true", "-prec-sqrt=true", "-Xptxas", "-v", "-shared",
        "-Xcompiler", "-fPIC"]
    header = (cuda_build.CSRC_DIR / "tile_product.cuh").read_text()
    assert "cudaGetDriverEntryPoint" in header


def test_ptxas_report_is_read_per_kernel():
    """``chip_smoke.ptxas_entries`` pairs each entry function with its
    registers and spills, as the smoke run's no-spill check needs."""
    import chip_smoke

    text = (
        "ptxas info    : Compiling entry function '_Z2k1I13__nv_bfloat16E"
        "vv' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z2k1I13__nv_bfloat16Evv\n"
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 185 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function '_Z2k2IfEvv' for "
        "'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 123 registers, used 1 barriers, 64 bytes smem\n")
    assert chip_smoke.ptxas_entries(text) == {
        "_Z2k1I13__nv_bfloat16Evv": (185, 8, 4), "_Z2k2IfEvv": (123, 0, 0)}


def test_wgmma_build_check_reads_the_tile_kernels():
    """``chip_smoke.check_wgmma_build`` finds the tile kernel's four
    instances (two widths, with and without tanh) in ``tile_mma``'s ptxas
    report and fails on a spill."""
    import chip_smoke

    def entry(width, tanh, spill=0):
        name = (f"_ZN12_GLOBAL__N_111tile_kernelILi{width}ELb{tanh}EEEvN12"
                f"_GLOBAL__N_110TileParamsE")
        return (f"ptxas info    : Compiling entry function '{name}' for "
                f"'sm_90a'\n"
                f"    0 bytes stack frame, {spill} bytes spill stores, "
                f"{spill} bytes spill loads\n"
                f"ptxas info    : Used 168 registers, used 1 barriers\n")

    class Build:
        build_logs = {"tile_mma": "".join(
            entry(w, t) for w in (128, 256) for t in (0, 1))}

    assert chip_smoke.check_wgmma_build(Build, "tile_mma") == (
        "tile 128x128 168 registers, 0 spills, tile 128x128 tanh 168 "
        "registers, 0 spills, tile 128x256 168 registers, 0 spills, "
        "tile 128x256 tanh 168 registers, 0 spills")
    Build.build_logs = {"tile_mma": entry(256, 1, spill=8) + entry(128, 1)
                        + entry(256, 0) + entry(128, 0)}
    with pytest.raises(AssertionError, match="spill"):
        chip_smoke.check_wgmma_build(Build, "tile_mma")


def test_wgmma_build_check_reads_both_types_of_the_collective_matmuls():
    """``chip_smoke.check_wgmma_build`` finds the collective matmuls' four
    kernels (bf16 on wgmma, f32 on the split-TF32 form) in
    ``collective_matmul``'s ptxas report, fails on a spill in an f32 one,
    and on a missing instance."""
    import chip_smoke

    def entry(kernel, dtype, spill=0):
        arg = "f" if dtype == "f32" else "13__nv_bfloat16"
        params = "AgParams" if kernel == "ag_matmul" else "RsParams"
        name = (f"_ZN12_GLOBAL__N_1{len(kernel) + 7}{kernel}_kernelI{arg}"
                f"EEvN12_GLOBAL__N_18{params}E")
        return (f"ptxas info    : Compiling entry function '{name}' for "
                f"'sm_90a'\n"
                f"    0 bytes stack frame, {spill} bytes spill stores, "
                f"{spill} bytes spill loads\n"
                f"ptxas info    : Used 200 registers, used 1 barriers\n")

    instances = [(k, d) for k in ("ag_matmul", "mm_rs")
                 for d in ("f32", "bf16")]

    class Build:
        build_logs = {"collective_matmul": "".join(entry(*i)
                                                   for i in instances)}

    assert chip_smoke.check_wgmma_build(Build, "collective_matmul") == (
        "ag_matmul bf16 200 registers, 0 spills, ag_matmul f32 200 "
        "registers, 0 spills, mm_rs bf16 200 registers, 0 spills, mm_rs "
        "f32 200 registers, 0 spills")
    Build.build_logs = {"collective_matmul": "".join(
        entry(*i, spill=16 if i == ("mm_rs", "f32") else 0)
        for i in instances)}
    with pytest.raises(AssertionError, match="mm_rs f32.*spill"):
        chip_smoke.check_wgmma_build(Build, "collective_matmul")
    Build.build_logs = {"collective_matmul": "".join(entry(*i)
                                                     for i in instances[1:])}
    with pytest.raises(AssertionError, match="ptxas reported"):
        chip_smoke.check_wgmma_build(Build, "collective_matmul")


def test_ring_attn_build_check_reads_every_instance():
    """``chip_smoke.check_ring_attn_build`` finds the ring attention
    kernel's eight instances (q and K/V each f32 or bf16, two widths) in
    ``ring_attn``'s ptxas report, bf16 spelled out or back-referenced as
    the mangler writes it, and fails on a spill."""
    import chip_smoke

    types = {("f32", "f32"): "ff", ("f32", "bf16"): "f13__nv_bfloat16",
             ("bf16", "f32"): "13__nv_bfloat16f",
             ("bf16", "bf16"): "13__nv_bfloat16S1_"}

    def entry(qt, kt, keys, groups, spill=0):
        name = (f"_ZN45_GLOBAL__N__ee6be6c6_12_ring_attn_cu_e1266f3316ring_"
                f"attn_kernelI{types[qt, kt]}Li{keys}ELi{groups}EEEvNS_6"
                f"ParamsE")
        return (f"ptxas info    : Compiling entry function '{name}' for "
                f"'sm_90a'\n"
                f"    0 bytes stack frame, {spill} bytes spill stores, "
                f"{spill} bytes spill loads\n"
                f"ptxas info    : Used 240 registers, used 1 barriers\n")

    instances = [(qt, kt, keys, groups) for qt, kt in types
                 for keys, groups in ((64, 16), (16, 32))]

    class Build:
        build_logs = {"ring_attn": "".join(entry(*i) for i in instances)}

    line = chip_smoke.check_ring_attn_build(Build)
    for qt, kt, keys, groups in instances:
        assert (f"{qt}/{kt} {keys} keys x dv {8 * groups} 240 registers, "
                f"0 spills") in line
    Build.build_logs = {"ring_attn": "".join(
        entry(*i, spill=8 if i == ("bf16", "bf16", 16, 32) else 0)
        for i in instances)}
    with pytest.raises(AssertionError, match="bf16/bf16 16 keys.*spill"):
        chip_smoke.check_ring_attn_build(Build)
    Build.build_logs = {"ring_attn": "".join(entry(*i)
                                             for i in instances[1:])}
    with pytest.raises(AssertionError, match="ptxas reported"):
        chip_smoke.check_ring_attn_build(Build)


def test_ring_attn_folds_on_the_tensor_cores():
    """Both products of the ring attention kernel are TF32 mma.sync
    passes, through the split that ``tile_product.cuh`` holds; no scalar
    FMA fold is left."""
    src = (cuda_build.CSRC_DIR / "ring_attn.cu").read_text()
    header = (cuda_build.CSRC_DIR / "tile_product.cuh").read_text()
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in header
    assert '#include "tile_product.cuh"' in src
    assert "using tile::split_mma;" in src
    assert "fmaf(a" not in src and "AttnConsumer" in src
    assert src.count("split_mma<") >= 4


def test_all_gather_relays_from_the_output():
    """The ring all-gather runs the relay-from-output protocol: its kernel
    calls ``run_gather_relay``, which touches no slot and no credit, its C
    entry takes no slots and its wrapper allocates none; the stream
    protocol stays for ring attention and the all-gather matmul."""
    import inspect

    from dpu_operator_tpu_torch.parallel import ring_probe

    csrc = cuda_build.CSRC_DIR
    src = (csrc / "ring_collectives.cu").read_text()
    kernel = _body(src, "    ring_all_gather_kernel(")
    assert "ring::run_gather_relay(" in kernel
    assert "run_ring_stream(" not in src and "CopyOut" not in src
    entry = 'extern "C" int ring_all_gather_launch('
    start = src.index(entry)
    assert "slots" not in src[start:src.index(")", start)]
    relay = _body((csrc / "ring_stream.cuh").read_text(),
                  "__device__ void run_gather_relay(")
    assert "credit" not in relay and "slots" not in relay
    assert "copy_stripe_twice(" in relay
    for user in ("ring_attn.cu", "collective_matmul.cu"):
        assert "ring::run_ring_stream(" in (csrc / user).read_text()
    assert "slots" not in inspect.getsource(ring_probe.ring_all_gather_cuda)


# Every C entry point of each source, and the wrappers bind each one.
EXPORTS = {
    "paged_attn": {"paged_attn_chunk_blocks", "paged_attn_step_launch"},
    "tile_mma": {"tile_mma_launch", "burn_chain_launch"},
    "ring_attn": {"ring_attn_launch"},
    "ring_collectives": {"ring_all_gather_launch",
                         "ring_reduce_scatter_launch"},
    "all_to_all": {"all_to_all_flag_words", "all_to_all_launch"},
    "collective_matmul": {"ag_matmul_launch", "mm_rs_launch"},
}


@pytest.mark.parametrize("name", sorted(EXPORTS))
def test_every_exported_symbol_is_known_and_bound(name):
    """A source exports exactly the entry points listed here, and the
    port's Python binds each by name (an export the wrappers never call
    is dead code; one missing from this list is a new contract that
    needs a test)."""
    import re

    src = (cuda_build.CSRC_DIR / f"{name}.cu").read_text()
    assert set(re.findall(r'extern "C" \w+ (\w+)\(', src)) == EXPORTS[name]
    python = "".join(p.read_text() for p in
                     (cuda_build.PKG_DIR / "parallel").glob("*.py"))
    for symbol in EXPORTS[name]:
        assert re.search(rf"\b{symbol}\b", python), symbol


def test_paged_attn_build_check_reads_every_instance():
    """``chip_smoke.check_paged_attn_build`` finds the paged-attention
    kernel's six instances (int8 pools at 16 and 4 codes a load, f32
    pools, each for heads up to 128 and 256 wide) and fails on a spill or
    a missing instance."""
    import chip_smoke

    def entry(pool, codes, dpl, spill=0):
        name = (f"_ZN12_GLOBAL__N_117paged_attn_kernelI{pool}Li{codes}ELi"
                f"{dpl}EEEvNS_6ParamsE")
        return (f"ptxas info    : Compiling entry function '{name}' for "
                f"'sm_90a'\n"
                f"    0 bytes stack frame, {spill} bytes spill stores, "
                f"{spill} bytes spill loads\n"
                f"ptxas info    : Used 96 registers, used 1 barriers\n")

    instances = [("a", 16, 1), ("a", 16, 2), ("a", 4, 1), ("a", 4, 2),
                 ("f", 4, 1), ("f", 4, 2)]

    class Build:
        build_logs = {"paged_attn": "".join(entry(*i) for i in instances)}

    line = chip_smoke.check_paged_attn_build(Build)
    assert "int8 x16 dh<=128 96 registers, 0 spills" in line
    assert "f32 x4 dh<=256 96 registers, 0 spills" in line
    Build.build_logs = {"paged_attn": "".join(
        entry(*i, spill=4 if i == ("f", 4, 1) else 0) for i in instances)}
    with pytest.raises(AssertionError, match="f32 x4 dh<=128.*spill"):
        chip_smoke.check_paged_attn_build(Build)
    Build.build_logs = {"paged_attn": "".join(entry(*i)
                                              for i in instances[1:])}
    with pytest.raises(AssertionError, match="ptxas reported"):
        chip_smoke.check_paged_attn_build(Build)
