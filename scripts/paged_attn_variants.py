#!/usr/bin/env python3
"""Device times of variants of the paged-attention kernel on one card.

    python3 scripts/paged_attn_variants.py ROWS:POSITIONS[:SKIP[:CHUNK]] [...]

Each variant is ``csrc/paged_attn.cu`` with ``kRows`` (the query rows a
warp owns) set to ROWS and the int8 pass (the positions a pass stages)
set to POSITIONS; f32 pools keep their pass. SKIP, one or more of these
joined by ``+``, changes the source further:

  * ``noqk``, ``nopv``: leave out the q.k products or the p.v loop;
  * ``nostage``: leave out the K/V copies;
  * ``noqld``, ``nopld``: replace the shared-memory loads of q or of p
    by a lane's constants;
  * ``vi2f``, ``ki2f``: convert V's or K's int8 codes with the
    conversion unit;
  * ``lb5``: ask the compiler for five 128-thread CTAs an SM (a chunk
    width C of at most 16).

A variant that leaves something out computes something else and is
timed, not checked. CHUNK sets the block-table entries a CTA owns (the
wrapper's ``CHUNK_BLOCKS`` with it). The variants are built at once
(one ``nvcc`` each) into ``_build/variants/``, then each in turn is
bound to the port's wrapper, held against the plain version at
``chip_smoke.py``'s phase-3 inputs (pools bitwise equal, o within the
phase's bar, on the plain inputs and on the chunk-edge ones) and timed
with CUDA events, int8 and fp32. Prints one JSON line a variant, with
ptxas's registers and spill bytes of its instances, and the card's name
and power limit. Needs a CUDA card.
"""

import concurrent.futures
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, HERE)

import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
from dpu_operator_tpu_torch import cuda_build  # noqa: E402
from dpu_operator_tpu_torch.parallel import paged_attn as pa  # noqa: E402


# Each SKIP as (the source's text, what replaces it).
SKIPS = {"noqk": ("    qk<PoolT, E, J>(q_rows",
                  "    if (0) qk<PoolT, E, J>(q_rows"),
         "nopv": ("for (int t0 = 0; t0 < P; t0 += 8)",
                  "for (int t0 = 0; t0 < 0; t0 += 8)"),
         "nostage": ("    tile::cp_async_commit();\n  };",
                     "    tile::cp_async_commit();\n  };\n"
                     "  auto nothing = [](int) {};\n"
                     "#define stage_pass nothing"),
         "vi2f": ("  return codes4(*reinterpret_cast<const unsigned*>(p));",
                  "  const char4 c = *reinterpret_cast<const char4*>(p);\n"
                  "  return make_float4(c.x, c.y, c.z, c.w);"),
         "ki2f": ("      const float4 c = codes4(ws[i]);",
                  "      const char4 b = *reinterpret_cast<const char4*>("
                  "&ws[i]);\n"
                  "      const float4 c = make_float4(b.x, b.y, b.z, b.w);"),
         "noqld": ("const float4 qv = q_rows[r * dh4 + u * (E / 4) + e4];",
                   "const float4 qv = make_float4(lane, r, u, e4);"),
         "nopld": ("const float4 w = p_w[t * (kRows / 4) + r4];",
                   "const float4 w = make_float4(lane, t, r4, 1.f);"),
         "lb5": ("__launch_bounds__(kMaxThreads)",
                 "__launch_bounds__(128, 5)")}


LEFT_OUT = {"noqk", "nopv", "nostage", "noqld", "nopld"}


def build(rows: int, positions: int, skip: str = "", chunk: int = 0):
    """(library path, ptxas report) of one variant."""
    src = (cuda_build.CSRC_DIR / "paged_attn.cu").read_text()
    if chunk:
        src, n = re.subn(r"constexpr int kChunkBlocks = \d+;",
                         f"constexpr int kChunkBlocks = {chunk};", src)
        if n != 1:
            raise RuntimeError("paged_attn.cu names no kChunkBlocks")
    for part in filter(None, skip.split("+")):
        old, new = SKIPS[part]
        if src.count(old) != 1:
            raise RuntimeError(f"paged_attn.cu has no single {old!r}")
        src = src.replace(old, new)
    src, n = re.subn(r"constexpr int kRows = \d+;",
                     f"constexpr int kRows = {rows};", src)
    src, m = re.subn(r"(struct Pass<int8_t> \{\n  static constexpr int "
                     r"kPositions = )\d+;", rf"\g<1>{positions};", src)
    if n != 1 or m != 1:
        raise RuntimeError("paged_attn.cu no longer names kRows and the "
                           "int8 pass as this script expects")
    where = (cuda_build.BUILD_DIR / "variants"
             / f"r{rows}_p{positions}_{skip}_{chunk}")
    where.mkdir(parents=True, exist_ok=True)
    for header in cuda_build.CSRC_DIR.glob("*.cuh"):
        shutil.copy(header, where / header.name)
    (where / "paged_attn.cu").write_text(src)
    out = where / "libpaged_attn.so"
    res = subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
                          "-o", str(out), str(where / "paged_attn.cu")],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed for r{rows} p{positions}:\n"
                           f"{res.stderr[-4000:]}")
    return out, res.stderr


def check_and_time(pool: str, checked: bool) -> float:
    for edges in (0, pa.CHUNK_BLOCKS * c.KBS)[:1 + checked]:
        args, _, _ = c.kernel_inputs(torch, pool, False,
                                     chunk_positions=edges)
        kargs = [a.clone() for a in args]
        o_k = pa.paged_attn_step_cuda(*kargs)
        o_p = pa.paged_attn_step_plain(*args)
        torch.cuda.synchronize()
        for i in (10, 11)[:2 * checked]:
            c.check(torch.equal(c.bits(torch, kargs[i]),
                                c.bits(torch, args[i])), "pools differ")
        c.check(not checked or torch.allclose(o_k, o_p, rtol=c.O_RTOL,
                                              atol=c.O_ATOL),
                f"o differs by {float((o_k - o_p).abs().max())}")
        if not edges:
            ms = c.time_ms(torch, lambda: pa.paged_attn_step_cuda(*kargs))
        del args, kargs
        torch.cuda.empty_cache()
    return ms


def main() -> int:
    if not torch.cuda.is_available():
        print("paged_attn_variants: no CUDA device", file=sys.stderr)
        return 2
    variants = [(int(a[0]), int(a[1]), a[2] if len(a) > 2 else "",
                 int(a[3]) if len(a) > 3 else 0)
                for a in (arg.split(":") for arg in sys.argv[1:])]
    with concurrent.futures.ThreadPoolExecutor(len(variants)) as pool:
        built = list(pool.map(lambda v: build(*v), variants))
    default = pa.CHUNK_BLOCKS
    for (rows, positions, skip, chunk), (path, report) in zip(variants,
                                                               built):
        cuda_build._loaded["paged_attn"] = ctypes.CDLL(str(path))
        pa.CHUNK_BLOCKS = chunk or default
        out = {"rows": rows, "int8_positions": positions, "skip": skip,
               "chunk_blocks": pa.CHUNK_BLOCKS,
               "ptxas": {k.split("paged_attn_kernel")[1][:14]: v
                         for k, v in c.ptxas_entries(report).items()}}
        for pool_dtype in ("int8", "fp32"):
            out[f"{pool_dtype}_ms"] = check_and_time(
                pool_dtype, not LEFT_OUT & set(skip.split("+")))
        out["card"] = c.card_line()
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
