#!/usr/bin/env python3
"""Device times of variants of the burn chain kernel on one card.

    python3 scripts/chain_variants.py VARIANT [...]

Each VARIANT is ``csrc/tile_mma.cu`` (and ``csrc/tile_product.cuh``, which
it includes) changed by one or more of these, joined by ``+``; ``base``
changes nothing:

  * ``w128``, ``w256``: the chain's tile 128 x 128 (three stages) or
    128 x 256 (four), in place of 128 x 64 (four);
  * ``s3``, ``s6``: three or six stages of the 128 x 64 tile's ring in
    place of four;
  * ``noproduct``: leave out the products (the launch, the tile loop and
    the grid-wide barriers only);
  * ``nosync``: leave out the grid-wide barriers;
  * ``nomma``: leave out the wgmma instructions (the TMA loads, their
    barriers and the epilogue stay);
  * ``notanh``: store without tanh.

A variant that leaves something out computes something else and is
timed, not checked; the others are held against ``burn_chain_plain`` at
the health burn's 1024^2 x 8 within ``chip_smoke.CHAIN_ATOL``. The
variants are built at once (one ``nvcc`` each) into
``_build/variants/chain_*``, then each in turn is bound to the port's
wrapper and timed at 1024^2: eight steps and one step by CUDA events
(``chip_smoke.time_ms``), and a launch of eight steps by the profiler
(``chip_smoke.device_ms``) beside the host's time to queue a call.
Prints one JSON line a variant, with ptxas's registers and spill bytes
of the chain kernel, and the card's name and power limit. Needs a CUDA
card.
"""

import concurrent.futures
import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, HERE)

import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
from dpu_operator_tpu_torch import cuda_build  # noqa: E402
from dpu_operator_tpu_torch.parallel import burn, fabric_probe  # noqa: E402

# Each change as (file, the file's text, what replaces it).
STAGES = "kStages = BN == 128 ? 3 : 4;"
CHANGES = {
    "w128": [("tile_mma.cu", "constexpr int kChainWidth = 64;",
              "constexpr int kChainWidth = 128;")],
    "w256": [("tile_mma.cu", "constexpr int kChainWidth = 64;",
              "constexpr int kChainWidth = 256;")],
    **{f"s{k}": [("tile_mma.cu", STAGES,
                  f"kStages = BN == 64 ? {k} : BN == 128 ? 3 : 4;")]
       for k in (3, 6)},
    "noproduct": [("tile_mma.cu",
                   "      tile::tile_product_wgmma(sm, pipe, a, w, n, n, n,",
                   "      if (0) tile::tile_product_wgmma(sm, pipe, a, w, n,"
                   " n, n,")],
    "nosync": [("tile_mma.cu", "if (step + 1 < p.length) grid.sync();",
                "if (0) grid.sync();")],
    "nomma": [("tile_product.cuh",
               "    for (int kk = 0; kk < kWgBK / 16; ++kk) {",
               "    for (int kk = 0; kk < 0; ++kk) {")],
    "notanh": [("tile_mma.cu",
                "                               tile::StoreBf16<true>{dst, n});",
                "                               tile::StoreBf16<false>{dst, n});"
                )],
}
LEFT_OUT = {"noproduct", "nosync", "nomma", "notanh"}


def build(variant: str):
    """(library path, ptxas report) of one variant."""
    texts = {name: (cuda_build.CSRC_DIR / name).read_text()
             for name in os.listdir(cuda_build.CSRC_DIR)
             if name.endswith((".cu", ".cuh"))}
    for part in variant.split("+"):
        for name, old, new in CHANGES.get(part, []):
            if texts[name].count(old) != 1:
                raise RuntimeError(f"{name} has no single {old!r}")
            texts[name] = texts[name].replace(old, new)
    where = cuda_build.BUILD_DIR / "variants" / f"chain_{variant}"
    where.mkdir(parents=True, exist_ok=True)
    for name, text in texts.items():
        (where / name).write_text(text)
    out = where / "libtile_mma.so"
    res = subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
                          "-o", str(out), str(where / "tile_mma.cu")],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed for {variant}:\n"
                           f"{res.stderr[-4000:]}")
    return out, res.stderr


def main() -> int:
    if not torch.cuda.is_available():
        print("chain_variants: no CUDA device", file=sys.stderr)
        return 2
    variants = sys.argv[1:] or ["base"]
    with concurrent.futures.ThreadPoolExecutor(len(variants)) as pool:
        built = list(pool.map(build, variants))
    x, w = fabric_probe.burn_example_args(device="cuda")
    want = burn.burn_chain_plain(x, w)
    for variant, (path, report) in zip(variants, built):
        cuda_build._loaded["tile_mma"] = ctypes.CDLL(str(path))
        out = {"variant": variant,
               "ptxas": [v for k, v in c.ptxas_entries(report).items()
                         if "chain_kernel" in k]}
        got = burn.burn_chain(x, w)
        torch.cuda.synchronize()
        out["max_abs_err"] = float((got.float() - want.float()).abs().max())
        if not LEFT_OUT & set(variant.split("+")):
            c.check(out["max_abs_err"] <= c.CHAIN_ATOL,
                    f"{variant}: max |err| {out['max_abs_err']}")
        out["ms"] = c.time_ms(torch, lambda: burn.burn_chain(x, w))
        out["one_step_ms"] = c.time_ms(torch,
                                       lambda: burn.burn_chain(x, w, 1))
        out["launch_ms"], out["host_ms"], out["launch_read"] = c.device_ms(
            torch, lambda: burn.burn_chain(x, w), "chain_kernel")
        out["card"] = c.card_line()
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
