#!/usr/bin/env python3
"""Device times of variants of the all-gather matmul's gathered form on
one card, at the mesh-stage serving form's shape.

    python3 scripts/ag_gathered_variants.py VARIANT [...]

Each VARIANT is ``csrc/collective_matmul.cu`` changed by one or more of
these, joined by ``+``; ``base`` changes nothing:

  * ``bn64``: output tiles of 64 x 64 in place of 64 x 128 (twice the
    CTAs, one m16 tile a warp);
  * ``s2``, ``s4``: two or four stages of the product's cp.async ring in
    place of three;
  * ``bk32``: stages 32 deep in K, as the 128-row tile's, in place of 64
    (twice the barriers);
  * ``unroll1``: one 16-deep slice of a stage at a time, as the 128-row
    tile runs them, in place of a stage's slices unrolled;
  * ``noproduct``: leave out the products (the relay and the wait for it
    only: the gather's share);
  * ``norelay``: leave out the relay (the products read x in place: the
    products' share).

A variant that leaves something out computes something else and is
timed, not checked; the others must give the streamed form's y bit for
bit and lie within ``chip_smoke.CM_F32_REL`` of ``ag_matmul_plain``. The
variants are built at once (one ``nvcc`` each) into
``_build/variants/ag_*``, then each in turn is bound to the port's
wrapper and timed at x [64, 4096] @ w [4096, 14336] f32 on 8 ranks
(``chip_smoke.FAB_*``): a call by CUDA events (``chip_smoke.time_ms``)
and a launch by the profiler (``chip_smoke.device_ms``). Prints one JSON
line a variant, with ptxas's registers and spill bytes of the gathered
kernel, then one line with the streamed form's and ``torch.matmul``'s
times on the same inputs, each with the card's name and power limit.
Needs a CUDA card.
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
from dpu_operator_tpu_torch.parallel import collective_matmul as cm  # noqa: E402,E501

SRC = "collective_matmul.cu"
PRODUCT = ("    tile::tile_product_tf32x3(sm, a, p.k, b, p.f, rows, fn, p.k, "
           "r0, c0, out);")
# Each change as (file, the file's text, what replaces it).
CHANGES = {
    "bn64": [(SRC, "constexpr int kGatheredWidth = 128;",
              "constexpr int kGatheredWidth = 64;")],
    **{f"s{k}": [(SRC, "constexpr int kGatheredStages = 3;",
                  f"constexpr int kGatheredStages = {k};")] for k in (2, 4)},
    "bk32": [(SRC, "constexpr int kGatheredDepth = 64;",
              "constexpr int kGatheredDepth = 32;")],
    "unroll1": [("tile_product.cuh",
                 "#pragma unroll(BM == kTfBM ? 1 : BK / 16)",
                 "#pragma unroll 1")],
    "noproduct": [(SRC, PRODUCT, "    if (0)\n" + PRODUCT)],
    "norelay": [(SRC, "  if (g.n > 1) {\n    ring::Rank r",
                 "  if (0) {\n    ring::Rank r")],
}
LEFT_OUT = {"noproduct", "norelay"}


def build(variant: str):
    """(library path, ptxas report) of one variant."""
    texts = {name: (cuda_build.CSRC_DIR / name).read_text()
             for name in os.listdir(cuda_build.CSRC_DIR)
             if name.endswith((".cu", ".cuh"))}
    for part in variant.split("+"):
        if part != "base" and part not in CHANGES:
            raise ValueError(f"unknown variant part {part!r}")
        for name, old, new in CHANGES.get(part, []):
            if texts[name].count(old) != 1:
                raise RuntimeError(f"{name} has no single {old!r}")
            texts[name] = texts[name].replace(old, new)
    where = cuda_build.BUILD_DIR / "variants" / f"ag_{variant}"
    where.mkdir(parents=True, exist_ok=True)
    for name, text in texts.items():
        (where / name).write_text(text)
    out = where / "libcollective_matmul.so"
    res = subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
                          "-o", str(out), str(where / SRC)],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed for {variant}:\n"
                           f"{res.stderr[-4000:]}")
    return out, res.stderr


def main() -> int:
    if not torch.cuda.is_available():
        print("ag_gathered_variants: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    variants = sys.argv[1:] or ["base"]
    with concurrent.futures.ThreadPoolExecutor(len(variants)) as pool:
        built = list(pool.map(build, variants))
    n, d, f = c.FAB_WORLD, c.FAB_MODEL["d"], c.FAB_MODEL["h"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(40)
    x = torch.randn((c.FAB_SLOTS, d), generator=gen, device="cuda")
    w = torch.randn((d, f), generator=gen, device="cuda") / d ** 0.5
    want = cm.ag_matmul_plain(x, w, n)
    top = float(want.abs().max())
    streamed = None
    for variant, (path, report) in zip(variants, built):
        cuda_build._loaded["collective_matmul"] = ctypes.CDLL(str(path))
        out = {"variant": variant,
               "ptxas": [v for k, v in c.ptxas_entries(report).items()
                         if "ag_gathered_kernel" in k]}
        got = cm.ag_matmul_cuda(x, w, n, form="gathered")
        if streamed is None:
            streamed = cm.ag_matmul_cuda(x, w, n, form="streamed")
        torch.cuda.synchronize()
        out["max_abs_err"] = float((got - want).abs().max())
        out["same_bits_as_streamed"] = c.same_bits(torch, got, streamed)
        if not LEFT_OUT & set(variant.split("+")):
            c.check(out["same_bits_as_streamed"],
                    f"{variant}: y differs from the streamed form's")
            c.check(out["max_abs_err"] <= c.CM_F32_REL * top,
                    f"{variant}: max |err| {out['max_abs_err']} over "
                    f"{c.CM_F32_REL} x {top}")
        out["ms"] = c.time_ms(
            torch, lambda: cm.ag_matmul_cuda(x, w, n, form="gathered"),
            n=10, warm=2, batch=5)
        out["launch_ms"], out["host_ms"], out["launch_read"] = c.device_ms(
            torch, lambda: cm.ag_matmul_cuda(x, w, n, form="gathered"),
            "ag_gathered_kernel", calls=10)
        out["card"] = c.card_line()
        print(json.dumps(out), flush=True)
    out = {"streamed_ms": c.time_ms(
        torch, lambda: cm.ag_matmul_cuda(x, w, n, form="streamed"), n=5,
        warm=1, batch=2)}
    out["torch_matmul_ms"] = c.time_ms(torch, lambda: torch.matmul(x, w),
                                       n=10, warm=2, batch=5)
    out["card"] = c.card_line()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
