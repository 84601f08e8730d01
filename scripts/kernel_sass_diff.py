#!/usr/bin/env python3
"""Which of the port's kernels compiled to other machine code in two
source trees.

    python3 scripts/kernel_sass_diff.py TREE_A TREE_B

Each TREE is a checkout of the repository whose kernels have been built
(``dpu_operator_tpu_torch/_build/``, e.g. by ``chip_smoke.py`` or
``cuda_build.build``). Every library is dumped with ``cuobjdump -sass``,
split by kernel, and each kernel's SASS is hashed, with the
per-translation-unit tag of the anonymous namespace taken out of names
and bodies, every run of blanks collapsed to one and blank lines
dropped (the dump pads its columns by what else the library holds, and
ends a kernel that another follows with a blank line, so a kernel added
beside another shifts the other's padding, not its instructions).
Prints one
line a kernel: ``same``, ``DIFF``, or ``only-A`` / ``only-B``. A kernel
whose SASS is the same in both trees runs the same instructions, so a
time that moves between the two is noise. Needs
the CUDA toolkit's ``cuobjdump`` (``$CUDA_HOME/bin``, default
``/usr/local/cuda/bin``).
"""

import hashlib
import os
import pathlib
import re
import subprocess
import sys

ANON = re.compile(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]+")


def kernels(tree: str) -> dict:
    """{(source, kernel): hash of its SASS} for every built library."""
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cuobjdump")
    out = {}
    build = pathlib.Path(tree, "dpu_operator_tpu_torch", "_build")
    for lib in sorted(build.glob("lib*.so")):
        src = re.match(r"lib(.+)_[0-9a-f]{16}\.so", lib.name)[1]
        text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                              text=True, check=True).stdout
        text = ANON.sub("ANON", text)
        for part in text.split("Function : ")[1:]:
            name, body = part.split("\n", 1)
            body = "\n".join(" ".join(line.split())
                             for line in body.splitlines()
                             if line.strip()
                             and not line.strip().startswith("....")
                             and "Fatbin" not in line
                             and "code for sm" not in line)
            out[(src, name.strip())] = hashlib.sha256(
                body.encode()).hexdigest()
    return out


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    a, b = kernels(sys.argv[1]), kernels(sys.argv[2])
    for key in sorted(set(a) | set(b)):
        if key not in b:
            state = "only-A"
        elif key not in a:
            state = "only-B"
        else:
            state = "same" if a[key] == b[key] else "DIFF"
        print(f"{state:6s} {key[0]:18s} {key[1]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
