#!/usr/bin/env python3
"""Compare the machine code of the replay and evolve kernels of two
checkouts, kernel by kernel.

    python3 tools/sass_compare.py BEFORE AFTER

Needs the CUDA toolkit (``nvcc``, ``cuobjdump``), not a card.  Compiles
``csrc/replay.cu`` and ``csrc/evolve.cu`` of each checkout to a cubin with
this repository's flags (``_build.NVCC_FLAGS``), disassembles it
(``cuobjdump -sass``) and compares each kernel's instructions, addresses
left out.  Kernels are matched by their mangled name less the anonymous
namespace's per-file hash.  Prints one JSON object: per kernel ``"same"``,
the count of instructions that differ, or which checkout alone has it.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SOURCES = ("replay.cu", "evolve.cu")
INSTRUCTION = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")


def kernels_sass(checkout: Path, source: str) -> dict:
    """Each kernel's instructions in one source of ``checkout``."""
    sys.path.insert(0, str(ROOT))
    from armadillocudalinearinterpolation_torch import _build
    nvcc = _build.nvcc()
    src = checkout / "armadillocudalinearinterpolation_torch" / "csrc" / source
    with tempfile.TemporaryDirectory() as tmp:
        cubin = Path(tmp) / "k.cubin"
        subprocess.run([nvcc, *_build.NVCC_FLAGS, "-cubin", "-o", str(cubin),
                        str(src)], check=True, capture_output=True)
        sass = subprocess.run([str(Path(nvcc).parent / "cuobjdump"), "-sass",
                               str(cubin)], check=True, capture_output=True,
                              text=True).stdout
    out, current = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N_",
                          m.group(1))
            current = out.setdefault(name, [])
            continue
        m = INSTRUCTION.search(line)
        if m and current is not None:
            current.append(m.group(1))
    return out


def main() -> int:
    before, after = (Path(a).resolve() for a in sys.argv[1:3])
    result = {}
    for source in SOURCES:
        a, b = kernels_sass(before, source), kernels_sass(after, source)
        for name in sorted(set(a) | set(b)):
            key = f"{source}: {name}"
            if name not in a or name not in b:
                result[key] = "only in " + ("before" if name in a
                                            else "after")
            elif a[name] == b[name]:
                result[key] = "same"
            else:
                differ = sum(x != y for x, y in zip(a[name], b[name]))
                result[key] = (f"{differ + abs(len(a[name]) - len(b[name]))}"
                               f" of {len(a[name])} -> {len(b[name])} "
                               "instructions differ")
    print(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
