#!/usr/bin/env python3
"""Registers and spills of every CUDA kernel of the port, and the fp64
instructions of the replay kernel's (K2's) lane update.

    python3 tools/kernel_resources.py

Needs the CUDA toolkit (``nvcc``, ``cuobjdump``), not a card.  Compiles
each ``csrc/*.cu`` with the package's own flags (``_build.NVCC_FLAGS``)
and ``-Xptxas -v`` and reports each kernel's registers, stack frame and
spill stores and loads (``source_resources``, which ``chip_smoke.py`` also
calls for the replay kernel's line).  Then compiles a probe kernel that applies
``csrc/replay.cu``'s ``advance`` and ``kick_weight`` (the sweep's whole
per-lane body) to one lane a thread, and counts the fp64-pipe instructions in its SASS
(``cuobjdump -sass``) up to the kernel's first ``EXIT``: the path every
lane takes, without the division's slow-path subroutine placed after it.
``fp64_ops`` counts each DFMA as two operations (its multiply and its
add), as the card's fp64 peak counts them, and every other fp64-pipe
instruction (DADD, DMUL, DSETP, DMNMX, MUFU.RCP64H, conversions to or from
F64) as one: ``chip_smoke.py``'s ``K2_OPS_PER_LANE_EVENT``.  Prints one
JSON object.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PROBE = r"""
#include "replay.cu"

extern "C" __global__ void atorch_lane_probe(double* v, double* s,
                                             const double* b,
                                             const double* w, int N, int j,
                                             double dt, double e_t,
                                             double de) {
  // no bounds test: its early EXIT would end the counted path
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  double vi = v[i], si = s[i];
  advance(vi, si, b[i], kick_weight(w, i, j, N), i == j, dt, e_t, de);
  v[i] = vi;
  s[i] = si;
}
"""
FP64_BASES = {"DADD", "DMUL", "DFMA", "DSETP", "DSET", "DMNMX"}
INSTRUCTION = re.compile(
    r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)")


def is_fp64(opcode: str) -> bool:
    base = opcode.split(".")[0]
    return (base in FP64_BASES or opcode.startswith(("MUFU.RCP64H",
                                                     "MUFU.RSQ64H"))
            or (base in ("F2F", "I2F", "F2I") and "F64" in opcode))


def ptxas_report(text: str) -> dict:
    """Per function: registers, stack frame, spill stores and loads."""
    out, current = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line) or \
            re.search(r"Function properties for (\S+)", line)
        if m:
            current = out.setdefault(m.group(1), {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and current is not None:
            current.update(stack_bytes=int(m.group(1)),
                           spill_store_bytes=int(m.group(2)),
                           spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and current is not None:
            current["registers"] = int(m.group(1))
    return out


def demangle(names, bindir: Path):
    tool = next((str(p) for p in (bindir / "cu++filt",) if p.is_file()),
                shutil.which("c++filt"))
    if tool is None:
        return list(names)
    out = subprocess.run([tool], input="\n".join(names), text=True,
                         capture_output=True, check=True).stdout
    return out.splitlines()


def source_resources(src: Path) -> dict:
    """Registers, stack frame and spill bytes of each kernel of one
    ``csrc/*.cu`` as the package's flags compile it, keyed by its
    demangled name."""
    sys.path.insert(0, str(ROOT))
    from armadillocudalinearinterpolation_torch import _build
    nvcc = _build.nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        done = subprocess.run(
            [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
             str(Path(tmp) / f"{src.stem}.o"), str(src)],
            capture_output=True, text=True, check=True)
    report = ptxas_report(done.stdout + done.stderr)
    entries = [k for k, v in report.items() if "registers" in v]
    return {nice: report[name] for name, nice in
            zip(entries, demangle(entries, Path(nvcc).parent))}


def main() -> int:
    sys.path.insert(0, str(ROOT))
    from armadillocudalinearinterpolation_torch import _build
    nvcc = _build.nvcc()
    cuobjdump = Path(nvcc).parent / "cuobjdump"
    kernels = {f"{src.name}: {name}": res
               for src in sorted(_build.CSRC.glob("*.cu"))
               for name, res in source_resources(src).items()}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        probe = tmp / "probe.cu"
        probe.write_text(PROBE)
        subprocess.run([nvcc, *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                        "-cubin", "-o", str(tmp / "probe.cubin"), str(probe)],
                       capture_output=True, text=True, check=True)
        sass = subprocess.run([str(cuobjdump), "-sass", "-fun",
                               "atorch_lane_probe", str(tmp / "probe.cubin")],
                              capture_output=True, text=True,
                              check=True).stdout
    opcodes = [m.group(1) for m in INSTRUCTION.finditer(sass)]
    first_exit = next(i for i, op in enumerate(opcodes) if op == "EXIT")
    path = opcodes[:first_exit + 1]
    fp64 = {}
    for op in path:
        if is_fp64(op):
            fp64[op] = fp64.get(op, 0) + 1
    print(json.dumps({
        "kernels": kernels,
        "k2_lane_update": {
            "instructions_to_first_exit": len(path),
            "instructions_in_function": len(opcodes),
            "fp64_instructions": sum(fp64.values()),
            "fp64_ops": sum(n * (2 if op.startswith("DFMA") else 1)
                            for op, n in fp64.items()),
            "fp64_by_opcode": fp64,
            "fp64_instructions_in_function": sum(map(is_fp64, opcodes))},
        "nvcc_flags": _build.NVCC_FLAGS}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
