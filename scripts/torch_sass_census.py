#!/usr/bin/env python3
"""Instruction census of the port's compiled CUDA kernels.

    python3 scripts/torch_sass_census.py [REGEX]

Builds the kernels (ops/cuda/_build.py) if needed, disassembles the
library with the CUDA toolkit's cuobjdump, and prints one JSON line per
kernel whose mangled name matches REGEX (default: all): its SASS
instructions in all, those inside loops (between a backward branch's
target and the branch), and the count of each opcode class (shared and
global loads and stores, cp.async, FP32 add/mul/min-max, conversions,
MUFU, branches, barriers). Static counts: what one pass of the code
issues, not what a launch executes. Needs the toolkit (nvcc, cuobjdump),
not a card.
"""

import collections
import json
import os
import re
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from fluidnet_tpu_torch.ops.cuda import _build  # noqa: E402

CLASSES = {"LDS": "lds", "STS": "sts", "LDG": "ldg", "STG": "stg",
           "LDGSTS": "cp_async", "FADD": "fadd", "FMUL": "fmul",
           "FFMA": "ffma", "FMNMX": "fminmax", "FSEL": "sel", "SEL": "sel",
           "FSETP": "setp", "ISETP": "setp", "F2I": "cvt", "I2F": "cvt",
           "FRND": "cvt", "F2F": "cvt", "MUFU": "mufu", "BRA": "bra",
           "BAR": "bar", "IMAD": "int", "IADD3": "int", "LEA": "int",
           "LOP3": "int", "SHF": "int", "MOV": "mov"}


def census(sass):
    """{kernel: counts} from cuobjdump -sass output."""
    out, name, body = {}, None, []

    def flush():
        if name is None:
            return
        ops = [(int(a, 16), op, rest) for a, op, rest in body]
        counts = collections.Counter()
        loop = set()
        for addr, op, rest in ops:
            counts[CLASSES.get(op, "other")] += 1
            m = re.search(r"0x([0-9a-f]+)", rest) if op == "BRA" else None
            if m and int(m.group(1), 16) < addr:
                loop.update(a for a, _, _ in ops
                            if int(m.group(1), 16) <= a <= addr)
        out[name] = {"instructions": len(ops), "in_loops": len(loop),
                     **dict(sorted(counts.items()))}

    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            flush()
            name, body = m.group(1), []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_]*)(\S*)\s*(.*?);", line)
        if m and name:
            body.append((m.group(1), m.group(2), m.group(4)))
    flush()
    return out


def main():
    pattern = sys.argv[1] if len(sys.argv) > 1 else ""
    _build.build()
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", _build.LIB_PATH],
                          capture_output=True, text=True, check=True).stdout
    for name, counts in census(sass).items():
        if re.search(pattern, name):
            print(json.dumps({"kernel": name, **counts}), flush=True)


if __name__ == "__main__":
    main()
