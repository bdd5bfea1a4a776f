"""Registers, spills, shared memory and SASS instruction mix of the kernels of
one CUDA source, to tell two checkouts' builds of the same kernel apart.

    python3 -m editor_tpu_torch.tools.kernel_sass <source.cu> [--match REGEX]

Compiles the source with the port's build flags (``ops._build.NVCC_FLAGS``)
and ``-Xptxas -v`` into a cubin in a temporary directory, disassembles it
with ``cuobjdump -sass``, and prints one JSON line per kernel whose mangled
name matches REGEX: its registers, spill bytes, static shared memory, the
number of SASS instructions and the count of each opcode (without its
modifiers), with its demangled name (``cu++filt``; the template arguments
tell the instances apart, e.g. K1's, K3's, K6's, T2's and T1's
``attention_fwd_mma_kernel<FwdForm, head-dim tiles, key tiles, resident>``,
K4's, K7's and K5's ``attention_bwd_mma_kernel<BwdForm, ...>``, and the walk
kernels of T6 and K6's group sweep, ``attention_fwd_mma_walk_kernel<kFull |
kTiled, ...>`` and ``attention_bwd_mma_walk_kernel<kFull, ...>``). The
source may lie in another checkout: its includes resolve beside it. Needs
``nvcc``, ``cuobjdump`` and ``cu++filt`` of the CUDA toolkit, no card.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import subprocess
import tempfile
from pathlib import Path

_PTXAS_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")
_PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_PTXAS_SMEM = re.compile(r"(\d+) bytes smem")
_SASS_FUNC = re.compile(r"Function : (\w+)")
_SASS_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)")


def ptxas_info(log: str) -> dict:
    """{kernel: {registers, spill_stores, spill_loads, smem}} from ptxas -v."""
    info, cur = {}, None
    for line in log.splitlines():
        m = _PTXAS_ENTRY.search(line)
        if m:
            cur = info.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        if m := _PTXAS_SPILL.search(line):
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        if m := _PTXAS_REGS.search(line):
            cur["registers"] = int(m.group(1))
            s = _PTXAS_SMEM.search(line)
            cur["smem"] = int(s.group(1)) if s else 0
    return info


def sass_opcodes(sass: str) -> dict:
    """{kernel: Counter of opcodes} from cuobjdump -sass."""
    out, cur = {}, None
    for line in sass.splitlines():
        if m := _SASS_FUNC.search(line):
            cur = out.setdefault(m.group(1), collections.Counter())
        elif cur is not None and (m := _SASS_INSN.search(line)):
            cur[m.group(1).split(".")[0]] += 1
    return out


def demangle(names, cufilt: str) -> dict:
    """{mangled: demangled} through ``cu++filt``, one name an argument; each
    name maps to itself where ``cu++filt`` is missing or gives no line for
    each name."""
    names = list(names)
    if not names or not Path(cufilt).exists():
        return {n: n for n in names}
    out = subprocess.run([cufilt, *names], capture_output=True, text=True,
                         check=True).stdout.splitlines()
    return dict(zip(names, out)) if len(out) == len(names) else {n: n for n in names}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("source", type=Path)
    ap.add_argument("--match", default=".", help="regex on the mangled kernel name")
    args = ap.parse_args(argv)
    from editor_tpu_torch.ops import _build

    nvcc = _build._nvcc()
    cuobjdump = str(Path(nvcc).with_name("cuobjdump"))
    with tempfile.TemporaryDirectory() as tmp:
        cubin = str(Path(tmp) / "k.cubin")
        proc = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-cubin", "-o", cubin,
                               str(args.source)], capture_output=True, text=True, check=True)
        info = ptxas_info(proc.stdout + proc.stderr)
        sass = subprocess.run([cuobjdump, "-sass", cubin], capture_output=True, text=True,
                              check=True).stdout
    ops = sass_opcodes(sass)
    names = sorted(n for n in set(info) | set(ops) if re.search(args.match, n))
    plain = demangle(names, str(Path(nvcc).with_name("cu++filt")))
    for name in names:
        counts = ops.get(name, collections.Counter())
        print(json.dumps(dict(source=str(args.source), kernel=name, demangled=plain[name],
                              **info.get(name, {}),
                              instructions=sum(counts.values()),
                              opcodes=dict(counts.most_common()))), flush=True)


if __name__ == "__main__":
    main()
