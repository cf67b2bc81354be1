"""Count the SASS instructions of the per-axis WENO kernel (K12/K12b,
``csrc/weno_axis.cu``) as the card runs them: the issue floor that the
source's operation count (the note in the ``.cu``) does not show, since
an IEEE reciprocal or division, an index and a register move issue too.

For each checkout given, the script builds that checkout's
``csrc/weno_axis.cu`` with the package's flags (``ops/kernels/build.py``,
``-fmad=false`` and the rest of ``fused_burgers.NVCC_EXTRA``), keeps
ptxas' register and spill report, disassembles the library with
``cuobjdump -sass`` and, for each kernel instance whose name holds
``--match``, prints its instruction count and every loop (a backward
branch and the instructions back to its target) with its length and the
opcodes in it. A loop's length over the cells one pass of it computes
is the instructions a cell: the old column loop computes one cell a
pass, the new one 2r (the window, unrolled), the new last-axis sweep's
face loop RUN faces. The last line is a JSON object of the counts.

    python multigpu_advectiondiffusion_tpu_torch/examples/weno_axis_sass.py \\
        [--checkout DIR ...] [--match weno_axis_kernel_colILi0ELi5ELb0E]

Needs ``nvcc`` and ``cuobjdump`` (the CUDA toolkit); runs no kernel.
The libraries and their disassembly (``.sass``) go to ``build/sass/``
of this checkout.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (  # noqa: E402
    build,
)
from multigpu_advectiondiffusion_tpu_torch.ops.kernels.fused_burgers import (  # noqa: E402,E501
    NVCC_EXTRA,
)

INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
LABEL = re.compile(r"^\s*(\.L_x_\d+):")
FUNC = re.compile(r"Function : (\S+)")


def compile_source(checkout: Path, label: str) -> tuple[Path, str]:
    src = checkout / "multigpu_advectiondiffusion_tpu_torch" / "csrc" / \
        "weno_axis.cu"
    out_dir = REPO / "build" / "sass"
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / f"weno_axis-{label}.so"
    proc = subprocess.run(
        [build.nvcc(), *build.NVCC_FLAGS, *NVCC_EXTRA, "-o", str(out),
         str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    return out, proc.stdout + proc.stderr


def functions(so: Path) -> dict:
    """{kernel name: [(address, opcode text)] and its labels}."""
    cuobjdump = Path(build.nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(so)],
                          capture_output=True, text=True, check=True).stdout
    so.with_suffix(".sass").write_text(text)
    funcs, name, pending = {}, None, []
    for line in text.splitlines():
        m = FUNC.search(line)
        if m:
            name = m.group(1)
            funcs[name] = {"insns": [], "labels": {}}
            continue
        if name is None:
            continue
        m = LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = INSN.search(line)
        if m:
            addr = int(m.group(1), 16)
            for lab in pending:
                funcs[name]["labels"][lab] = addr
            pending = []
            funcs[name]["insns"].append((addr, m.group(2)))
    return funcs


def opcode(text: str) -> str:
    words = text.split()
    if words and words[0].startswith("@"):
        words = words[1:]
    return words[0].split(".")[0] if words else ""


def loops(func: dict) -> list[dict]:
    """Every backward branch: the loop from its target to it."""
    out = []
    for addr, text in func["insns"]:
        if opcode(text) != "BRA":
            continue
        # cuobjdump prints the target as an address, nvdisasm as a label
        m = re.search(r"\((\.L_x_\d+)\)|\b(0x[0-9a-f]+)\b", text)
        if not m:
            continue
        if m.group(1):
            if m.group(1) not in func["labels"]:
                continue
            target = func["labels"][m.group(1)]
        else:
            target = int(m.group(2), 16)
        if target > addr:
            continue
        body = [t for a, t in func["insns"] if target <= a <= addr]
        hist = collections.Counter(opcode(t) for t in body)
        out.append({"from": hex(target), "to": hex(addr), "length": len(body),
                    "opcodes": dict(hist.most_common())})
    return out


def ptxas_report(log: str) -> dict:
    """{mangled kernel: 'registers, stack, spills'} from ptxas -v."""
    report, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            report[name] = ""
        elif name and ("stack frame" in line or "Used" in line):
            report[name] += line.split("info    :")[-1].strip() + "; "
    return report


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkout", action="append", default=[],
                    help="a checkout holding the package (default: this "
                         "one); give twice to compare")
    ap.add_argument("--match", default="weno_axis_kernel",
                    help="count the kernel instances whose mangled name "
                         "holds this text")
    args = ap.parse_args()
    result = {}
    for i, checkout in enumerate(args.checkout or [str(REPO)]):
        label = f"{i}-{Path(checkout).resolve().name}"
        so, log = compile_source(Path(checkout), label)
        regs = ptxas_report(log)
        kernels = {}
        for name, func in functions(so).items():
            if args.match not in name:
                continue
            kernels[name] = {"instructions": len(func["insns"]),
                             "ptxas": regs.get(name, ""),
                             "loops": loops(func)}
            print(f"{checkout}: {name}: {len(func['insns'])} instructions; "
                  f"{regs.get(name, '')}")
            for lp in kernels[name]["loops"]:
                top = ", ".join(f"{k} {v}" for k, v in
                                list(lp["opcodes"].items())[:12])
                print(f"  loop {lp['from']}..{lp['to']}: {lp['length']} "
                      f"instructions ({top})")
        result[checkout] = kernels
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
