"""What ``nvcc`` made of the package's CUDA kernels, read from the built
library with the toolkit's ``cuobjdump``: each kernel's registers
(:func:`resource_usage`) and the loops of its SASS with their issue
counts (:func:`sass_loops`).

Analysis tooling for ``chip_smoke.py`` and ``tools/ionogram_attribution.py``
(``from tools.cuda_sass import sass_loops``, from the root of the repo);
the package itself reads none of it. Needs the CUDA toolkit, so it runs
on a machine with a card.
"""

import re
import subprocess

from pyrayhf_tpu_torch.cuda_ext import build, find_nvcc

__all__ = ["resource_usage", "sass_loops"]


def resource_usage(so=None):
    """[(kernel, "REG:n STACK:n ...")] of a built library (default: the
    package's), by ``cuobjdump --dump-resource-usage`` (the toolkit's,
    beside ``nvcc``), with the kernel names demangled by ``cu++filt`` where
    it exists."""
    so = so or build()[0]
    tools = find_nvcc().parent
    r = subprocess.run([str(tools / "cuobjdump"), "--dump-resource-usage",
                        str(so)], capture_output=True, text=True, check=True)
    rows, name = [], None
    for ln in r.stdout.splitlines():
        ln = ln.strip()
        if ln.startswith("Function ") and ln.endswith(":"):
            name = ln[len("Function "):-1]
        elif name and ln.startswith("REG:"):
            rows.append([name, " ".join(ln.split()[:2])])
            name = None
    filt = tools / "cu++filt"
    if rows and filt.exists():
        names = subprocess.run([str(filt), *(n for n, _ in rows)],
                               capture_output=True, text=True,
                               check=True).stdout.splitlines()
        if len(names) == len(rows):
            for row, n in zip(rows, names):
                row[0] = n.replace("(anonymous namespace)::", "")
    return [tuple(row) for row in rows]


_SASS_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_SASS_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_SASS_TARGET = re.compile(r"(0x[0-9a-f]+|\.L_x_\d+)\)?`?\s*$")


def _op(text):
    """The opcode of one SASS instruction (after its predicate)."""
    return text.split()[1] if text.startswith("@") else text.split()[0]


def _loops(instrs, labels):
    """The loops of one function's [(address, text)]: each backward branch
    and its target, with the instructions in between; the fewest
    (``path``) and the most (``longest``) that one pass from the target to
    the branch can issue, over the forward edges (a conditional branch
    taken or not, ``BRA.DIV`` either way, calls not entered, inner loops
    once); and its MUFU and VOTE instructions."""
    at = {addr: i for i, (addr, _) in enumerate(instrs)}

    def target(text):
        m = _SASS_TARGET.search(text)
        if not _op(text).startswith("BRA") or not m:
            return None
        g = m.group(1)
        return at.get(int(g, 16) if g.startswith("0x") else labels.get(g))

    def succ(j):
        text = instrs[j][1]
        op = _op(text)
        ends = (op.startswith(("BRA", "EXIT", "RET", "BRX", "JMP"))
                and not op.startswith("BRA.DIV"))
        out = [j + 1] if not ends or text.startswith("@") else []
        k = target(text)
        return out + ([k] if k is not None and k > j else [])

    out = []
    for i, (addr, text) in enumerate(instrs):
        t = target(text)
        if t is None or t > i:
            continue
        short, long_ = {t: 1}, {t: 1}
        for j in range(t, i):    # forward edges only: addresses in order
            if j not in short:
                continue
            for k in succ(j):
                if k <= i:
                    short[k] = min(short.get(k, 1 << 30), short[j] + 1)
                    long_[k] = max(long_.get(k, 0), long_[j] + 1)
        body = [x for _, x in instrs[t:i + 1]]
        out.append({"start": instrs[t][0], "end": addr,
                    "instructions": i - t + 1, "path": short.get(i),
                    "longest": long_.get(i),
                    "mufu": [_op(x) for x in body if "MUFU" in x],
                    "vote": sum("VOTE" in x for x in body)})
    return out


def sass_loops(so=None):
    """{kernel: [loop, ...]} of a built library (default: the package's),
    read from ``cuobjdump -sass`` with names demangled by ``cu++filt``:
    each loop (a backward branch) with its instruction count, the fewest
    and the most instructions one iteration can issue (``path``,
    ``longest``), and its MUFU and VOTE instructions. A warp issues at most
    one instruction a cycle on its scheduler: ``path`` times the warp
    iterations is a bound on the issue time."""
    so = so or build()[0]
    tools = find_nvcc().parent
    r = subprocess.run([str(tools / "cuobjdump"), "-sass", str(so)],
                       capture_output=True, text=True, check=True)
    funcs, name, instrs, labels = {}, None, [], {}
    for ln in r.stdout.splitlines() + ["Function : <end>"]:
        if "Function : " in ln:
            if name:
                funcs[name] = _loops(instrs, labels)
            name, instrs, labels = ln.split("Function : ")[1].strip(), [], {}
            continue
        lm = _SASS_LABEL.match(ln)
        if lm:
            labels[lm.group(1)] = None
        m = _SASS_INSTR.search(ln)
        if m and name:
            addr = int(m.group(1), 16)
            for k, v in labels.items():
                if v is None:
                    labels[k] = addr
            instrs.append((addr, m.group(2).strip()))
    filt = tools / "cu++filt"
    if funcs and filt.exists():
        names = subprocess.run([str(filt)], input="\n".join(funcs) + "\n",
                               capture_output=True, text=True,
                               check=True).stdout.splitlines()
        if len(names) == len(funcs):
            funcs = {n.replace("(anonymous namespace)::", ""): v
                     for n, v in zip(names, funcs.values())}
    return funcs
