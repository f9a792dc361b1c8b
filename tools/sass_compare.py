#!/usr/bin/env python3
"""Compare the machine code (SASS) of the CUDA kernels of two source trees.

    python tools/sass_compare.py OLD_CSRC NEW_CSRC

Compiles every `*.cu` of OLD_CSRC, and the file of the same name in
NEW_CSRC, to a cubin with the flags of `odgi_tpu_torch/ops/kernels.py`
(needs nvcc and cuobjdump, so it runs on a machine with the CUDA
toolkit), disassembles every kernel, and prints one JSON line per kernel
of NEW_CSRC: its instruction count and whether its instruction stream
equals that of the same kernel in OLD_CSRC.  A leveled kernel's name is
read without its parameter list, and an untemplated one as `<false>`, so
that a kernel that gained a template flag and a parameter is compared
with its old self.  Only the `/*addr*/`
prefixes and the encodings are dropped: operands, registers and
constant-bank offsets are compared.
Exits non-zero if a kernel of OLD_CSRC has no equal in NEW_CSRC.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from odgi_tpu_torch.ops.kernels import NVCC_FLAGS, _nvcc  # noqa: E402

_FUNC = re.compile(r"^\s*Function : (\S+)")
_INSN = re.compile(r"^\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;")


def kernel_name(mangled: str) -> str:
    """A kernel's name for the comparison: `strata_chunks_2d_levels_kernel`
    with `<true>` / `<false>` for a leveled kernel (untemplated: `<false>`),
    else the mangled name without its anonymous namespace's hash."""
    name = re.sub(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]+", "", mangled)
    m = re.search(r"(strata_chunks_[12]d_levels_kernel)(ILb([01])E)?", name)
    if m and not name[m.end(1):].startswith("ILi"):  # not the cluster kernels
        return f"{m.group(1)}<{'true' if m.group(3) == '1' else 'false'}>"
    return name


def sass(src: Path, out: Path) -> dict:
    """Kernel name -> its instructions, for one source file."""
    flags = [f for f in NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    cubin = out / f"{src.stem}_{len(list(out.iterdir()))}.cubin"
    subprocess.run([_nvcc(), *flags, "-cubin", "-o", str(cubin), str(src)],
                   check=True, capture_output=True, text=True)
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(cubin)], check=True, capture_output=True,
                          text=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = _FUNC.match(line)
        if m:
            cur = f"{src.name}:{kernel_name(m.group(1))}"
            funcs[cur] = []
            continue
        m = _INSN.match(line)
        if m and cur is not None:
            funcs[cur].append(m.group(1))
    return funcs


def main() -> int:
    old_dir, new_dir = (Path(a).resolve() for a in sys.argv[1:3])
    old, new = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for src in sorted(old_dir.glob("*.cu")):
            old.update(sass(src, Path(tmp)))
            new.update(sass(new_dir / src.name, Path(tmp)))
    for name, insns in sorted(new.items()):
        print(json.dumps(dict(kernel=name, instructions=len(insns),
                              equal_to_old=old.get(name) == insns if name in old else None,
                              old_instructions=len(old[name]) if name in old else None)))
    changed = [name for name, insns in old.items() if new.get(name) != insns]
    print(json.dumps(dict(old_kernels_unchanged=not changed, changed=changed)))
    return 1 if changed else 0


if __name__ == "__main__":
    sys.exit(main())
