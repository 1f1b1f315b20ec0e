"""What the compiler made of the port's kernels: each kernel's registers,
spills and shared memory (`nvcc -Xptxas -v`), and a digest of its SASS
(`cuobjdump -sass`) to tell whether two builds compiled a kernel to the
same code.

    python3 -m trident_tpu_torch.tools_dev.kernel_sass \\
        [--lib PATH] [--usage SOURCE ...] KERNEL ...

prints one line per kernel whose mangled name holds a KERNEL needle: its
SASS instruction count and the SHA-256 of its instructions (addresses and
encodings stripped), from the library at PATH (default: the port's,
built first). With --usage, each SOURCE (a file of csrc/) is compiled
once more with `-Xptxas -v` under the build's flags and its kernels'
resource lines are printed. Needs nvcc and cuobjdump (the machine with
the card).
"""

from __future__ import annotations

import argparse
import hashlib
import re
import subprocess
import tempfile
from pathlib import Path

from trident_tpu_torch import _build

_ADDR = re.compile(r"/\*[0-9a-f]{4,}\*/")
_ENCODING = re.compile(r"/\* 0x[0-9a-f]+ \*/")


def _tool(name: str) -> str:
    return str(Path(_build.find_nvcc()).parent / name)


def sass_functions(lib) -> dict:
    """Mangled kernel name → its SASS instruction lines (addresses and
    encodings stripped) in the shared library `lib`."""
    text = subprocess.run([_tool("cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            funcs[name] = []
        elif name is not None and _ADDR.search(line):
            ins = _ENCODING.sub("", _ADDR.sub("", line)).strip()
            if ins:
                funcs[name].append(ins)
    return funcs


def sass_digests(lib, needles) -> dict:
    """Kernel → (instruction count, SHA-256 of its SASS) for each kernel of
    `lib` whose mangled name holds one of `needles` as a whole name (its
    length prefix and the name: "14resolve_kernel")."""
    out = {}
    for name, ins in sass_functions(lib).items():
        if any(f"{len(needle)}{needle}" in name for needle in needles):
            out[name] = (len(ins), hashlib.sha256(
                "\n".join(ins).encode()).hexdigest()[:16])
    return out


def resource_usage(sources) -> list:
    """`nvcc -Xptxas -v` resource lines (registers, spills, shared memory)
    of each csrc/ source in `sources`, compiled under the build's flags."""
    lines = []
    with tempfile.TemporaryDirectory() as td:
        for src in sources:
            proc = subprocess.run(
                [_build.find_nvcc(), *_build.COMPILE_FLAGS, "-Xptxas", "-v",
                 "-c", "-o", str(Path(td) / "k.o"), str(_build.CSRC / src)],
                capture_output=True, text=True, check=True)
            fn = None
            for line in proc.stderr.splitlines():
                if "Compiling entry function" in line:
                    fn = line.split("'")[1]
                elif fn and ("registers" in line or "spill" in line):
                    lines.append(f"{src} {fn}: "
                                 f"{line.split('info    :')[-1].strip()}")
    return lines


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kernels", nargs="+")
    ap.add_argument("--lib", default=None)
    ap.add_argument("--usage", nargs="*", default=[])
    args = ap.parse_args(argv)
    lib = args.lib or _build.build()
    for name, (n, digest) in sorted(sass_digests(lib, args.kernels).items()):
        print(f"sass {name}: {n} instructions, sha256 {digest}")
    for line in resource_usage(args.usage):
        print(f"ptxas {line}")


if __name__ == "__main__":
    main()
