#!/usr/bin/env python3
"""The machine code of the kernels of two kernel sources, side by side: which
kernels a change recompiled to other instructions, and how long each
library takes to build.

    python3 -m deplex_tpu_torch.tools.sass_diff --baseline-csrc DIR [--match grow_rounds_kernel]

Run from the repository root on a machine with the CUDA toolkit (no card is
needed). DIR is another revision's ``deplex_tpu_torch/csrc`` (``git archive
<rev> deplex_tpu_torch/csrc | tar -x -C build/parent``). Both sources are
built afresh under ``build/deplex_tpu_torch/sass_diff/`` with the package's
flags, and ``cuobjdump -sass`` lists each library's kernels. A kernel's
name loses its anonymous namespace's hash, which differs between sources,
and its lines their spacing; the listings are then compared line for line,
encodings included.

Lines: ``[build] name=tree|baseline seconds=S``, then for every kernel whose
mangled name contains ``--match``: ``[sass] <name> tree=N baseline=N
identical=True|False local_accesses=[tree, baseline]`` (N instructions
lines, 0 where a side lacks the kernel; local accesses count LDL and STL,
spills or local arrays), and for a kernel on both sides that differs, its
count of differing lines and the first few pairs.
"""

from __future__ import annotations

import argparse
import pathlib
import re
import shutil
import subprocess
import tempfile
import time

from deplex_tpu_torch.kernels import _build


def cuobjdump() -> str:
    nvcc = pathlib.Path(_build._nvcc())
    found = shutil.which("cuobjdump") or str(nvcc.parent / "cuobjdump")
    if not pathlib.Path(found).exists():
        raise RuntimeError("cuobjdump not found beside nvcc")
    return found


def sass(library: pathlib.Path) -> dict:
    """The SASS of `library`'s kernels, as ``parse`` gives it."""
    return parse(subprocess.run([cuobjdump(), "-sass", str(library)], capture_output=True,
                                text=True, check=True).stdout)


def parse(listing: str) -> dict:
    """Kernel name (anonymous-namespace hash dropped) -> its lines of a
    ``cuobjdump -sass`` listing, whitespace collapsed."""
    kernels, cur = {}, None
    for line in listing.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", m.group(1))
            kernels[cur] = []
        elif cur is not None:
            kernels[cur].append(" ".join(line.split()))
    return kernels


def build(name: str, csrc: pathlib.Path, root: pathlib.Path) -> pathlib.Path:
    """Build `csrc` afresh into `root`; prints its build time."""
    out = pathlib.Path(tempfile.mkdtemp(prefix=f"{name}_", dir=root)) / "lib.so"
    t0 = time.perf_counter()
    _build.compile_library(out, csrc)
    print(f"[build] name={name} seconds={time.perf_counter() - t0:.1f}", flush=True)
    return out


def compare(tree: dict, base: dict, match: str, show: int = 4) -> int:
    """Prints the comparison of every kernel matching `match`; returns the
    number of kernels on both sides that differ."""
    differ = 0
    for name in sorted(set(tree) | set(base)):
        if match not in name:
            continue
        a, b = tree.get(name), base.get(name)
        local = [sum(("LDL" in ln or "STL" in ln) for ln in x or []) for x in (a, b)]
        print(f"[sass] {name} tree={len(a or [])} baseline={len(b or [])} "
              f"identical={a == b} local_accesses={local}", flush=True)
        if a is not None and b is not None and a != b:
            differ += 1
            pairs = [(old, new) for new, old in zip(a, b) if new != old]
            print(f"[sass]   differing lines {len(pairs) + abs(len(a) - len(b))}")
            for old, new in pairs[:show]:
                print(f"[sass]   baseline: {old[:150]}")
                print(f"[sass]   tree:     {new[:150]}")
    return differ


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline-csrc", type=pathlib.Path, required=True)
    ap.add_argument("--match", default="grow_rounds_kernel",
                    help="compare the kernels whose mangled name contains this")
    args = ap.parse_args(argv)
    root = _build.build_dir() / "sass_diff"
    root.mkdir(parents=True, exist_ok=True)
    tree = sass(build("tree", _build.CSRC, root))
    base = sass(build("baseline", args.baseline_csrc, root))
    differ = compare(tree, base, args.match)
    print(f"[sass] kernels on both sides that differ: {differ}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
