"""Compare the machine code of named kernels between two checkouts.

    python3 tools/sass_diff.py OLD_CHECKOUT NEW_CHECKOUT [SOURCE:KERNEL[:ALSO]]...

Builds the sources of KERNELS from each checkout's
`orion_tpu_torch/csrc/` with the port's flags (`ops/cuda_build.py`'s
NVCC_FLAGS, all builds started together) into a temporary directory,
disassembles each library with `cuobjdump -sass`, and prints for each
kernel its instruction count in both and whether the instructions are
the same, encodings included, addresses aside (and, where they are not,
the first lines that differ). A kernel whose shared
headers or source changed around it but whose code did not prints
"same": what a redesign of other kernels must leave alone (kernels 1
and 8, both training pairs 3a/3b and 9a/9b, the four instantiations of
the wavefront's walk 5 (nearest and any-hit, spread and counted), and
the bounce pipeline's walk 6a, the draw kernel that shares 6b's launch
entry, and the four instantiations of its shade kernel 6c; kernels 2, 4,
7a, 7b, 10, 11 and 6b's vis kernel, redesigned since, are not in the
list). More kernels may
be named after the two checkouts, as `source:kernel` or
`source:kernel:also`. Exit code 1 if a kernel differs or is missing.
"""

from __future__ import annotations

import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# (source, a string of the kernel's mangled name, more such strings: a
# template's bool arguments mangle as ILb0E / ILb1E, <false, true> as
# ILb0ELb1E; a name's length comes before it, so 17prb_replay_kernel is
# 3b's and not 9b's bvh_prb_replay_kernel)
KERNELS = (("fused_path", "fused_path_kernel", ()),
           ("prb", "17prb_fwd_ls_kernel", ()),
           ("prb", "17prb_replay_kernel", ()),
           *(("bvh_intersect", "bvh_intersect_kernel", (f"ILb{a}ELb{c}E",))
             for a in (0, 1) for c in (0, 1)),
           ("bvh_path", "bvh_path_kernel", ()),
           ("prb", "bvh_prb_fwd_kernel", ()),
           ("prb", "bvh_prb_replay_kernel", ()),
           ("bounce", "bounce_walk_kernel", ()),
           ("bounce", "bounce_draw_kernel", ()),
           *(("bounce", "bounce_shade_kernel", (f"ILb{a}ELb{v}E",))
             for a in (0, 1) for v in (0, 1)))
SHOW = 8        # differing lines printed for a kernel that differs


def functions(sass: str) -> dict:
    """{mangled name: [instruction lines without their address]} of
    cuobjdump -sass's text, runs of blanks made one (cuobjdump pads the
    encodings to a column that depends on the whole library)."""
    out = {}
    for part in sass.split("Function : ")[1:]:
        name, body = part.split("\n", 1)
        out[name.strip()] = [
            " ".join(re.sub(r"^\s*/\*[0-9a-f]{4,}\*/", "", line).split())
            for line in body.splitlines()
            if re.match(r"^\s*/\*[0-9a-f]{4,}\*/", line)
            or re.match(r"^\s*/\* 0x[0-9a-f]+ \*/", line)]
    return out


def pick(funcs: dict, kernel: str, also) -> list | None:
    names = [n for n in funcs if kernel in n and all(a in n for a in also)]
    return funcs[names[0]] if len(names) == 1 else None


def parse_kernels(names) -> tuple:
    """KERNELS and the kernels named as `source:kernel[:also]`."""
    extra = []
    for name in names:
        src, kernel, *also = name.split(":")
        extra.append((src, kernel, tuple(also)))
    return KERNELS + tuple(extra)


def main(argv) -> int:
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    from orion_tpu_torch.ops import cuda_build

    kernels = parse_kernels(argv[2:])
    nvcc = cuda_build._nvcc()
    cuobjdump = str(Path(nvcc).with_name("cuobjdump"))
    sources = sorted({k[0] for k in kernels})
    with tempfile.TemporaryDirectory() as tmp:
        procs, libs = [], {}
        for tag, root in (("old", argv[0]), ("new", argv[1])):
            for src in sources:
                so = Path(tmp) / f"{tag}_{src}.so"
                cu = (Path(root).resolve() / "orion_tpu_torch" / "csrc"
                      / f"{src}.cu")
                procs.append(subprocess.Popen(
                    [nvcc, *cuda_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True))
                libs[tag, src] = so
        for p in procs:
            log, _ = p.communicate()
            if p.returncode != 0:
                print(log, file=sys.stderr)
                return 1
        sass = {key: functions(subprocess.run(
            [cuobjdump, "-sass", str(so)], capture_output=True, text=True,
            check=True, timeout=300).stdout) for key, so in libs.items()}
    rc = 0
    for src, kernel, also in kernels:
        old = pick(sass["old", src], kernel, also)
        new = pick(sass["new", src], kernel, also)
        if old is None or new is None:
            print(f"{src} {kernel} {also}: missing in "
                  f"{'old' if old is None else 'new'}")
            rc = 1
            continue
        same = old == new
        rc |= not same
        print(f"{src} {kernel}{''.join(f' [{a}]' for a in also)}: "
              f"{len(old)} / {len(new)} instruction lines, "
              f"{'same' if same else 'DIFFERENT'}")
        diffs = [(k, a, b) for k, (a, b) in enumerate(zip(old, new))
                 if a != b]
        for k, a, b in diffs[:SHOW]:
            print(f"  line {k}: old {a}\n  line {k}: new {b}")
        if len(diffs) > SHOW:
            print(f"  ... {len(diffs)} lines differ")
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
