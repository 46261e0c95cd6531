"""Build the package's CUDA sources with nvcc and bind them through ctypes.

Each `csrc/<name>.cu` compiles on its own into a shared library with a
plain C interface (`extern "C"`), built at first use into
`orion_tpu_torch/_build/` under a name that carries a hash of the source,
the shared headers and the flags, so an edited source is rebuilt and an
unchanged one is reused. `build()` starts one nvcc per source, all at once.

Nothing here is imported at package import time by the CPU paths: a
kernel is built only when a wrapper is handed a CUDA tensor. There is no
fallback — a missing nvcc, a failed build or a refused launch raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from orion_tpu_torch.profiling import count, span

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")     # -v only reports registers / spills


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (need the CUDA toolkit on PATH "
                           "or under /usr/local/cuda) to build the kernels")
    return path


def lib_path(name: str) -> Path:
    """The library of `csrc/<name>.cu`, named by a hash of the source, the
    shared headers (`csrc/*.cuh`) and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        src += header.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:12]}.so"


def build(names) -> dict:
    """Compile every named source not yet built, one nvcc each, all started
    together. Returns {name: (seconds, nvcc's report)} for the sources it
    compiled; the report carries ptxas's register and spill lines."""
    todo = [n for n in names if not lib_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    with span("kernel.build"):
        for n in todo:
            out = lib_path(n)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True),
                        tmp, out)
        done, failed = {}, []
        for n, (p, tmp, out) in procs.items():
            log, _ = p.communicate()
            done[n] = (time.perf_counter() - t0, log)
            if p.returncode != 0:
                failed.append(f"{n}.cu (rc {p.returncode}):\n{log}")
                continue
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return done


class CudaKernel:
    """One C entry point of one source, with its launch count.

    `launches` grows by one for every successful launch through `launch`
    and nowhere else, so a caller can show that a path ran the kernel.
    A launch while `launches` is 0, the kernel's first, runs in the span
    `kernel.first_launch`: CUDA loads the kernel's module there (lazily).
    """

    def __init__(self, source: str, symbol: str, argtypes):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None

    def _load(self):
        if self._fn is None:
            if build([self.source]):
                count("kernel.built")
            with span("kernel.load"):
                lib = ctypes.CDLL(str(lib_path(self.source)))
                fn = getattr(lib, self.symbol)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
            count("kernel.loaded")
            self._fn = fn
        return self._fn

    def launch(self, *args) -> None:
        fn = self._load()
        if self.launches:
            rc = fn(*args)
        else:
            with span("kernel.first_launch"):
                rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"{self.symbol} launch failed: CUDA error {rc}")
        self.launches += 1


def check_inputs(name: str, device, specs) -> None:
    """Raise ValueError unless each (what, tensor, shape, dtype) of `specs`
    is a contiguous tensor of that shape and dtype on `device`: what a
    kernel reads through a raw pointer."""
    for what, x, shape, dtype in specs:
        if (x.device != device or tuple(x.shape) != tuple(shape)
                or x.dtype != dtype or not x.is_contiguous()):
            raise ValueError(f"{name}: {what} must be a contiguous {dtype} "
                             f"tensor of shape {tuple(shape)} on {device}, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")


def stream_ptr(device) -> int:
    """PyTorch's current stream on `device`, as a C pointer."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
