"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into a shared library with a
plain C interface, one library per source, all sources compiled in
parallel, at first use.  The libraries go to
``build/repro_torch_kernels/<hash of the sources and flags>/`` at the
root of the checkout, so an edited source is rebuilt and an unchanged
one is loaded as it is.  They are loaded with ``ctypes``.

Nothing here runs at import: nvcc runs only when a CUDA tensor first
asks for a kernel, so the package imports on machines without CUDA.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LIBS: Dict[str, ctypes.CDLL] = {}


def sources() -> Dict[str, Path]:
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name, path in sources().items():
        h.update(name.encode())
        h.update(path.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                       "build repro_torch's kernels")


def build_all() -> Path:
    """Compile every source missing from the build dir, all at once.

    Each library is written under a temporary name and renamed into
    place, so concurrent builders never load a half-written file.  A
    failed compile raises with nvcc's output; each source's compiler
    log (``-Xptxas -v``: registers, shared memory, spills) is kept
    beside its library as ``<name>.log``.
    """
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    todo = {n: p for n, p in sources().items()
            if not (out / f"lib{n}.so").exists()}
    if not todo:
        return out
    nvcc = _nvcc()
    procs = {}
    for name, src in todo.items():
        fd, tmp = tempfile.mkstemp(prefix=f"lib{name}.", suffix=".so.tmp",
                                   dir=out)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(src)]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        (out / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- nvcc {todo[name].name} "
                          f"(exit {proc.returncode}) ---\n{log}")
            os.unlink(tmp)
        else:
            os.replace(tmp, out / f"lib{name}.so")
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all() / f"lib{name}.so"))
        _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: kernel launch returned CUDA error "
                           f"{err} (cudaError_t)")
