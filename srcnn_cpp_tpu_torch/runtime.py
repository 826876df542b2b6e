"""Build and load the port's CUDA kernels.

The three kernels of the main path (``csrc/pre_pass.cu``,
``csrc/srcnn_conv.cu``, ``csrc/merge.cu``) have a plain C interface and
are compiled by one ``nvcc`` call into one shared library for ``sm_90a``
(Hopper), loaded with :mod:`ctypes`.  The library is built on first use
into ``_build/`` beside this file, named by a hash of the sources and the
command, so an edited source rebuilds and an unchanged one loads at once.
A failed build raises; nothing falls back.

Every C entry point returns the ``cudaError_t`` of its launch
(``cudaGetLastError`` right after it): a launch the device refuses never
runs and a later synchronize would not report it, so :func:`check` raises
on any non-zero code.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("_build")
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: C signatures: name -> argtypes (every function returns an int error code)
_SIGNATURES = {
    "srcnn_conv_u8": (_P, _LL, _P, _P, _I, _I, _I, _P),
    "pre_pass_u8": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "merge_ycrcb_bgr_u8": (_P, _P, _P, _I, _I, _I, _P),
}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and Path("/usr/local/cuda/bin/nvcc").exists():
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise FileNotFoundError("nvcc not found (needed to build the CUDA "
                                "kernels in srcnn_cpp_tpu_torch/csrc)")
    return nvcc


def nvcc_command(out: Path, nvcc: str = "nvcc") -> list[str]:
    """The one compiler invocation that builds every kernel into ``out``."""
    return [nvcc, *_NVCC_FLAGS, "-o", str(out), *map(str, sources())]


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libsrcnn_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float, str]:
    """Compile the kernels unless already built: ``(path, seconds, log)``.

    ``log`` is the compiler's output (``-Xptxas=-v``: registers, shared
    memory and spills per kernel), also kept beside the library.
    """
    lib = library_path()
    log_path = lib.with_suffix(".log")
    if lib.exists():
        return lib, 0.0, log_path.read_text() if log_path.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(nvcc_command(Path(tmp), find_nvcc()),
                              capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n{log}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    log_path.write_text(log)
    return lib, time.perf_counter() - t0, log


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()[0]))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.srcnn_cuda_error_string.argtypes = (ctypes.c_int,)
    lib.srcnn_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    """Raise if a kernel launch returned a CUDA error code."""
    if err != 0:
        msg = library().srcnn_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def current_stream() -> int:
    """PyTorch's current CUDA stream as a raw handle for the C launchers."""
    import torch

    return torch.cuda.current_stream().cuda_stream
