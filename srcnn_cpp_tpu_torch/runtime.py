"""Build and load the port's CUDA kernels.

The kernels (``csrc/pre_pass.cu``; ``csrc/srcnn_conv.cu``, whose template
gives the conv, conv+merge and f32-output conv; ``csrc/merge.cu``;
``csrc/vdsr_conv.cu``, the VDSR chain and the 64->64 conv it shares;
``csrc/rcan.cu``, RCAN; ``csrc/swinir.cu``, SwinIR; the shared headers ``csrc/color.cuh``,
``csrc/wgmma.cuh`` and ``csrc/conv3x3.cuh``) have a plain C interface.  Each
``.cu`` source is compiled for ``sm_90a`` (Hopper) by its own ``nvcc``, all
started together,
and the objects are linked into one shared library, loaded with
:mod:`ctypes`.  The library is built on first use into ``_build/`` beside
this file, named by a hash of the sources, headers and flags, so an edited
source or header rebuilds and an unchanged one loads at once.  A failed
build raises; nothing falls back.

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
import sys
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("_build")
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
#: C signatures: name -> argtypes (every function returns an int error code)
_SIGNATURES = {
    "srcnn_conv_u8": (_P, _LL, _P, _P, *(_I,) * 7, _P),
    "srcnn_conv_f32": (_P, _LL, _P, _P, *(_I,) * 7, _P),
    "srcnn_conv_merge_u8": (_P, _P, _P, *(_I,) * 7, _P),
    "pre_pass_u8": (*(_P,) * 8, *(_I,) * 10, _P),
    "pre_pass_resident_blocks": (_I, _P),
    "merge_ycrcb_bgr_u8": (_P, _P, _P, *(_I,) * 6, _LL, _P),
    "vdsr_y_u8": (_P, _LL, *(_P,) * 6, *(_I,) * 5, _P),
    "rcan_x2_u8": (_P, _LL, *(_P,) * 6, *(_I,) * 7, _P),
    "rcan_conv3x3_f32": (_I, _I, *(_P,) * 10, *(_I,) * 8, _P),
    "swinir_x2_u8": (_P, _LL, *(_P,) * 7, *(_I,) * 8, _F, _P),
    "swinir_gemm_f32": (_I, *(_P,) * 3, _I, *(_P,) * 3, *(_I,) * 4, _F, _P),
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


def compile_command(src: Path, obj: Path, nvcc: str = "nvcc") -> list[str]:
    """The compiler invocation that builds one source into object ``obj``."""
    return [nvcc, *_NVCC_FLAGS, "-c", "-o", str(obj), str(src)]


def link_command(objs, out: Path, nvcc: str = "nvcc") -> list[str]:
    """The invocation that links the objects into the shared library."""
    return [nvcc, "-shared", "-o", str(out), *map(str, objs)]


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libsrcnn_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float, str]:
    """Compile the kernels unless already built: ``(path, seconds, log)``.

    ``log`` is the compilers' output (``-Xptxas=-v``: registers, shared
    memory and spills per kernel), also kept beside the library.
    """
    lib = library_path()
    log_path = lib.with_suffix(".log")
    if lib.exists():
        return lib, 0.0, log_path.read_text() if log_path.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp = Path(tmp)
        jobs = []
        for src in sources():
            obj, out = tmp / f"{src.stem}.o", tmp / f"{src.stem}.log"
            with open(out, "w") as f:
                jobs.append((src, out, subprocess.Popen(
                    compile_command(src, obj, nvcc), stdout=f,
                    stderr=subprocess.STDOUT)))
        logs, failed = [], []
        for src, out, proc in jobs:
            rc = proc.wait()
            logs.append(f"== {src.name}\n{out.read_text()}")
            if rc != 0:
                failed.append(f"{src.name} (exit {rc})")
        log = "".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed: {', '.join(failed)}\n{log}")
        so = tmp / lib.name
        proc = subprocess.run(
            link_command([tmp / f"{s.stem}.o" for s in sources()], so, nvcc),
            capture_output=True, text=True)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed (exit {proc.returncode}):"
                               f"\n{log}")
        os.replace(so, lib)
    log_path.write_text(log)
    return lib, time.perf_counter() - t0, log


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    from .utils.profiling import span

    with span("srcnn.build.library"):
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


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def num_sms() -> int:
    """The number of SMs of the current CUDA device (the launch plans size
    their grids by it)."""
    import torch

    return _sm_count(torch.cuda.current_device())


#: the devices the CLIs take (``--device``)
DEVICES = ("cuda", "cpu")


def device_name(device) -> str:
    """The card's name for a CUDA device, ``"cpu"`` otherwise."""
    import torch

    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"


def cuda_missing(device: str, prog: str) -> bool:
    """True, after an error message on stderr, when ``device`` is ``cuda``
    and no GPU is available: the CLIs never fall back to the CPU."""
    import torch

    if device != "cuda" or torch.cuda.is_available():
        return False
    print(f"{prog}: no CUDA device available (use --device=cpu to run "
          "the plain PyTorch path)", file=sys.stderr)
    return True
