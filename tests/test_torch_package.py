"""PyTorch port, package surface: imports, wrapper validation, build, CLI."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent


def test_import_pulls_in_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import srcnn_cpp_tpu_torch, srcnn_cpp_tpu_torch.cli\n"
        "import srcnn_cpp_tpu_torch.pipeline, srcnn_cpp_tpu_torch.models\n"
        "import srcnn_cpp_tpu_torch.evaluate, srcnn_cpp_tpu_torch.stream\n"
        "import srcnn_cpp_tpu_torch.configs, srcnn_cpp_tpu_torch.train\n"
        "import srcnn_cpp_tpu_torch.train.trainer\n"
        "import srcnn_cpp_tpu_torch.weights.checkpoint\n"
        "import srcnn_cpp_tpu_torch.parallel.distributed\n"
        "import srcnn_cpp_tpu_torch.parallel.multihost\n"
        "from srcnn_cpp_tpu_torch import load_weights\n"
        "from srcnn_cpp_tpu_torch.weights import weights_npz\n"
        "load_weights()\n"
        "assert 'srcnn_cpp_tpu_torch' in weights_npz().parts, weights_npz()\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'srcnn_cpp_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, env=env, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_package_root_exports_lazily():
    # as the JAX package's root (srcnn_cpp_tpu/__init__.py:25-38); importing
    # the package itself loads neither torch nor numpy
    code = (
        "import sys\n"
        "import srcnn_cpp_tpu_torch as p\n"
        "assert 'torch' not in sys.modules and 'numpy' not in sys.modules\n"
        "from srcnn_cpp_tpu_torch.models import SRCNN\n"
        "from srcnn_cpp_tpu_torch.weights import SRCNNWeights\n"
        "assert p.SRCNN is SRCNN and p.SRCNNWeights is SRCNNWeights\n"
        "assert isinstance(p.load_weights(), p.SRCNNWeights)\n"
        "assert isinstance(p.SRCNN.from_weights(), p.SRCNN)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, env=env, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _w():
    from srcnn_cpp_tpu_torch.weights import load_weights

    return load_weights()


@pytest.mark.parametrize("bad", [
    torch.zeros((8, 8), dtype=torch.float32),             # dtype
    torch.zeros((2, 2, 8, 8), dtype=torch.uint8),         # rank
    torch.zeros((8, 16), dtype=torch.uint8)[:, ::2],      # plane not contiguous
    torch.zeros((0, 8), dtype=torch.uint8),               # empty plane
])
def test_srcnn_wrapper_rejects(bad):
    from srcnn_cpp_tpu_torch.ops.cuda_srcnn import srcnn_y_fused

    with pytest.raises((TypeError, ValueError)):
        srcnn_y_fused(bad, _w())


def test_srcnn_wrapper_rejects_device_mismatch():
    from srcnn_cpp_tpu_torch.ops.cuda_srcnn import srcnn_y_fused

    y = torch.zeros((8, 8), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        srcnn_y_fused(y, _w())


@pytest.mark.parametrize("bad", [
    torch.zeros((1, 3, 8, 8), dtype=torch.int32),         # dtype
    torch.zeros((3, 8, 8), dtype=torch.uint8),            # rank
    torch.zeros((1, 4, 8, 8), dtype=torch.uint8),         # channels
    torch.zeros((1, 3, 8, 16), dtype=torch.uint8)[..., ::2],  # contiguity
])
def test_pre_pass_wrapper_rejects(bad):
    from srcnn_cpp_tpu_torch.ops.cuda_resize import pre_upscale_fused

    with pytest.raises((TypeError, ValueError)):
        pre_upscale_fused(bad, (16, 16))


def test_pre_pass_wrapper_rejects_empty_output():
    from srcnn_cpp_tpu_torch.ops.cuda_resize import pre_upscale_fused

    with pytest.raises(ValueError):
        pre_upscale_fused(torch.zeros((1, 3, 8, 8), dtype=torch.uint8), (0, 4))


@pytest.mark.parametrize("y,up", [
    (torch.zeros((1, 8, 8), dtype=torch.int16),
     torch.zeros((1, 3, 8, 8), dtype=torch.uint8)),        # dtype
    (torch.zeros((1, 8, 8), dtype=torch.uint8),
     torch.zeros((1, 3, 8, 9), dtype=torch.uint8)),        # shapes differ
    (torch.zeros((8, 8), dtype=torch.uint8),
     torch.zeros((1, 3, 8, 8), dtype=torch.uint8)),        # rank
    (torch.zeros((1, 8, 8), dtype=torch.uint8),
     torch.zeros((1, 3, 8, 16), dtype=torch.uint8)[..., ::2]),  # contiguity
])
def test_merge_wrapper_rejects(y, up):
    from srcnn_cpp_tpu_torch.ops.cuda_merge import merge_ycrcb_to_bgr_fused

    with pytest.raises((TypeError, ValueError)):
        merge_ycrcb_to_bgr_fused(y, up)


def test_nvcc_command_targets_sm90a():
    from srcnn_cpp_tpu_torch import runtime

    srcs = runtime.sources()
    assert {p.name for p in srcs} == {"merge.cu", "pre_pass.cu",
                                      "rcan.cu", "srcnn_conv.cu",
                                      "swinir.cu", "vdsr_conv.cu"}
    for src in srcs:     # one compiler call per source, all for sm_90a
        cmd = runtime.compile_command(src, Path("/tmp/x.o"))
        assert "arch=compute_90a,code=sm_90a" in " ".join(cmd)
        assert "-c" in cmd and "-O3" in cmd and cmd[-1] == str(src)
    link = runtime.link_command([Path("/tmp/a.o"), Path("/tmp/b.o")],
                                Path("/tmp/x.so"))
    assert "-shared" in link and link[-2:] == ["/tmp/a.o", "/tmp/b.o"]
    # the library name follows the sources and the shared header
    assert runtime.library_path().name.startswith("libsrcnn_kernels_")
    assert (runtime.CSRC / "color.cuh").exists()


def test_library_name_follows_the_header(tmp_path, monkeypatch):
    import shutil

    from srcnn_cpp_tpu_torch import runtime

    csrc = tmp_path / "csrc"
    shutil.copytree(runtime.CSRC, csrc)
    monkeypatch.setattr(runtime, "CSRC", csrc)
    before = runtime.library_path()
    (csrc / "color.cuh").write_text((csrc / "color.cuh").read_text() + "\n")
    assert runtime.library_path() != before


def test_kernel_signatures_cover_every_entry_point():
    from srcnn_cpp_tpu_torch import runtime

    code = "".join(p.read_text() for p in runtime.sources())
    for name in runtime._SIGNATURES:
        assert f'extern "C" int {name}(' in code, name


def test_kernel_signatures_give_each_entry_point_its_arguments():
    # ctypes passes what _SIGNATURES declares: as many arguments as the C
    # definition takes, pointers where it takes pointers; the GEMM bodies'
    # entry points end with the stream and the counter records
    import ctypes

    from srcnn_cpp_tpu_torch import runtime

    code = "".join(p.read_text() for p in runtime.sources())
    for name, argtypes in runtime._SIGNATURES.items():
        params = [" ".join(q.split()) for q in re.search(
            rf'extern "C" int {name}\((.*?)\)\s*{{', code, re.S)
            .group(1).split(",")]
        assert len(params) == len(argtypes), name
        for q, t in zip(params, argtypes):
            assert ("*" in q) == (t is ctypes.c_void_p), (name, q)
        if name in ("vdsr_y_u8", "rcan_x2_u8", "rcan_conv3x3_f32",
                    "swinir_x2_u8", "swinir_gemm_f32"):
            assert params[-2:] == ["void* stream", "void* probes"], name


def test_kernel_sources_use_unfused_rounding_in_the_vertical_pass():
    # nvcc contracts a*b+c into an FMA by default; the pre-pass's bit
    # identity with OpenCV needs separately rounded products and sums
    # (every float product and sum of the vertical chain is an _rn
    # intrinsic, and so is the add of the rounding form)
    src = (REPO / "srcnn_cpp_tpu_torch/csrc/pre_pass.cu").read_text()
    code = "\n".join(line for line in src.splitlines()
                     if not line.lstrip().startswith("//"))
    body = re.search(r"uint32_t chain\(float h0.*?\n}\n", code, re.S).group(0)
    body = body[body.index("{"):]
    assert body.count("__fmul_rn(") == 4 and body.count("__fadd_rn(") == 3
    assert not re.search(r"[^_\w](\*|\+)[^+]", body.replace("__f", "")), body
    rnd = re.search(r"uint32_t round_u8\(float v\).*?\n}\n", code, re.S).group(0)
    assert "__fadd_rn(" in rnd and "12582912.f" in code
    assert code.count("chain(h0.") == 4      # one chain per column


def test_sass_counts_reads_one_kernel_of_cuobjdump(monkeypatch, tmp_path):
    # the static opcode counts of one kernel's SASS, as chip_smoke.py phase 1
    # and kernel_ab print them for K2 (predicated and uniform forms counted);
    # None where cuobjdump is absent or fails
    import subprocess as sp

    from srcnn_cpp_tpu_torch import kernel_ab

    dump = "\n".join([
        "\tFunction : _ZN12_GLOBAL__N_113merge_kernelEv",
        "        /*0000*/                   I2F R1, R2 ;   /* 0x0 */",
        "\tFunction : _ZN12_GLOBAL__N_115pre_pass_kernelEPKh",
        "        /*0000*/                   LDG.E.U8 R2, desc[UR4][R2.64] ;",
        "        /*0010*/              @!P0 STG.E [R4.64], R7 ;",
        "        /*0020*/                   I2F R1, R2 ;",
        "        /*0028*/                   I2FP.F32.S32 R1, R2 ;",
        "        /*0030*/               @P1 LDS.128 R8, [R3] ;",
        "        /*0040*/                   LDS R8, [R3+0x4] ;",
        "        /*0050*/                   IDP.2A.LO.S16.U8 R1, R2, R3, RZ ;",
        "        /*0060*/                   FADD R1, R2, R3 ;",
    ])
    rc = [0]
    monkeypatch.setattr(kernel_ab.shutil, "which", lambda name: "cuobjdump")
    monkeypatch.setattr(kernel_ab.subprocess, "run", lambda *a, **k:
                        sp.CompletedProcess(a, rc[0], dump, ""))
    got = kernel_ab.sass_counts(tmp_path / "lib.so", "pre_pass_kernel")
    assert got == {"I2F": 1, "I2FP": 1, "F2I": 0, "FRND": 0, "IDP": 1,
                   "LDS": 2, "STS": 0, "LDG": 1, "STG": 1}
    rc[0] = 1
    assert kernel_ab.sass_counts(tmp_path / "lib.so", "pre_pass_kernel") is None
    monkeypatch.setattr(kernel_ab.shutil, "which", lambda name: None)
    monkeypatch.setattr(kernel_ab, "Path", lambda p: tmp_path / "absent")
    assert kernel_ab.sass_counts(tmp_path / "lib.so", "pre_pass_kernel") is None


def test_packed_size_constant_matches_the_cuda_source():
    from srcnn_cpp_tpu_torch.ops.cuda_srcnn import PACKED_SIZE

    # srcnn_conv.cu static_asserts its own size; this ties the two together
    src = (REPO / "srcnn_cpp_tpu_torch/csrc/srcnn_conv.cu").read_text()
    assert f"static_assert(WTOTAL == {PACKED_SIZE}," in src


# --- CLI -----------------------------------------------------------------------

def test_cli_parse_args_surface():
    from srcnn_cpp_tpu_torch.cli import UsageError, parse_args

    opts = parse_args(["photo.png"])
    assert (opts["scale"], opts["verbose"], opts["device"], opts["dst"]) == \
        (2.0, True, "cuda", "photo_resized.png")
    assert parse_args(["--scale=1.5", "a.jpg"])["scale"] == 1.5
    assert parse_args(["--scale=-3", "a.jpg"])["scale"] == 2.0
    assert parse_args(["--scale=abc", "a.jpg"])["scale"] == 2.0
    assert parse_args(["--noverbose", "in.png", "out.png"])["dst"] == "out.png"
    assert parse_args(["--device=cpu", "a.png"])["device"] == "cpu"
    assert parse_args(["--repeat=0", "a.png"])["repeat"] == 1
    assert parse_args(["--help"]) is None
    for argv in (["--bogus", "a.png"], ["--device=tpu", "a.png"],
                 ["--repeat=abc", "a.png"]):
        with pytest.raises(UsageError):
            parse_args(argv)


def test_cli_help_and_usage_errors(capsys):
    from srcnn_cpp_tpu_torch.cli import main

    assert main(["--help"]) == 0
    assert "Usage:" in capsys.readouterr().out
    assert main(["--noverbose"]) == 0
    assert main(["--bogus", "a.png"]) == 1
    assert "unknown option" in capsys.readouterr().err


def test_cli_cpu_end_to_end(tmp_path):
    from srcnn_cpp_tpu_torch.cli import main
    from srcnn_cpp_tpu_torch.imageio import imread_bgr, imwrite_bgr
    from srcnn_cpp_tpu_torch.pipeline import upscale_bgr

    img = np.random.default_rng(5).integers(0, 256, (20, 30, 3),
                                            dtype=np.uint8)
    src = tmp_path / "in.png"
    assert imwrite_bgr(src, img)
    assert main(["--noverbose", "--device=cpu", "--scale=1.5", str(src)]) == 0
    out = imread_bgr(tmp_path / "in_resized.png")
    assert out.shape == (30, 45, 3)
    assert np.array_equal(out, upscale_bgr(img, 1.5, device="cpu"))


def test_cli_exit_codes(tmp_path, monkeypatch):
    import srcnn_cpp_tpu_torch.cli as cli

    assert cli.main(["--noverbose", "--device=cpu",
                     str(tmp_path / "missing.png")]) == 1
    monkeypatch.setattr(cli, "imread_bgr", lambda p: np.zeros((8, 8), np.uint8))
    assert cli.main(["--noverbose", "--device=cpu", "gray.png"]) == 2
    monkeypatch.setattr(cli, "imread_bgr",
                        lambda p: np.zeros((8, 8, 3), np.uint8))
    monkeypatch.setattr(cli, "upscale_bgr",
                        lambda *a, **k: np.zeros((16, 16, 2), np.uint8))
    assert cli.main(["--noverbose", "--device=cpu", "in.png"]) == 3


def test_cli_default_device_without_gpu_is_an_error(tmp_path, monkeypatch,
                                                     capsys):
    import srcnn_cpp_tpu_torch.cli as cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["--noverbose", str(tmp_path / "in.png")]) == 1
    assert "no CUDA device" in capsys.readouterr().err
