"""The plain reference against the port's plain pipeline, on the CPU."""

from __future__ import annotations

import pytest
import torch

from portbench import frames, judge, spec
from portbench.reference import color, resize, srcnn, srcnn_bgr

WEIGHTS = spec.HERE / "configs" / "srcnn955.npz"


def _frames(seed: int, n: int, hw) -> torch.Tensor:
    return frames.make(seed, n, hw, "cpu")


@pytest.mark.parametrize("hw,scale", [((24, 40), 2.0), ((27, 35), 1.5),
                                      ((70, 20), 2.0), ((33, 47), 3.0)])
def test_reference_matches_the_port_plain_pipeline(hw, scale):
    from srcnn_cpp_tpu_torch.pipeline import upscale_bgr_batch

    x = _frames(7, 2, hw)
    port = upscale_bgr_batch(x, scale, device="cpu")
    w = srcnn.load(WEIGHTS, "cpu")
    c = judge.Comparison()
    for f, out in zip(x, port):
        c.add(out, srcnn_bgr.upscale_frame(f, w, scale))
    n = c.numbers()
    # the same float32 arithmetic in another summation order: the
    # truncation to uint8 may differ by one LSB at a boundary
    assert n["max_lsb"] <= 1 and n["share_off"] <= 1e-3, n


def test_color_and_resize_are_bit_exact_with_the_port():
    from srcnn_cpp_tpu_torch.ops.color import bgr2ycrcb_u8, ycrcb2bgr_u8
    from srcnn_cpp_tpu_torch.ops.resize import resize_bicubic_u8, scaled_size

    x = _frames(3, 1, (31, 53))[0]
    assert torch.equal(color.bgr2ycrcb(x), bgr2ycrcb_u8(x))
    assert torch.equal(color.ycrcb2bgr(x), ycrcb2bgr_u8(x))
    planes = x.permute(2, 0, 1)
    for scale in (2.0, 1.5, 3.0, 0.75, 1.25):
        ow, oh = scaled_size(53, 31, scale)
        assert resize.output_size(31, 53, scale) == (oh, ow)
        assert torch.equal(resize.resize_plane(planes, (oh, ow)),
                           resize_bicubic_u8(planes, (oh, ow)))


def test_row_blocks_do_not_change_the_conv():
    w = srcnn.load(WEIGHTS, "cpu")
    y = _frames(5, 1, (50, 33))[0, ..., 1]
    whole = srcnn.srcnn_y(y, w, block_rows=64)
    for rows in (1, 3, 7, 16):
        assert torch.equal(srcnn.srcnn_y(y, w, block_rows=rows), whole)


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11,
                      1.0 + 2.0 ** -12, -3.14159265, 255.0])
    r = srcnn.round_tf32(x)
    assert r[0] == 1.0 and r[1] == 1.0 + 2.0 ** -10 and r[5] == 255.0
    assert r[2] == 1.0 + 2.0 ** -10        # a tie rounds away from zero
    assert r[3] == 1.0
    m = r.view(torch.int32) & 0x1FFF
    assert int(m.abs().max()) == 0
    assert abs(float(r[4]) + 3.14159265) < 2.0 ** -9


@pytest.mark.parametrize("seed", [11, 2 ** 31 + 5, 4_000_000_007])
def test_the_tf32_control_fails_the_limit(seed):
    """The control (the reference with the convs' operands in TF32) is
    not correct by the configuration's limits, at a size a test holds."""
    limits = spec.read_json(spec.config_path("batch_1080p_to_4k"))["limits"]
    w = srcnn.load(WEIGHTS, "cpu")
    c = judge.Comparison()
    for f in _frames(seed, 2, (40, 64)):
        c.add(srcnn_bgr.upscale_frame(f, w, 2.0, tf32=True),
              srcnn_bgr.upscale_frame(f, w, 2.0))
    assert not judge.passed(judge.checks(c.numbers(), limits)), c.numbers()

