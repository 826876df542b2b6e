"""The frames a cell sends, made from ``--seed``.

One generator for every traffic mix.  A frame is BGR uint8 ``[H, W, 3]``:
a smooth field (bilinear over a coarse grid of ``smooth_cell`` pixels), a
field of flat blocks with sharp edges (``block_cell`` pixels), and fine
noise, with the amplitudes of :data:`CONTENT`, so that the frames hold the
gradients, edges and texture of natural images and the conv's output is
seldom clamped.  They are made on the card with one
``torch.Generator`` seeded from ``--seed``, in a few large calls, and
copied to the host once when the traffic sends host arrays.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


CHUNK = 8   # frames made at a time: the float temporaries stay small

#: the content of every frame: a mid-grey mean, a smooth field of +-100
#: over 96-pixel cells, flat blocks of +-40 with sharp edges every 24
#: pixels, and +-12 of noise; the limits of ``correct`` were read on these
CONTENT = {"mean": 128, "smooth_cell": 96, "smooth_amp": 200,
           "block_cell": 24, "block_amp": 80, "noise_amp": 24}


def make(seed: int, n: int, hw: tuple[int, int], device) -> torch.Tensor:
    """``n`` distinct frames ``[n, H, W, 3]`` uint8 on ``device``; the same
    ``seed`` gives the same frames."""
    h, w = hw
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    out = torch.empty((n, h, w, 3), dtype=torch.uint8, device=device)
    c = CONTENT

    def field(m: int, cell: int, mode: str) -> torch.Tensor:
        grid = torch.rand((m, 3, -(-h // cell) + 1, -(-w // cell) + 1),
                          generator=g, device=device) - 0.5
        return F.interpolate(grid, size=(h, w), mode=mode)

    for i in range(0, n, CHUNK):
        m = min(CHUNK, n - i)
        x = c["smooth_amp"] * field(m, c["smooth_cell"], "bilinear")
        x += c["block_amp"] * field(m, c["block_cell"], "nearest")
        x += c["noise_amp"] * (torch.rand(
            (m, 3, h, w), generator=g, device=device) - 0.5)
        x += c["mean"]
        out[i:i + m] = x.round_().clamp_(0, 255).to(torch.uint8) \
            .permute(0, 2, 3, 1)
    return out
