"""Final pixel quantization matching the reference's IntTrim semantics.

The reference converts the conv3 float output to uint8 by C float->int
conversion (truncation toward zero) followed by a [0,255] clamp
(reference src/srcnn.cpp:238-240, IntTrim at :77-81).  Truncation — not
rounding — is PSNR-visible, so it is preserved here.
"""

from __future__ import annotations

import torch


def quantize_trunc_u8(x: torch.Tensor) -> torch.Tensor:
    """float [...] -> uint8 via truncation toward zero, then clamp [0,255].

    The clamp comes before the cast: a float->uint8 cast of an
    out-of-range value is undefined.
    """
    return torch.trunc(x).clamp(0, 255).to(torch.uint8)
