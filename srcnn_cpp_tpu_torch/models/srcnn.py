"""The SRCNN 9-5-5 model (Dong et al. 2014) as an ``nn.Module``.

The counterpart of ``srcnn_cpp_tpu/models/srcnn.py`` for the canonical
64/32-filter configuration the reference hard-codes (src/convdata.h:4-16).
The forward pass is the fused K1 kernel on CUDA and its plain fp32 version
on the CPU (:func:`..ops.cuda_srcnn.srcnn_y_fused`).  Serving only: random
init, the rest of the family and training are not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.cuda_srcnn import srcnn_y_fused
from ..weights import SRCNNWeights, load_weights


class SRCNN955(nn.Module):
    """SRCNN 9-5-5 with 64/32 feature maps; parameters in OIHW layout."""

    def __init__(self, weights: SRCNNWeights) -> None:
        super().__init__()
        for k, v in weights.as_dict().items():
            self.register_parameter(k, nn.Parameter(v.detach().clone(),
                                                    requires_grad=False))

    @classmethod
    def from_weights(cls, weights: SRCNNWeights | None = None) -> "SRCNN955":
        """From given weights, or the pretrained checkpoint when None."""
        return cls(weights if weights is not None else load_weights())

    def weights(self) -> SRCNNWeights:
        return SRCNNWeights(**dict(self.named_parameters()))

    def forward(self, y_u8: torch.Tensor) -> torch.Tensor:
        """uint8 Y ``[H, W]`` / ``[B, H, W]`` (pre-upscaled) -> uint8."""
        return srcnn_y_fused(y_u8, self.weights())
