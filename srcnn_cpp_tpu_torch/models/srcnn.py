"""The SRCNN model family (Dong et al. 2014) as ``nn.Module``\\ s.

The counterpart of ``srcnn_cpp_tpu/models/srcnn.py``.  The reference
hard-codes one architecture (64/32 filters, 9-5-5, reference
src/convdata.h:4-16); :class:`SRCNN` is the paper's whole family (9-1-5,
9-3-5, 9-5-5, any filter counts) with trainable parameters, whose forward
is the differentiable float32 conv stack
(:func:`..ops.srcnn.srcnn_family_f32`) that the trainer runs.
:class:`SRCNN955` serves the canonical configuration through the fused K1
kernel.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.cuda_srcnn import srcnn_y_fused
from ..ops.quantize import quantize_trunc_u8
from ..ops.srcnn import srcnn_family_f32
from ..weights import CANONICAL, SRCNNWeights, load_weights
from ..weights.loader import _KEYS, family_shapes


class SRCNN(nn.Module):
    """SRCNN ``f1-f2-f3`` with ``n1``/``n2`` feature maps (default: the
    checkpoint's 64/32, 9x9 - 1x1 - 5x5); parameters ``conv1_w`` ...
    ``conv3_b`` in OIHW layout, named as in :class:`SRCNNWeights`."""

    def __init__(self, n1: int = 64, n2: int = 32, f1: int = 9, f2: int = 1,
                 f3: int = 5, device=None) -> None:
        super().__init__()
        self.n1, self.n2, self.f1, self.f2, self.f3 = n1, n2, f1, f2, f3
        for k, shape in family_shapes(n1, n2, f1, f2, f3).items():
            self.register_parameter(k, nn.Parameter(
                torch.zeros(shape, dtype=torch.float32, device=device)))

    @property
    def config(self) -> tuple[int, int, int, int, int]:
        return self.n1, self.n2, self.f1, self.f2, self.f3

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None
                         ) -> "SRCNN":
        """Random init per the SRCNN paper: N(0, 1e-3) weights, zero biases
        (the 0-255 pixel domain of the reference weights).  The numbers
        come from ``generator`` (on the CPU) and differ from ``jax.random``'s
        for the same seed."""
        for k in _KEYS:
            p = getattr(self, k)
            if k.endswith("_b"):
                p.zero_()
            else:
                p.copy_(torch.randn(p.shape, generator=generator) * 1e-3)
        return self

    def pretrained(self) -> SRCNNWeights:
        """The reference checkpoint (only valid for the default config)."""
        if self.config != CANONICAL:
            raise ValueError("pretrained weights exist only for 9-5-5 64/32")
        return load_weights(device=self.conv1_w.device)

    @classmethod
    def from_weights(cls, weights: SRCNNWeights | None = None,
                     device=None) -> "SRCNN":
        """A model of ``weights``' configuration holding a copy of them (the
        pretrained checkpoint when None)."""
        weights = weights if weights is not None else load_weights()
        device = weights.device if device is None else device
        model = cls(*weights.config, device=device)
        with torch.no_grad():
            for k, v in weights.as_dict().items():
                getattr(model, k).copy_(v)
        return model

    def weights(self) -> SRCNNWeights:
        """The parameters as :class:`SRCNNWeights` (detached views that
        share their storage)."""
        return SRCNNWeights(**{k: getattr(self, k).detach() for k in _KEYS})

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        """Pre-upscaled Y planes ``[H, W]`` / ``[B, H, W]`` (0-255 domain)
        -> float32, differentiable in the parameters."""
        return srcnn_family_f32(y, self)

    def infer_u8(self, y_u8: torch.Tensor) -> torch.Tensor:
        """uint8 -> uint8 with the reference's truncating quantization."""
        with torch.no_grad():
            return quantize_trunc_u8(self(y_u8))

    def num_params(self) -> int:
        return (self.n1 * self.f1 ** 2 + self.n1
                + self.n2 * self.n1 * self.f2 ** 2 + self.n2
                + self.n2 * self.f3 ** 2 + 1)


class SRCNN955(nn.Module):
    """SRCNN 9-5-5 with 64/32 feature maps for serving: the fused K1 kernel
    on CUDA, its plain fp32 version on the CPU; parameters in OIHW layout,
    frozen."""

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
