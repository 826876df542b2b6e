"""The SRCNN training step on PyTorch autograd.

The port of ``srcnn_cpp_tpu/train/step.py``.  The reference ships a frozen
checkpoint (reference src/convdata.h) and no trainer; the original SRCNN
recipe (Dong et al. 2014, which that checkpoint came from) is MSE
regression from bicubic-upscaled LR patches to HR patches:

* :func:`mse_loss` — pixel MSE in the 0-255 weight domain;
* :func:`make_train_step` — one device, any ``torch.optim`` optimizer.

The JAX step differentiates three XLA convolutions at
``Precision.HIGHEST`` and reaches no Pallas kernel; here forward and
backward are float32 ``F.conv2d`` (cuDNN on the card) with TF32 off for
both, its counterpart.  The mesh-parallel step waits for the port of
``parallel/``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..configs import _NEEDS_PARALLEL
from ..ops.srcnn import fp32_strict

__all__ = ["mse_loss", "make_train_step", "make_sharded_train_step",
           "shard_batch"]


def mse_loss(model, x, target) -> torch.Tensor:
    """Mean squared error of ``model`` on pre-upscaled input ``x``.

    ``x``/``target``: ``[B, H, W]`` in the 0-255 domain (uint8 or float)
    on the model's device.
    """
    pred = model(x)
    return torch.mean((pred - target.to(pred.dtype)) ** 2)


def _on(a, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a)) if isinstance(a, np.ndarray) \
        else a
    return t.to(device)


def make_train_step(model, optimizer):
    """One training step ``step(x, t) -> loss`` (a float, before the update).

    ``x``/``t`` (NumPy arrays or tensors) go to the model's device; then
    ``zero_grad``, forward and backward with TF32 off, ``optimizer.step()``.
    """
    device = next(model.parameters()).device

    def step(x, t) -> float:
        x, t = _on(x, device), _on(t, device)
        optimizer.zero_grad(set_to_none=True)
        with fp32_strict():
            loss = mse_loss(model, x, t)
            loss.backward()
        optimizer.step()
        return float(loss.detach())

    return step


def make_sharded_train_step(*args, **kwargs):
    """The mesh-parallel step (batch and rows sharded): not ported yet."""
    raise NotImplementedError(f"make_sharded_train_step {_NEEDS_PARALLEL}")


def shard_batch(*args, **kwargs):
    """Place a batch sharded over a mesh: not ported yet."""
    raise NotImplementedError(f"shard_batch {_NEEDS_PARALLEL}")
