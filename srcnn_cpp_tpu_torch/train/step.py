"""The SRCNN training step on PyTorch autograd.

The port of ``srcnn_cpp_tpu/train/step.py``.  The reference ships a frozen
checkpoint (reference src/convdata.h) and no trainer; the original SRCNN
recipe (Dong et al. 2014, which that checkpoint came from) is MSE
regression from bicubic-upscaled LR patches to HR patches:

* :func:`mse_loss` — pixel MSE in the 0-255 weight domain;
* :func:`make_train_step` — one device, any ``torch.optim`` optimizer;
* :func:`make_sharded_train_step` — the batch over a mesh's ``data`` axis
  and each patch's rows and columns over ``row`` and ``col``, stitched
  with halo exchange (:func:`..parallel.tiling._srcnn_tile_f32`), so the
  sharding is exact, not an approximation; :func:`shard_batch` places a
  batch on the mesh.

The JAX step differentiates three XLA convolutions at
``Precision.HIGHEST`` and reaches no Pallas kernel; here forward and
backward are float32 ``F.conv2d`` (cuDNN on the card) with TF32 off for
both, its counterpart.
"""

from __future__ import annotations

import numpy as np
import torch

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


def shard_batch(mesh, x) -> list:
    """This process's blocks of a ``[B, H, W]`` batch (NumPy or tensor)
    over ``mesh`` (batch over ``data``, rows over ``row``, columns over
    ``col``, as ``tensor_split`` cuts them), each on its device: a list in
    grid order, ``None`` for a block of another process."""
    from ..parallel.tiling import split_blocks

    x = torch.from_numpy(np.ascontiguousarray(x)) \
        if isinstance(x, np.ndarray) else x
    return list(split_blocks(x, mesh).flat)


def make_sharded_train_step(mesh, model, optimizer):
    """The mesh-parallel step ``step(x, t) -> loss`` (a float, before the
    update) of ``model`` (9-1-5 filters) and its ``torch.optim`` optimizer.

    ``x``/``t``: the global ``[B, H, W]`` batch, or the lists of
    :func:`shard_batch`.  Each block's forward runs on its device with the
    halo exchange; the loss is the sum of squared errors over every block
    over the global element count, so its gradient is the monolithic
    step's.  Inside one process autograd sums each block's gradient into
    the parameters through the blocks' copies of them; across processes
    the gradients and the loss are then ``all_reduce``-summed (host copies
    over gloo), so every process takes the same update.  The port of JAX
    ``make_sharded_train_step`` (``psum`` over ``(data, row)``), which also
    takes the parameters' owner here: the optimizer holds tensors, not
    their names.
    """
    import torch.distributed as dist

    from ..parallel.tiling import _srcnn_tile_f32

    device = next(model.parameters()).device
    shape = mesh.devices.shape
    spans = dist.is_available() and dist.is_initialized() and \
        len(set(mesh.ranks.flat)) > 1
    host = spans and dist.get_backend() == "gloo"

    def grid(a) -> np.ndarray:
        out = np.empty(shape, dtype=object)
        for i, blk in enumerate(a if isinstance(a, list)
                                else shard_batch(mesh, a)):
            out.flat[i] = blk
        return out

    def reduce(t: torch.Tensor) -> torch.Tensor:
        if not spans:
            return t
        r = t.cpu() if host else t
        dist.all_reduce(r)
        return r.to(t.device)

    def step(x, t) -> float:
        xs, ts = grid(x), grid(t)
        local = mesh.local_blocks()
        count = reduce(torch.tensor(float(sum(xs[q].numel() for q in local)),
                                    dtype=torch.float64, device=device))
        optimizer.zero_grad(set_to_none=True)
        with fp32_strict():
            preds = _srcnn_tile_f32(xs, model, mesh)
            se = sum(((preds[q] - ts[q].to(preds[q].dtype)) ** 2).sum()
                     .to(device) for q in local)
            loss = se / count.to(se.dtype)
            loss.backward()
        for p in model.parameters():
            if p.grad is not None:
                p.grad.copy_(reduce(p.grad))
        optimizer.step()
        return float(reduce(loss.detach()))

    return step
