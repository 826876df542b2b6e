"""Training entry point: fit SRCNN on a directory of images.

    python -m srcnn_cpp_tpu_torch.train --data Pictures/ --scale 2 \
        --steps 200 --out srcnn_trained.npz [--from-scratch] [--device=cuda|cpu]

The port of ``srcnn_cpp_tpu/train/trainer.py``: the reference checkpoint's
own recipe (Dong et al. 2014: Y-channel MSE on 33x33 bicubic-degraded
patches) with Adam, on one device.  The default device is ``cuda``; without
a GPU that is an error, never a silent run on the CPU.  ``--sharded`` runs
the mesh-parallel step (:func:`.step.make_sharded_train_step`) on
``make_mesh()``: every visible card on the ``row`` axis (on the CPU, one
block).  The trained npz serves through :func:`srcnn_cpp_tpu_torch.load_weights` and the pipeline.
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..models import SRCNN
from ..parallel import make_mesh
from ..runtime import DEVICES, cuda_missing, device_name
from ..weights import SRCNNWeights
from ..weights.checkpoint import save_npz
from .data import dataset_from_dir, iterate_minibatches
from .step import make_sharded_train_step, make_train_step

_PROG = "srcnn-torch-train"


def fit(data_dir, scale: float = 2.0, steps: int = 200, batch: int = 64,
        lr: float = 1e-4, from_pretrained: bool = True, sharded: bool = False,
        seed: int = 0, log_every: int = 20, verbose: bool = True,
        device="cuda") -> tuple[SRCNNWeights, list[float]]:
    """Returns ``(weights, losses)``: the trained weights on ``device`` and
    the loss of each step (before its update).  ``sharded`` trains with the
    mesh-parallel step on ``make_mesh()`` (every visible card on ``row``;
    one block on ``device`` elsewhere)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("fit: device 'cuda' but no CUDA device is "
                           "available (pass device='cpu' to train on the CPU)")
    if from_pretrained:
        model = SRCNN.from_weights(device=device)
    else:
        model = SRCNN(device=device).reset_parameters(
            torch.Generator().manual_seed(seed))
    opt = torch.optim.Adam(model.parameters(), lr=lr, eps=1e-8)
    if sharded:
        mesh = make_mesh() if device.type == "cuda" else \
            make_mesh(devices=[device])
        step = make_sharded_train_step(mesh, model, opt)
    else:
        step = make_train_step(model, opt)

    x, t = dataset_from_dir(data_dir, scale=scale)
    if len(x) < batch:
        raise ValueError(f"{len(x)} patches under {data_dir}, fewer than "
                         f"one batch of {batch}")
    if verbose:
        print(f"dataset: {len(x)} patches from {data_dir}; training on "
              f"{device_name(device)}")
    losses = []
    it = iterate_minibatches(x, t, batch, seed=seed)
    for i in range(steps):
        xb, tb = next(it)
        losses.append(step(xb, tb))
        if verbose and (i % log_every == 0 or i == steps - 1):
            print(f"step {i:5d}  mse {losses[-1]:.3f}")
    return model.weights(), losses


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog=_PROG, description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data", required=True)
    ap.add_argument("--scale", type=float, default=2.0)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="srcnn_trained.npz")
    ap.add_argument("--from-scratch", action="store_true")
    ap.add_argument("--sharded", action="store_true",
                    help="mesh-parallel step: patches' rows over every "
                         "visible card, halo exchange")
    ap.add_argument("--device", default="cuda", choices=DEVICES,
                    help="where the training runs (default cuda)")
    args = ap.parse_args(argv)
    if cuda_missing(args.device, _PROG):
        return 1
    try:
        weights, losses = fit(args.data, scale=args.scale, steps=args.steps,
                              batch=args.batch, lr=args.lr,
                              from_pretrained=not args.from_scratch,
                              sharded=args.sharded, seed=args.seed,
                              device=args.device)
    except ValueError as e:
        print(f"{_PROG}: {e}", file=sys.stderr)
        return 1
    save_npz(args.out, weights)
    print(f"final mse {losses[-1]:.3f} -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
