"""SRCNN training (the port of ``srcnn_cpp_tpu/train``).

* :mod:`.step` — :func:`mse_loss`, :func:`make_train_step` (PyTorch
  autograd, any ``torch.optim`` optimizer) and the mesh-parallel
  :func:`make_sharded_train_step` with :func:`shard_batch`;
* :mod:`.data` — the patch pipeline (:func:`dataset_from_dir`,
  :func:`patches_from_image`, :func:`iterate_minibatches`);
* :mod:`.trainer` — :func:`fit` and the CLI
  (``python -m srcnn_cpp_tpu_torch.train``).
"""

from .step import make_sharded_train_step, make_train_step, mse_loss, \
    shard_batch


def __getattr__(name):
    # heavier pieces load lazily (data pulls the resize stack and imageio)
    if name in ("dataset_from_dir", "patches_from_image",
                "iterate_minibatches"):
        from . import data

        return getattr(data, name)
    if name == "fit":
        from .trainer import fit

        return fit
    raise AttributeError(name)


__all__ = ["make_train_step", "make_sharded_train_step", "mse_loss",
           "shard_batch", "fit", "dataset_from_dir", "patches_from_image",
           "iterate_minibatches"]
