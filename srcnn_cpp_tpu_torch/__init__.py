"""srcnn_cpp_tpu_torch — the SRCNN super-resolution pipeline on PyTorch + CUDA.

The port of ``srcnn_cpp_tpu`` (JAX/Pallas, TPU) to PyTorch with
hand-written CUDA kernels for NVIDIA Hopper (``sm_90a``).  The JAX package
is the reference the port is tested against; this package imports neither
it nor JAX.

Public surface:

* :func:`upscale_bgr` / :func:`upscale_bgr_batch` — the full image
  pipeline (the ``srcnn`` binary equivalent);
* :func:`process_srcnn` — the raw-buffer API (``ProcessSRCNN``,
  reference src/test.cpp:345);
* :func:`load_weights` — the pretrained SRCNN 9-5-5 checkpoint as tensors
  (:class:`SRCNNWeights`);
* :class:`SRCNN` — the model family as a ``torch.nn.Module`` (:mod:`.models`);
* :func:`evaluate_image` — the Resize.m evaluation protocol
  (:mod:`.evaluate`, ``python -m srcnn_cpp_tpu_torch.evaluate``);
* :class:`StreamUpscaler` — the pipelined video upscaler (:mod:`.stream`,
  ``python -m srcnn_cpp_tpu_torch.stream``);
* :mod:`.configs` — the production configurations, on one card or over a
  device mesh (:mod:`.parallel`: tiling with halo exchange, the
  multi-process stream);
* :mod:`.cli` — the command line (``python -m srcnn_cpp_tpu_torch``).
"""

__version__ = "0.1.0"


def __getattr__(name):
    # lazy re-exports: importing the package loads neither torch nor numpy
    if name in ("upscale_bgr", "upscale_bgr_batch", "process_srcnn"):
        from . import pipeline

        return getattr(pipeline, name)
    if name in ("load_weights", "SRCNNWeights"):
        from . import weights

        return getattr(weights, name)
    if name == "SRCNN":
        from .models import SRCNN

        return SRCNN
    if name == "evaluate_image":
        from .evaluate import evaluate_image

        return evaluate_image
    if name == "StreamUpscaler":
        from .stream import StreamUpscaler

        return StreamUpscaler
    raise AttributeError(name)
