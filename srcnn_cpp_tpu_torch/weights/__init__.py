"""Pretrained SRCNN 9-5-5 weights as torch tensors (see :mod:`.loader`)."""

from .loader import SRCNNWeights, from_jax_params, load_weights, weights_npz

__all__ = ["SRCNNWeights", "from_jax_params", "load_weights", "weights_npz"]
