"""SRCNN weights as torch tensors: loading (:mod:`.loader`) and
checkpoints (:mod:`.checkpoint`)."""

from .loader import (CANONICAL, SRCNNWeights, from_jax_params, load_weights,
                     weights_npz, weights_on)

__all__ = ["CANONICAL", "SRCNNWeights", "from_jax_params", "load_weights",
           "weights_npz", "weights_on"]
