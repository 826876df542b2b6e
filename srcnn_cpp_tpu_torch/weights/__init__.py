"""Network weights as torch tensors: SRCNN's loading (:mod:`.loader`) and
checkpoints (:mod:`.checkpoint`), VDSR's container and loader
(:mod:`.vdsr`)."""

from .loader import (CANONICAL, SRCNNWeights, from_jax_params, load_weights,
                     weights_npz, weights_on)
from .vdsr import VDSRWeights, load_vdsr_weights, refuse_vdsr

__all__ = ["CANONICAL", "SRCNNWeights", "VDSRWeights", "from_jax_params",
           "load_vdsr_weights", "load_weights", "refuse_vdsr", "weights_npz",
           "weights_on"]
