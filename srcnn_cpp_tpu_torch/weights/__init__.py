"""Network weights as torch tensors: SRCNN's loading (:mod:`.loader`) and
checkpoints (:mod:`.checkpoint`), VDSR's container and loader
(:mod:`.vdsr`), RCAN's (:mod:`.rcan`), SwinIR's (:mod:`.swinir`)."""

from .loader import (CANONICAL, SRCNNWeights, from_jax_params, load_weights,
                     srcnn_only, weights_npz, weights_on)
from .rcan import RCANWeights, load_rcan_weights
from .swinir import SwinIRWeights, load_swinir_weights
from .vdsr import VDSRWeights, load_vdsr_weights

__all__ = ["CANONICAL", "RCANWeights", "SRCNNWeights", "SwinIRWeights",
           "VDSRWeights", "from_jax_params", "load_rcan_weights",
           "load_swinir_weights", "load_vdsr_weights",
           "load_weights", "srcnn_only", "weights_npz", "weights_on"]
