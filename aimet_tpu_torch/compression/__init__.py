"""Model compression — counterpart of ``aimet_tpu/compression``: spatial /
weight / successive SVD, channel pruning with reconstruction, winnow, the
greedy ratio selection, and ``ModelCompressor``."""
from .channel_pruning import select_channels_to_keep
from .compressor import CompressedModel, CompressionStats, ModelCompressor
from .cost import Cost, layer_cost, model_cost, rank_for_comp_ratio
from .greedy import (GreedyCompRatioSelect, GreedySelectionParameters,
                     monotonic_fit)
from .svd import (spatial_svd_factor, weight_svd_factor_conv,
                  weight_svd_factor_linear)
from .winnow import propagate_channel_mask, winnow_model

__all__ = [
    "CompressedModel", "CompressionStats", "Cost", "GreedyCompRatioSelect",
    "GreedySelectionParameters", "ModelCompressor", "layer_cost",
    "model_cost", "monotonic_fit", "propagate_channel_mask",
    "rank_for_comp_ratio", "select_channels_to_keep", "spatial_svd_factor",
    "weight_svd_factor_conv", "weight_svd_factor_linear", "winnow_model",
]
