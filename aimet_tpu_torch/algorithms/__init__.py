"""Post-training quantization algorithms — counterpart of
``aimet_tpu/algorithms/`` (the PTQ path: BN fold, CLE with high-bias fold,
bias correction, AdaRound and SeqMSE). Each works on a
``ConnectedGraph`` / ``QuantizationSimModel`` and a params dict, and
returns new params without writing into the caller's tensors."""
from .adaround import AdaroundParameters, apply_adaround
from .bias_correction import correct_bias, correct_bias_analytical
from .bn_fold import (bn_affine_params, find_foldable_pairs,
                      fold_all_batch_norms)
from .cle import equalize_model, find_cls_sets, high_bias_fold, scale_cls_sets
from .seq_mse import apply_seq_mse

__all__ = [
    "AdaroundParameters", "apply_adaround", "apply_seq_mse",
    "bn_affine_params", "correct_bias", "correct_bias_analytical",
    "equalize_model", "find_cls_sets", "find_foldable_pairs",
    "fold_all_batch_norms", "high_bias_fold", "scale_cls_sets",
]
