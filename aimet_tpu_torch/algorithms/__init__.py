"""Quantization algorithms — counterpart of ``aimet_tpu/algorithms/``: the
PTQ path (BN fold, CLE with high-bias fold, bias correction, AdaRound,
SeqMSE), the LLM PTQ algorithms (GPTQ / GPTVQ, SmoothQuant), BN
re-estimation, QuantAnalyzer and QAT with knowledge distillation. Each
works on a ``ConnectedGraph`` / ``QuantizationSimModel`` and a params
dict, and returns new params without writing into the caller's
tensors."""
from .adaround import AdaroundParameters, apply_adaround
from .bias_correction import correct_bias, correct_bias_analytical
from .bn_fold import (bn_affine_params, find_foldable_pairs,
                      fold_all_batch_norms)
from .bn_reestimation import reestimate_bn_stats
from .cle import equalize_model, find_cls_sets, high_bias_fold, scale_cls_sets
from .gptq import GPTVQParameters, apply_gptq, apply_gptvq
from .kd import (KDConfig, KDTrainState, init_kd_state, kd_loss,
                 make_qat_kd_step, shift_labels)
from .quant_analyzer import QuantAnalyzer, QuantAnalyzerResult
from .seq_mse import apply_seq_mse
from .smooth_quant import (SmoothTarget, apply_smooth_quant,
                           compute_smoothing_scales, find_smooth_targets)

__all__ = [
    "AdaroundParameters", "GPTVQParameters", "KDConfig", "KDTrainState",
    "QuantAnalyzer", "QuantAnalyzerResult", "SmoothTarget",
    "apply_adaround", "apply_gptq", "apply_gptvq", "apply_seq_mse",
    "apply_smooth_quant", "bn_affine_params", "compute_smoothing_scales",
    "correct_bias", "correct_bias_analytical", "equalize_model",
    "find_cls_sets", "find_foldable_pairs", "find_smooth_targets",
    "fold_all_batch_norms", "high_bias_fold", "init_kd_state", "kd_loss",
    "make_qat_kd_step", "reestimate_bn_stats", "scale_cls_sets",
    "shift_labels",
]
