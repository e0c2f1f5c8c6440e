"""Quantization algorithms — counterpart of ``aimet_tpu/algorithms/``: the
PTQ path (BN fold, CLE with high-bias fold, bias correction, AdaRound,
SeqMSE), the LLM PTQ algorithms (GPTQ / GPTVQ, SmoothQuant), BN
re-estimation, QuantAnalyzer, QAT with knowledge distillation, AMP,
AutoQuant, PEFT / LoRA and the architecture checker. Each
works on a ``ConnectedGraph`` / ``QuantizationSimModel`` and a params
dict, and returns new params without writing into the caller's
tensors."""
from .adaround import AdaroundParameters, apply_adaround
from .amp import (Candidate, choose_mixed_precision, find_quantizer_groups,
                  fp16_candidate, reduce_convert_ops)
from .arch_checker import ArchChecker, ModelValidator
from .auto_quant import AutoQuant, AutoQuantWithAutoMixedPrecision
from .bias_correction import correct_bias, correct_bias_analytical
from .bn_fold import (bn_affine_params, find_foldable_pairs,
                      fold_all_batch_norms)
from .bn_reestimation import reestimate_bn_stats
from .cle import equalize_model, find_cls_sets, high_bias_fold, scale_cls_sets
from .gptq import GPTVQParameters, apply_gptq, apply_gptvq
from .kd import (KDConfig, KDTrainState, init_kd_state, kd_loss,
                 make_qat_kd_step, shift_labels)
from .peft import (LoraConfig, PeftQuantUtils, init_lora_params,
                   lora_apply_fn, lora_unmerged_fn)
from .quant_analyzer import QuantAnalyzer, QuantAnalyzerResult
from .seq_mse import apply_seq_mse
from .smooth_quant import (SmoothTarget, apply_smooth_quant,
                           compute_smoothing_scales, find_smooth_targets)

__all__ = [
    "AdaroundParameters", "ArchChecker", "AutoQuant",
    "AutoQuantWithAutoMixedPrecision", "Candidate", "GPTVQParameters",
    "KDConfig", "KDTrainState", "LoraConfig", "ModelValidator",
    "PeftQuantUtils", "QuantAnalyzer", "QuantAnalyzerResult",
    "SmoothTarget", "apply_adaround", "apply_gptq", "apply_gptvq",
    "apply_seq_mse", "apply_smooth_quant", "bn_affine_params",
    "choose_mixed_precision", "compute_smoothing_scales", "correct_bias",
    "correct_bias_analytical", "equalize_model", "find_cls_sets",
    "find_foldable_pairs", "find_quantizer_groups", "find_smooth_targets",
    "fold_all_batch_norms", "fp16_candidate", "high_bias_fold",
    "init_kd_state", "init_lora_params", "kd_loss", "lora_apply_fn",
    "lora_unmerged_fn", "make_qat_kd_step", "reduce_convert_ops",
    "reestimate_bn_stats", "scale_cls_sets", "shift_labels",
]
