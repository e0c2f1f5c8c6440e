"""aimet_tpu_torch — the PyTorch/CUDA port of aimet_tpu for NVIDIA Hopper.

Layout and names follow ``aimet_tpu``: ``ops/`` holds the kernel wrappers
(hand-written CUDA C++ in ``csrc/``, built at first use by ``_build``),
each beside its plain PyTorch version; ``models/`` and ``serving/`` hold
the model and the serving path in the modes ``w8`` (the default), ``w4``
and ``w4a8``; ``quantization/``, ``graph/`` and ``quantsim/`` hold the
quantization simulation (``QuantizationSimModel``, with quantization-aware
training through ``qat_fn`` / ``static_grid_qat_fn`` and the differentiable
``quantize_dequantize``) and its lowering to the integer kernels
(``lower_to_int``), with loops and branches the sim sees inside
(``graph/control_flow``) and recurrent quantsim (``quantsim/recurrent``);
``algorithms/`` the PTQ and QAT algorithms; ``compression/`` SVD, channel
pruning, winnow and ``ModelCompressor``. Entry points run on ``cuda``
unless the caller passes ``device="cpu"``.
"""
from .models.transformer import (Transformer, TransformerConfig,
                                 init_kv_caches)
from .native import NativeScheduler
from .ops.kv_cache import flatten_kv_caches
from .quantization.grads import quantize_dequantize, round_ste
from .quantsim.config import QuantSimConfig
from .quantsim.lowering import LoweredModel, lower_to_int
from .quantsim.qsim import QuantizationSimModel
from .serving.batcher import ContinuousBatcher, Request
from .serving.quantized_llm import (QuantizedLLM, quantize_transformer_weights,
                                    quantized_forward,
                                    random_quantized_weights)

__all__ = [
    "ContinuousBatcher", "LoweredModel", "NativeScheduler", "QuantSimConfig",
    "QuantizationSimModel", "QuantizedLLM", "Request", "Transformer",
    "TransformerConfig", "flatten_kv_caches", "init_kv_caches",
    "lower_to_int", "quantize_dequantize", "quantize_transformer_weights",
    "quantized_forward", "random_quantized_weights", "round_ste",
]
