from .batcher import ContinuousBatcher, Request
from .quantized_llm import (QuantizedLLM, quantize_transformer_weights,
                            quantized_forward)
