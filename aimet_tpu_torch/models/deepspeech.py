"""DeepSpeech2-style speech model: conv frontend + stacked bi-LSTM + CTC
head — counterpart of ``aimet_tpu/models/deepspeech.py``.

The model family of the reference's recurrent-QAT baseline (README.md:
176-196: DeepSpeech2 bi-LSTM INT8 QAT). Its recurrent core uses the
recurrent quantsim's cells (``quantsim/recurrent.lstm_step``) inside
``graph/control_flow.scan``, so the one ``QuantizationSimModel`` sees two
``scan`` ops a layer (the backward direction is ``scan(reverse=True)``,
not flips in the model) with the per-timestep quantizers inside, and
``RecurrentQuantizer`` applies to each direction directly.

Layout: spectrograms (B, T, F) -> two conv + relu stages over (T, F),
NCHW with OIHW kernels; flax's "SAME" padding is kept, which at stride 2
pads the two sides unequally (``layers.Conv``) -> (B, T', F' * C) with the
features in the JAX package's (F', C) order -> the bi-LSTM stack ->
per-frame log-probs (B, T', vocab) for CTC.

Parameter names map to the JAX package's tree: ``conv1.kernel`` is
``['conv1']['kernel']``, ``lstm.0.fwd.recurrent_kernel`` is
``['lstm'][0]['fwd']['recurrent_kernel']`` (``convert.jax_param_key(name,
root=None)``; ``convert.deepspeech_params_from_jax`` carries a JAX tree
across).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from .._device import no_tf32, resolve_device
from ..graph import control_flow
from ..quantsim.recurrent import lstm_step
from .layers import Conv


class LSTMCell(nn.Module):
    """One direction's parameters in the recurrent quantsim's layout."""

    def __init__(self, input_dim: int, hidden: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(input_dim, 4 * hidden))
        self.recurrent_kernel = nn.Parameter(torch.zeros(hidden, 4 * hidden))
        self.bias = nn.Parameter(torch.zeros(4 * hidden))

    def params(self) -> Dict[str, torch.Tensor]:
        return {"kernel": self.kernel,
                "recurrent_kernel": self.recurrent_kernel, "bias": self.bias}


class BiLSTMLayer(nn.Module):
    def __init__(self, input_dim: int, hidden: int):
        super().__init__()
        self.fwd = LSTMCell(input_dim, hidden)
        self.bwd = LSTMCell(input_dim, hidden)


class Head(nn.Module):
    def __init__(self, in_features: int, vocab: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(in_features, vocab))
        self.bias = nn.Parameter(torch.zeros(vocab))


def _freq_out(n_mels: int) -> int:
    """Two SAME-padded stride-2 convs over the frequency axis."""
    return -(-(-(-n_mels // 2)) // 2)


def lstm_scan(cell: Dict[str, torch.Tensor], x_seq: torch.Tensor,
              reverse: bool = False) -> torch.Tensor:
    """(B, T, I) -> (B, T, H): one direction through ``control_flow.scan``."""
    B = x_seq.shape[0]
    H = cell["recurrent_kernel"].shape[0]

    def step(carry, x_t):
        h, c = carry
        h, c = lstm_step(cell, x_t, h, c)
        return (h, c), h

    zeros = torch.zeros(B, H, dtype=x_seq.dtype, device=x_seq.device)
    _, hs = control_flow.scan(step, (zeros, zeros), x_seq.transpose(0, 1),
                              reverse=reverse)
    return hs.transpose(0, 1)


class DeepSpeech2(nn.Module):
    """(B, T, n_mels) spectrograms -> (B, T', vocab) log-probs."""

    def __init__(self, n_mels: int = 80, conv_channels: int = 32,
                 hidden: int = 128, num_layers: int = 3, vocab: int = 29):
        super().__init__()
        self.conv1 = Conv(1, conv_channels, (11, 11), (2, 2), use_bias=True)
        self.conv2 = Conv(conv_channels, conv_channels, (11, 11), (1, 2),
                          use_bias=True)
        in_dim = conv_channels * _freq_out(n_mels)
        self.lstm = nn.ModuleList()
        for _ in range(num_layers):
            self.lstm.append(BiLSTMLayer(in_dim, hidden))
            in_dim = 2 * hidden
        self.head = Head(2 * hidden, vocab)

    def frontend(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, F) -> (B, T/2, F/4 * C), features in (F', C) order."""
        h = torch.relu(self.conv1(x[:, None]))
        h = torch.relu(self.conv2(h))
        B, C, T, Fq = h.shape
        return h.permute(0, 2, 3, 1).reshape(B, T, Fq * C)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.frontend(x)
        for layer in self.lstm:
            fwd = lstm_scan(layer.fwd.params(), h)
            bwd = lstm_scan(layer.bwd.params(), h, reverse=True)
            h = torch.cat([fwd, bwd], dim=-1)
        logits = h @ self.head.kernel + self.head.bias
        return F.log_softmax(logits, dim=-1)


def init_deepspeech2(generator: torch.Generator, n_mels: int = 80,
                     conv_channels: int = 32, hidden: int = 128,
                     num_layers: int = 3, vocab: int = 29,
                     device=None) -> DeepSpeech2:
    """A DeepSpeech2 with the JAX package's initial distributions (conv and
    head kernels N(0, 0.05), LSTM kernels N(0, 0.1), zero biases), drawn
    from ``generator`` on the CPU and moved to ``device`` (default
    ``cuda``)."""
    model = DeepSpeech2(n_mels, conv_channels, hidden, num_layers, vocab)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                continue
            scale = 0.1 if name.startswith("lstm.") else 0.05
            p.copy_(torch.randn(p.shape, generator=generator) * scale)
    return model.to(resolve_device(device))


def deepspeech2_apply(model: DeepSpeech2, x: torch.Tensor,
                      params: Optional[Dict[str, torch.Tensor]] = None
                      ) -> torch.Tensor:
    """The model's forward; ``params`` (by name) in place of its own."""
    if params is None:
        return model(x)
    return torch.func.functional_call(model, params, (x,))


def quantsim_deepspeech2(model: DeepSpeech2, seq_batches: List[torch.Tensor],
                         **kw):
    """DeepSpeech2 through the one ``QuantizationSimModel``: the bi-LSTM
    time loops are ``scan`` ops whose per-timestep quantizers calibrate in
    ``sim.compute_encodings`` and appear in ``sim.export_encodings()``.
    Returns the calibrated sim (``sim.quantized_fn``, ``sim.qat_fn()``);
    ``kw`` goes to the sim (``device``, ``quant_scheme``, ...)."""
    from ..quantsim.qsim import QuantizationSimModel
    sim = QuantizationSimModel(model, (seq_batches[0],), **kw)
    sim.compute_encodings(None, iter(seq_batches))
    return sim


def quantize_deepspeech2(model: DeepSpeech2, seq_batches: List[torch.Tensor],
                         spec=None) -> Tuple:
    """INT8 recurrent quantsim over the whole model: each direction of each
    layer its own ``RecurrentQuantizer`` (per-timestep hidden / cell
    fake-quant), calibrated layer by layer on the float activations (the
    backward one on the time-reversed sequences); conv and head kernels
    per-tensor min-max, symmetric.

    Returns ``(quantized_apply, quantizers)``; ``quantized_apply(model,
    x)`` mirrors the model's forward."""
    from ..quantization.grads import quantize_dequantize
    from ..quantsim.recurrent import RecurrentQuantizer, RecurrentQuantSpec

    spec = spec or RecurrentQuantSpec()
    quantizers = []
    with torch.no_grad():
        layer_in = [model.frontend(b) for b in seq_batches]
        for layer in model.lstm:
            fwd, bwd = layer.fwd.params(), layer.bwd.params()
            rq_f = RecurrentQuantizer("lstm", spec)
            rq_b = RecurrentQuantizer("lstm", spec)
            rq_f.compute_encodings(fwd, layer_in)
            rq_b.compute_encodings(bwd, [b.flip(1) for b in layer_in])
            quantizers.append((rq_f, rq_b))
            layer_in = [torch.cat([lstm_scan(fwd, b),
                                   lstm_scan(bwd, b, reverse=True)], dim=-1)
                        for b in layer_in]

    def _qdq_weight(w):
        return quantize_dequantize(w, w.min(), w.max(), bitwidth=8,
                                   symmetric=True)

    def quantized_apply(model, x):
        c1, c2 = model.conv1, model.conv2
        h = torch.relu(_conv(c1, x[:, None], _qdq_weight(c1.kernel)))
        h = torch.relu(_conv(c2, h, _qdq_weight(c2.kernel)))
        B, C, T, Fq = h.shape
        h = h.permute(0, 2, 3, 1).reshape(B, T, Fq * C)
        for layer, (rq_f, rq_b) in zip(model.lstm, quantizers):
            f, _ = rq_f.quantized_forward(layer.fwd.params(), h)
            b, _ = rq_b.quantized_forward(layer.bwd.params(), h.flip(1))
            h = torch.cat([f, b.flip(1)], dim=-1)
        logits = h @ _qdq_weight(model.head.kernel) + model.head.bias
        return F.log_softmax(logits, dim=-1)

    return quantized_apply, quantizers


def _conv(conv: Conv, x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """``conv`` with another kernel (its padding rule, stride and bias)."""
    (h0, h1), (w0, w1) = conv.pads(*x.shape[2:])
    x = F.pad(x, (w0, w1, h0, h1))
    with no_tf32():
        return F.conv2d(x, kernel, conv.bias, conv.strides)
