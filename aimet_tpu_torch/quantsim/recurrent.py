"""Recurrent quantsim: LSTM / GRU with per-timestep fake-quant —
counterpart of ``aimet_tpu/quantsim/recurrent.py``.

The reference (QcQuantizeRecurrent, aimet_torch/v1/qc_quantize_recurrent.py
:122-880) re-implements the RNN time loop so that its quantizers see every
step; so does this module, as a Python loop over the steps (the JAX
package's ``lax.scan``, whose carry threads the observer states; here the
observer states are updated in place of the carry, step by step).

Quantizer layout, as the reference's grouped quantizers (:191-306):
  - the input sequence: one quantizer, on every step's input;
  - the hidden state (h) and, for an LSTM, the cell state (c): shared
    across the steps, observed at every step while calibrating and applied
    at every step after;
  - the parameters (kernel / recurrent_kernel): min-max, quantized once a
    forward; the bias stays float (the default config);
  - the output sequence: the quantized hidden states.

Parameters are dicts of tensors in the JAX package's layout: ``kernel``
(I, 4H) or (I, 3H), ``recurrent_kernel`` (H, 4H) / (H, 3H), ``bias`` and,
for a GRU, an optional ``recurrent_bias``. Everything runs where the
parameters lie; the plain PyTorch ops it uses launch no kernel of the
port.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from ..quantization.affine import AffineEncoding
from ..quantization.encoding_analyzer import EncodingAnalyzer
from ..quantization.grads import quantize_dequantize


@dataclasses.dataclass(frozen=True)
class RecurrentQuantSpec:
    bitwidth_act: int = 8
    bitwidth_param: int = 8
    act_symmetric: bool = False
    param_symmetric: bool = True
    scheme: str = "minmax"


def lstm_step(params, x_t, h, c):
    """Flax-layout LSTM cell: ``params`` = {kernel (I, 4H),
    recurrent_kernel (H, 4H), bias (4H,)}; gate order (i, f, g, o)."""
    gates = x_t @ params["kernel"] + h @ params["recurrent_kernel"]
    if "bias" in params:
        gates = gates + params["bias"]
    i, f, g, o = torch.split(gates, h.shape[-1], dim=-1)
    i = torch.sigmoid(i)
    f = torch.sigmoid(f)
    g = torch.tanh(g)
    o = torch.sigmoid(o)
    c_new = f * c + i * g
    h_new = o * torch.tanh(c_new)
    return h_new, c_new


def gru_step(params, x_t, h):
    """GRU cell: ``params`` = {kernel (I, 3H), recurrent_kernel (H, 3H),
    bias, optional recurrent_bias (3H,)}; gate order (r, u, n). The
    recurrent bias stays separate (PyTorch's n = tanh(W_in x + b_in + r *
    (W_hn h + b_hn)): b_hn sits inside the reset-gated term)."""
    xz = x_t @ params["kernel"]
    hz = h @ params["recurrent_kernel"]
    if "bias" in params:
        xz = xz + params["bias"]
    if "recurrent_bias" in params:
        hz = hz + params["recurrent_bias"]
    H = h.shape[-1]
    xr, xu, xn = torch.split(xz, H, dim=-1)
    hr, hu, hn = torch.split(hz, H, dim=-1)
    r = torch.sigmoid(xr + hr)
    u = torch.sigmoid(xu + hu)
    n = torch.tanh(xn + r * hn)
    return (1 - u) * n + u * h


def _init(generator: torch.Generator, input_dim, hidden, gates, use_bias,
          scale, device):
    def normal(*shape):
        return (torch.randn(*shape, generator=generator) * scale).to(device)

    p = {"kernel": normal(input_dim, gates * hidden),
         "recurrent_kernel": normal(hidden, gates * hidden)}
    if use_bias:
        p["bias"] = torch.zeros(gates * hidden, device=device)
    return p


def init_lstm_params(generator: torch.Generator, input_dim: int, hidden: int,
                     use_bias: bool = True, scale: float = 0.1, device=None):
    """N(0, scale) kernels drawn from ``generator`` (on the CPU, then moved
    to ``device``), zero bias."""
    return _init(generator, input_dim, hidden, 4, use_bias, scale, device)


def init_gru_params(generator: torch.Generator, input_dim: int, hidden: int,
                    use_bias: bool = True, scale: float = 0.1, device=None):
    """N(0, scale) kernels drawn from ``generator``, zero bias."""
    return _init(generator, input_dim, hidden, 3, use_bias, scale, device)


class RecurrentQuantizer:
    """Quantsim for an LSTM / GRU layer.

    Usage::

      rq = RecurrentQuantizer('lstm', spec)
      rq.compute_encodings(params, seq_batches)     # x: (B, T, I)
      out, (h, c) = rq.quantized_forward(params, x)
    """

    ACT_QUANTIZERS = ("input", "hidden", "cell")

    def __init__(self, cell_type: str = "lstm",
                 spec: RecurrentQuantSpec = RecurrentQuantSpec()):
        if cell_type not in ("lstm", "gru"):
            raise ValueError(f"cell_type must be 'lstm' or 'gru': "
                             f"{cell_type!r}")
        self.cell_type = cell_type
        self.spec = spec
        self._analyzers = {
            n: EncodingAnalyzer(spec.scheme) for n in self.ACT_QUANTIZERS}
        self.encodings: Dict[str, AffineEncoding] = {}
        self.param_encodings: Dict[str, AffineEncoding] = {}

    # -- helpers -----------------------------------------------------------
    def _qdq_act(self, x, name, encodings):
        enc = encodings.get(name)
        if enc is None:
            return x
        return quantize_dequantize(
            x, enc.min, enc.max, bitwidth=self.spec.bitwidth_act,
            symmetric=self.spec.act_symmetric)

    def _compute_param_encodings(self, params):
        """One min-max encoding a weight (the bias stays float)."""
        self.param_encodings = {}
        for k, v in params.items():
            if k == "bias":
                continue
            analyzer = EncodingAnalyzer("minmax")
            st = analyzer.update(analyzer.init_state(device=v.device),
                                 v.detach())
            self.param_encodings[k] = analyzer.compute(
                st, bitwidth=self.spec.bitwidth_param,
                symmetric=self.spec.param_symmetric)

    def _quantize_params(self, params):
        """Fake-quant of the weights with the kept encodings."""
        if not self.param_encodings:
            self._compute_param_encodings(params)
        out = {}
        for k, v in params.items():
            enc = self.param_encodings.get(k)
            out[k] = v if enc is None else quantize_dequantize(
                v, enc.min, enc.max, bitwidth=self.spec.bitwidth_param,
                symmetric=self.spec.param_symmetric)
        return out

    def _step(self, params, x_t, h, c):
        if self.cell_type == "lstm":
            return lstm_step(params, x_t, h, c)
        return gru_step(params, x_t, h), c

    # -- calibration -------------------------------------------------------
    def compute_encodings(self, params, seq_batches):
        """Observe the input and, at every step, the hidden (and cell)
        state of the float recurrence on the quantized weights."""
        self._compute_param_encodings(params)
        qparams = self._quantize_params(params)
        dev = params["kernel"].device
        an = self._analyzers
        obs = {n: an[n].init_state(device=dev) for n in self.ACT_QUANTIZERS}
        H = params["recurrent_kernel"].shape[0]
        count = 0
        with torch.no_grad():
            for x_seq in seq_batches:
                obs["input"] = an["input"].update(obs["input"], x_seq)
                B, T = x_seq.shape[:2]
                h = torch.zeros(B, H, dtype=x_seq.dtype, device=dev)
                c = torch.zeros(B, H, dtype=x_seq.dtype, device=dev)
                for t in range(T):
                    h, c = self._step(qparams, x_seq[:, t], h, c)
                    if self.cell_type == "lstm":
                        obs["cell"] = an["cell"].update(obs["cell"], c)
                    obs["hidden"] = an["hidden"].update(obs["hidden"], h)
                count += 1
        if count == 0:
            raise RuntimeError("no calibration batches")
        for n in self.ACT_QUANTIZERS:
            if n == "cell" and self.cell_type == "gru":
                continue
            self.encodings[n] = an[n].compute(
                obs[n], bitwidth=self.spec.bitwidth_act,
                symmetric=self.spec.act_symmetric)
        return self.encodings

    # -- quantized forward -------------------------------------------------
    def quantized_forward(self, params, x_seq, seq_lengths=None):
        """x_seq (B, T, I) -> (outputs (B, T, H), (h, c)).

        ``seq_lengths`` (B,) ints: packed-sequence semantics
        (qc_quantize_recurrent.py:105): steps at or past a sequence's
        length keep its (h, c) and give zero outputs, so the final state is
        each sequence's state at its own end. Differentiable (the
        straight-through estimator through every step's fake-quant)."""
        if not self.encodings:
            raise RuntimeError("call compute_encodings first")
        enc = self.encodings
        qparams = self._quantize_params(params)
        B, T = x_seq.shape[:2]
        H = params["recurrent_kernel"].shape[0]
        x_q = self._qdq_act(x_seq, "input", enc)
        h = torch.zeros(B, H, dtype=x_seq.dtype, device=x_seq.device)
        c = torch.zeros(B, H, dtype=x_seq.dtype, device=x_seq.device)
        outs = []
        for t in range(T):
            h_prev, c_prev = h, c
            h, c = self._step(qparams, x_q[:, t], h, c)
            if self.cell_type == "lstm":
                c = self._qdq_act(c, "cell", enc)
            h = self._qdq_act(h, "hidden", enc)
            if seq_lengths is not None:
                valid = (t < seq_lengths)[:, None]
                h = torch.where(valid, h, h_prev)
                c = torch.where(valid, c, c_prev)
                outs.append(torch.where(valid, h, torch.zeros_like(h)))
            else:
                outs.append(h)
        return torch.stack(outs, dim=1), (h, c)

    def fp_forward(self, params, x_seq):
        """The float recurrence: (outputs (B, T, H), (h, c))."""
        B, T = x_seq.shape[:2]
        H = params["recurrent_kernel"].shape[0]
        h = torch.zeros(B, H, dtype=x_seq.dtype, device=x_seq.device)
        c = torch.zeros(B, H, dtype=x_seq.dtype, device=x_seq.device)
        outs = []
        for t in range(T):
            h, c = self._step(params, x_seq[:, t], h, c)
            outs.append(h)
        return torch.stack(outs, dim=1), (h, c)
