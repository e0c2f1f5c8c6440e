"""Sequential MSE (SeqMSE), a per-layer search of the weight encodings —
counterpart of ``aimet_tpu/algorithms/seq_mse.py`` (reference:
aimet_torch/v1/seq_mse.py:102-623). For each layer in graph order the
``num_candidates`` shrunken ranges ``(i+1)/K * (w_min, w_max)`` are tried
and the per-output-channel argmin of the layer's reconstruction loss (MSE
or negative SQNR; first index on a tie) is frozen. The layer's inputs come
from the quantized-so-far model (``symqt``, default), the float model
(``symfp``), or both (``asym``: quantized inputs against float targets).

The JAX package evaluates all candidates at once (``jax.vmap``); at Llama
width that is one copy of the weight and of the outputs per candidate, so
the port evaluates them in chunks (``torch.func.vmap`` over a chunk) sized
to the memory free for them.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..graph.interpreter import OpReplay
from ..quantization.affine import compute_encoding_from_min_max, reduce_min_max
from ..quantization.grads import quantize_dequantize
from ..quantsim.qsim import QuantizationSimModel, _broadcast_encoding
from .adaround import _args, _layer_apply, adaround_layers
from .bn_fold import _conv_axes

CPU_CHUNK_BYTES = 1 << 30   # what a chunk of candidates may take on the CPU


def _chunk_size(w, outs, num_candidates) -> int:
    """Candidates a chunk: the bytes one candidate takes (its weight, its
    quantized copy, and its outputs and differences for every batch)
    into the budget (a quarter of the free device memory, or
    ``CPU_CHUNK_BYTES`` on the CPU)."""
    budget = (torch.cuda.mem_get_info(w.device)[0] // 4 if w.is_cuda
              else CPU_CHUNK_BYTES)
    per = 3 * w.numel() * w.element_size() + sum(
        3 * o.numel() * o.element_size() for o in outs)
    return max(1, min(num_candidates, budget // max(per, 1)))


def apply_seq_mse(sim: QuantizationSimModel, params, data_batches: Sequence,
                  num_candidates: int = 20, loss_fn: str = "mse",
                  inp_symmetry: str = "symqt"):
    """Freeze each layer's weight encoding chosen by sequential MSE;
    returns the names of the optimized layers (apply_seq_mse ->
    optimize_module, seq_mse.py:107,467). ``params`` None: the model's
    own."""
    if loss_fn not in ("mse", "neg_sqnr"):
        raise ValueError(f"loss_fn must be 'mse' or 'neg_sqnr': {loss_fn}")
    if inp_symmetry not in ("symqt", "symfp", "asym"):
        raise ValueError(f"unknown inp_symmetry {inp_symmetry!r}")
    params = sim.params if params is None else params
    data_batches = list(data_batches)
    sim.compute_param_encodings(params)

    optimized = []
    for op in adaround_layers(sim):
        kpath = op.param_products["kernel"].param_path
        spec = sim.quantizers[kpath]
        w = params[kpath]
        bias = None
        if "bias" in op.param_products:
            bias = params[op.param_products["bias"].param_path]
        ch_axis = spec.channel_axis
        w_min, w_max = reduce_min_max(w, channel_axis=ch_axis)

        in_name = op.inputs[0].name
        xq, xfp = [], []
        for batch in data_batches:
            if inp_symmetry in ("symqt", "asym"):
                xq.append(sim.collect_activations(
                    params, _args(batch), [in_name], mode="quantized")
                    [in_name])
            if inp_symmetry in ("symfp", "asym"):
                xfp.append(sim.collect_activations(
                    params, _args(batch), [in_name], mode="fp")[in_name])
        x_q, x_fp = {"symqt": (xq, xq), "symfp": (xfp, xfp),
                     "asym": (xq, xfp)}[inp_symmetry]

        replay = OpReplay(sim.graph, op)
        out_feat_ax = _conv_axes(op)[2]
        with torch.no_grad():
            # the float outputs do not depend on the candidate
            out_fps = [_layer_apply(replay, x, w, bias, params)
                       for x in x_fp]
        fracs = torch.arange(1, num_candidates + 1, dtype=torch.float32,
                             device=w.device) / num_candidates

        def candidate_loss(frac):
            enc = compute_encoding_from_min_max(
                w_min * frac, w_max * frac, spec.bitwidth, spec.symmetric,
                spec.strict_symmetric, spec.unsigned_symmetric)
            w_q = quantize_dequantize(
                w, _broadcast_encoding(enc.min, w.dim(), ch_axis),
                _broadcast_encoding(enc.max, w.dim(), ch_axis),
                bitwidth=spec.bitwidth, symmetric=spec.symmetric,
                strict_symmetric=spec.strict_symmetric,
                unsigned_symmetric=spec.unsigned_symmetric)
            total = 0.0
            for x, out_fp in zip(x_q, out_fps):
                out_q = _layer_apply(replay, x, w_q, bias, params)
                axes = tuple(d for d in range(out_q.dim()) if d != out_feat_ax)
                noise = ((out_q - out_fp) ** 2).mean(dim=axes)
                if loss_fn == "mse":
                    total = total + noise
                else:                       # neg_sqnr (seq_mse.py:602)
                    total = total - (out_fp ** 2).mean(dim=axes) / (
                        noise + 1e-10)
            return total                    # (C,) a candidate

        chunk = _chunk_size(w, out_fps, num_candidates)
        batched = torch.func.vmap(candidate_loss)
        with torch.no_grad():
            losses = torch.cat([batched(fracs[i:i + chunk])
                                for i in range(0, num_candidates, chunk)])
        if ch_axis is not None:
            best_f = fracs[torch.argmin(losses, dim=0)]       # (C,)
        else:
            # per tensor: one choice for the summed channel losses
            best_f = fracs[torch.argmin(losses.sum(dim=1))]
        sim.set_encoding(kpath, compute_encoding_from_min_max(
            w_min * best_f, w_max * best_f, spec.bitwidth, spec.symmetric,
            spec.strict_symmetric, spec.unsigned_symmetric), freeze=True)
        optimized.append(op.name)
    return optimized
