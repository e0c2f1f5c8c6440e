"""Lower a calibrated quantsim to true INT8 / INT4 execution — counterpart
of ``aimet_tpu/quantsim/lowering.py``:

    sim.compute_encodings(params, data)
    lowered = lower_to_int(sim, params, mode="w8")   # or w4, w8a8, w4a8, auto
    y = lowered(params, x)                           # integer kernels

Every ``linear`` op whose kernel has a symmetric encoding is replaced by an
integer kernel with its weights quantized once through that frozen
encoding (not re-quantized), so the lowered model computes what the
quantsim simulated:

  - ``w8``: int8 codes, weight-only (kernel KW8, ``matmul_w8``);
  - ``w4``: packed INT4 codes, weight-only (KW4, ``matmul_w4``); the sim's
    parameter bitwidth must be 4;
  - ``w8a8``: int8 codes x activations quantized with their frozen
    per-tensor 8-bit calibration encoding (KSQ, ``matmul_w8a8_staticq``),
    zero-point corrected; an op without such an encoding is downgraded to
    weight-only and listed in ``downgraded_ops``;
  - ``w4a8``: packed INT4 codes x per-row dynamic INT8 activations (K1 +
    K2, ``matmul_w4a8``);
  - ``auto``: per op from its parameter spec, bitwidth <= 4 -> ``w4a8``,
    else ``w8a8``;
  - blockwise / LPBQ 4-bit kernels, whatever the mode: group-wise INT4
    (KW4G, ``matmul_w4_grouped``).

A layer whose parameter quantizer is ``float`` (AMP's fp16 candidate)
keeps its float weights and stays on the float path, in every mode
(``skipped_ops``), as in the JAX package.

Every ``conv`` / ``depthwise_conv`` / ``conv_transpose`` op lowers to the
direct integer conv of ``ops/int_conv`` (no im2col of the activations in
the weight-only modes), with the JAX package's mode table:

  - ``w8a8`` with a static input encoding: ``conv2d_int8_static`` (a
    zero-point-filled int8 im2col and KQ8's int32 entry; grouped convs an
    exact f64 conv), zero-point corrected;
  - ``w8a8`` without one, and ``w4a8``: ``conv2d_w8a8_dynamic`` (per-tensor
    dynamic INT8 activations); a ``w8a8`` conv is then listed in
    ``downgraded_ops``;
  - ``w4``: INT4 codes packed along the output channels
    (``pack_int4_conv_co``), or held as int8 when co is odd, dequantized
    into a float conv (``conv2d_weight_only``); ``w8``: int8 codes, the
    same way.

A transposed conv becomes the equivalent lhs-dilated conv (flipped,
transposed kernel); a conv whose equivalent padding would be negative,
or whose weight is not 4-D, stays on the float path (``skipped_ops``).
So do ops inside a control-flow body (``Op.scope``; an LSTM's body runs
in float, as traced) and layers whose kernel is a constant of
the model rather than a parameter (a compressed model's factored or
pruned layers), as in the JAX package.

On CUDA parameters the replacements always launch the kernels; on CPU
parameters the kernels' plain versions run. Activations between the ops
stay float.

The traced graph has the example inputs' shapes. Called with inputs of
other shapes, a ``LoweredModel`` traces the model once more for them and
applies the same replacements by op name (the op sequence of a model does
not depend on its batch or sequence length; the kernel parameter of each
replaced op is checked).
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Callable, Dict, List, Optional

import torch
from torch.utils import _pytree as pytree

from ..graph.connected_graph import ConnectedGraph, Op
from ..graph.interpreter import evaluate_with_replacements
from ..ops.int_conv import (conv2d_int8_static, conv2d_w8a8_dynamic,
                            conv2d_weight_only, pack_int4_conv_co)
from ..ops.int_matmul import (matmul_w4, matmul_w4_grouped, matmul_w4a8,
                              matmul_w8, matmul_w8a8_staticq,
                              pack_int4_split_half)
from ..quantization.affine import AffineEncoding, quantize_to_int
from ..quantization.blockwise import _to_blocks

DECODE_M = 32           # rows at or below which decode_weight_only applies
_CONV_TYPES = ("conv", "depthwise_conv", "conv_transpose")


@dataclasses.dataclass
class LoweredModel:
    graph: ConnectedGraph
    replacements: Dict[str, Callable]
    lowered_ops: List[str]
    skipped_ops: List[str]
    # ops asked for at w8a8 that fell back to weight-only (no per-tensor
    # 8-bit input-activation encoding)
    downgraded_ops: List[str] = dataclasses.field(default_factory=list)
    flops_lowered: int = 0
    flops_total: int = 0
    op_modes: Dict[str, str] = dataclasses.field(default_factory=dict)
    model: Optional[torch.nn.Module] = None
    _graphs: Dict[tuple, ConnectedGraph] = dataclasses.field(
        default_factory=dict, repr=False)

    @property
    def int_flops_fraction(self) -> float:
        """Fraction of conv/linear FLOPs executing on integer kernels."""
        return self.flops_lowered / self.flops_total if self.flops_total \
            else 0.0

    def _graph_for(self, params, args) -> ConnectedGraph:
        key = tuple((tuple(t.shape), t.dtype) if isinstance(t, torch.Tensor)
                    else t for t in pytree.tree_flatten(tuple(args))[0])
        if not self._graphs:
            self._graphs[tuple(
                (tuple(n.meta["val"].shape), n.meta["val"].dtype)
                for n in self.graph.input_nodes)] = self.graph
        if key not in self._graphs:
            if self.model is None:
                raise ValueError("inputs differ from the traced shapes and "
                                 "no model to trace them with")
            graph = ConnectedGraph(self.model, args, params=params)
            for name in self.replacements:
                op, ref = graph.get_op(name), self.graph.get_op(name)
                if op.param_products.get("kernel") is None or \
                        op.param_products["kernel"].param_path != \
                        ref.param_products["kernel"].param_path:
                    raise RuntimeError(f"retraced graph differs at {name}")
            self._graphs[key] = graph
        return self._graphs[key]

    def __call__(self, params, *args):
        with torch.no_grad():
            return evaluate_with_replacements(
                self._graph_for(params, args), params, args,
                self.replacements)


def _weight_int_and_scale(w, enc: AffineEncoding, channel_axis, bits: int,
                          n_out: int):
    """Frozen-encoding symmetric quantization -> (int codes, scale (n_out,))."""
    q = quantize_to_int(w, enc, channel_axis=channel_axis, signed=True,
                        dtype=torch.int32)
    lim = 2 ** (bits - 1) - 1
    q = torch.clamp(q, -lim, lim)          # drop the single -2^(b-1) code
    scale = enc.delta.to(torch.float32).reshape(-1)
    if scale.shape[0] == 1:                # per tensor -> per channel
        scale = scale.expand(n_out).contiguous()
    return q, scale


def _input_act_encoding(sim, op: Op):
    """(encoding, spec) of the op's data-input activation quantizer, or
    (None, None): keyed by the producing op's name, or ``model_input_<i>``
    for a graph input."""
    prod = op.inputs[0]
    if prod.producer is not None:
        key = prod.producer.name
    elif prod.node in sim.graph.input_nodes:
        key = f"model_input_{sim.graph.input_nodes.index(prod.node)}"
    else:
        return None, None
    return sim.encodings.get(key), sim.quantizers.get(key)


def _make_static_q8_mm(enc_in: AffineEncoding, wq_i8, w_scale):
    """Static INT8 matmul: x quantized with the frozen input encoding (on
    the [0, steps] grid, shifted to signed int8), int8 GEMM, then scale and
    zero-point correction:

        x = (q + off) * dx = (x_i8 + 128 + off) * dx
        y = dx * sw * (x_i8 @ wq) + dx * sw * (128 + off) * colsum(wq)

    The column constants are f32, in the JAX package's order, so ``cvec``
    has the same bits in both packages."""
    dx = enc_in.delta.to(torch.float32).reshape(())
    off = enc_in.offset.to(torch.float32).reshape(())
    dx_f, off_f = float(dx), float(off)
    steps = float(enc_in.num_steps)
    colsum = wq_i8.to(torch.float32).sum(dim=0)                      # (N,)
    cvec = (torch.tensor(128.0, device=dx.device) + off) * colsum * dx \
        * w_scale
    scale_vec = dx * w_scale

    def mm(x2d):
        return matmul_w8a8_staticq(x2d, wq_i8, scale_vec, cvec,
                                   inv_delta=1.0 / dx_f, offset=off_f,
                                   num_steps=steps, out_dtype=x2d.dtype)

    return mm


def _linear_shape_ok(op: Op, w) -> bool:
    """A (K, N) kernel used as it is (a transposed one's scales would be
    per input channel)."""
    return w.dim() == 2 and not op.attrs["kernel_transposed"]


def _replacement(mm, n_out: int, bias):
    def replacement(x):
        lead = x.shape[:-1]
        out = mm(x.reshape(-1, x.shape[-1])).reshape(*lead, n_out)
        out = out.to(x.dtype)
        if bias is not None:
            out = out + bias
        return out
    return replacement


def _lower_linear_grouped_int4(op: Op, w, bias, enc, spec):
    """Blockwise / LPBQ 4-bit linear -> the group-wise INT4 kernel (one
    scale per (K-group, channel))."""
    if not _linear_shape_ok(op, w):
        return None
    bs = spec.block_size
    K, N = w.shape
    if spec.block_axis != 0 or spec.bitwidth > 4 or not spec.symmetric \
            or K % (2 * bs) != 0:
        return None
    q = quantize_to_int(_to_blocks(w, bs, 0), enc, signed=True,
                        dtype=torch.int32)
    q = torch.clamp(q, -7, 7).reshape(K, N)
    packed = pack_int4_split_half(q)
    scales = enc.delta.to(torch.float32).reshape(K // bs, N)

    def mm(x2d):
        return matmul_w4_grouped(x2d, packed, scales, group_size=bs,
                                 out_dtype=torch.float32)

    return _replacement(mm, N, bias)


def _lower_linear(op: Op, w, bias, enc, ch_axis, mode, act_enc=None,
                  decode_weight_only=False):
    if not _linear_shape_ok(op, w) or ch_axis not in (1, None):
        return None               # per-in-channel scales don't fold
    bits = 4 if mode in ("w4", "w4a8") else 8
    if enc.bitwidth > bits:
        return None   # e.g. 8-bit encodings can't pack into int4 nibbles
    N = w.shape[1]
    q, scale = _weight_int_and_scale(w, enc, ch_axis, bits, N)
    # A faithful lowering keeps the mode's activation treatment at every M
    # (dropping activation quantization at small M would make the numerics
    # batch-size dependent), so both a8 modes take the weight-only decode
    # path only with decode_weight_only=True.
    if mode in ("w4", "w4a8"):
        if q.shape[0] % 2:
            return None
        wq = pack_int4_split_half(q)
        w4_decode_ok = decode_weight_only or mode == "w4"

        def mm(x2d):
            if mode == "w4a8" and not (w4_decode_ok
                                       and x2d.shape[0] <= DECODE_M):
                return matmul_w4a8(x2d, wq, scale, out_dtype=torch.float32)
            return matmul_w4(x2d, wq, scale, out_dtype=torch.float32)
    elif mode == "w8a8" and act_enc is not None:
        wq8 = q.to(torch.int8)
        static_mm = _make_static_q8_mm(act_enc, wq8, scale)

        def mm(x2d):
            if decode_weight_only and x2d.shape[0] <= DECODE_M \
                    and wq8.shape[0] >= 1024 and wq8.shape[1] >= 1024:
                return matmul_w8(x2d, wq8, scale, out_dtype=torch.float32)
            return static_mm(x2d)
    else:
        wq8 = q.to(torch.int8)

        def mm(x2d):
            return matmul_w8(x2d, wq8, scale, out_dtype=torch.float32)
    return _replacement(mm, N, bias)


def _conv_geometry(op: Op, q):
    """(codes as a plain conv's (co, ci/g, kh, kw) weight, int_conv keyword
    arguments) of a traced ``aten.convolution``, or None where the
    integer conv cannot take it. A transposed conv (weight (ci, co/g, kh,
    kw)) is the conv of the lhs-dilated input with the flipped kernel,
    transposed per group, padded by dilation * (k - 1) - padding (plus the
    output padding on the high side)."""
    args = op.nodes[0].args
    stride, padding, dilation = (tuple(int(v) for v in a)
                                 for a in args[3:6])
    transposed, out_pad, groups = args[6], args[7], args[8]
    kh, kw = q.shape[2:]
    if not transposed:
        pads = tuple((p, p) for p in padding)
        kw_args = dict(strides=stride, lhs_dilation=None)
    else:
        ci, cog = q.shape[:2]
        q = q.flip(2, 3).reshape(groups, ci // groups, cog, kh, kw) \
            .transpose(1, 2).reshape(groups * cog, ci // groups, kh, kw)
        pads = tuple((d * (k - 1) - p, d * (k - 1) - p + int(o))
                     for d, k, p, o in zip(dilation, (kh, kw), padding,
                                           out_pad))
        kw_args = dict(strides=(1, 1), lhs_dilation=stride)
    if any(v < 0 for pair in pads for v in pair):
        return None
    return q.contiguous(), dict(kw_args, padding=pads,
                                feature_group_count=groups,
                                rhs_dilation=dilation)


def _lower_conv(op: Op, w, bias, enc, ch_axis, mode, act_enc=None):
    """A conv / depthwise_conv / conv_transpose -> the direct integer conv
    (``ops/int_conv``): the mode table of the module docstring."""
    if w.dim() != 4:
        return None
    transposed = op.attrs["transposed"]
    co_axis = 1 if transposed else 0
    if ch_axis not in (co_axis, None):
        return None               # per-in-channel scales don't fold
    bits = 4 if mode in ("w4", "w4a8") else 8
    if enc.bitwidth > bits:
        return None
    groups = op.nodes[0].args[8]
    co = w.shape[1] * groups if transposed else w.shape[0]
    q, scale = _weight_int_and_scale(w, enc, ch_axis, bits, co)
    if scale.shape[0] != co:
        # a grouped transposed conv's axis-1 channels are the output
        # channels within a group: each group repeats their scales
        scale = scale.repeat(groups)
    geo = _conv_geometry(op, q)
    if geo is None:
        return None
    q, conv_kw = geo
    f32 = torch.float32
    if mode == "w8a8" and act_enc is not None:
        wq = q.to(torch.int8)
        dx = act_enc.delta.to(f32).reshape(())
        off = act_enc.offset.to(f32).reshape(())
        steps = float(act_enc.num_steps)

        def conv(x):
            return conv2d_int8_static(x, wq, scale, dx, off, steps,
                                      out_dtype=f32, **conv_kw)
    elif mode in ("w8a8", "w4a8"):
        # no static input encoding: dynamic per-tensor activations
        wq = q.to(torch.int8)

        def conv(x):
            return conv2d_w8a8_dynamic(x, wq, scale, out_dtype=f32,
                                       **conv_kw)
    else:
        # w4 packs INT4 codes along co when co is even; odd co (and w8)
        # keep int8 codes
        packed = mode == "w4" and co % 2 == 0
        wq = pack_int4_conv_co(q) if packed else q.to(torch.int8)
        wbits = 4 if packed else 8

        def conv(x):
            return conv2d_weight_only(x, wq, scale, bits=wbits,
                                      out_dtype=f32, **conv_kw)

    def replacement(x):
        out = conv(x).to(x.dtype)
        if bias is not None:
            out = out + bias[:, None, None]
        return out

    return replacement


def op_flops(op: Op) -> int:
    """MAC-based FLOPs (2 * MACs) of a conv / linear op from traced shapes."""
    node = op.nodes[0]
    out = node.meta["val"]
    if op.type in _CONV_TYPES:
        w = node.args[1].meta["val"]
        # kernel positions x input channels a group (any spatial rank)
        cig = w.shape[0] // node.args[8] if op.attrs["transposed"] \
            else w.shape[1]
        k = math.prod(w.shape[2:]) * cig
        return 2 * out.numel() * k
    if op.type == "linear":
        return 2 * out.numel() * op.attrs["x_node"].meta["val"].shape[-1]
    return 0


def lower_to_int(sim, params=None, mode: str = "w8",
                 decode_weight_only: bool = False) -> LoweredModel:
    """Build a true-INT executable from a calibrated QuantizationSimModel
    (``params`` None: the sim's model parameters). See the module
    docstring for the modes. With ``decode_weight_only=True`` the a8 modes
    route decode shapes (M <= 32) to the weight-only kernels."""
    if mode not in ("w8", "w4", "w8a8", "w4a8", "auto"):
        raise ValueError(f"unknown mode {mode!r}")
    if not sim.encodings:
        raise RuntimeError("call compute_encodings first")
    params = sim.params if params is None else params
    graph = sim.graph
    replacements: Dict[str, Callable] = {}
    lowered, skipped, downgraded = [], [], []
    op_modes: Dict[str, str] = {}
    flops_lowered = flops_total = 0
    for op in graph.ops:
        if op.type not in ("linear",) + _CONV_TYPES:
            continue
        if op.scope is not None:
            # inside a scan / while / cond body: the replacements act on
            # the top-level graph only; the body runs in float as traced
            skipped.append(op.name)
            continue
        flops_total += op_flops(op)
        kp = op.param_products.get("kernel")
        if kp is None or kp.param_path not in sim.encodings:
            skipped.append(op.name)
            continue
        spec = sim.quantizers[kp.param_path]
        enc = sim.encodings[kp.param_path]
        if spec.data_type == "float":
            # a float-assigned layer (AMP's fp16 candidate) keeps its
            # float weights: it stays on the float path
            skipped.append(op.name)
            continue
        if not spec.symmetric:
            skipped.append(op.name)
            continue
        w = params[kp.param_path]
        bp = op.param_products.get("bias")
        bias = params[bp.param_path] if bp is not None else None
        if spec.block_size is not None:
            fn = (_lower_linear_grouped_int4(op, w, bias, enc, spec)
                  if op.type == "linear" else None)
            if fn is None:
                skipped.append(op.name)
            else:
                replacements[op.name] = fn
                lowered.append(op.name)
                op_modes[op.name] = "w4_grouped"
                flops_lowered += op_flops(op)
            continue
        op_mode = mode
        if mode == "auto":
            op_mode = "w4a8" if spec.bitwidth <= 4 else "w8a8"
        act_enc = None
        if op_mode == "w8a8":
            a_enc, a_spec = _input_act_encoding(sim, op)
            if a_enc is not None and a_spec is not None \
                    and a_spec.bitwidth == 8 and a_enc.delta.dim() == 0:
                act_enc = a_enc
            else:
                downgraded.append(op.name)
                warnings.warn(
                    f"lower_to_int(mode='w8a8'): op {op.name!r} has no "
                    f"per-tensor 8-bit input-activation encoding — lowering "
                    f"with dynamic activation quantization (convs) or "
                    f"weight-only INT8 (matmuls); recorded in "
                    f"LoweredModel.downgraded_ops", stacklevel=2)
        if op.type == "linear":
            fn = _lower_linear(op, w, bias, enc, spec.channel_axis, op_mode,
                               act_enc=act_enc,
                               decode_weight_only=decode_weight_only)
        else:
            fn = _lower_conv(op, w, bias, enc, spec.channel_axis, op_mode,
                             act_enc=act_enc)
        if fn is None:
            skipped.append(op.name)
            if op.name in downgraded:
                downgraded.remove(op.name)
            continue
        replacements[op.name] = fn
        lowered.append(op.name)
        op_modes[op.name] = op_mode
        flops_lowered += op_flops(op)
    return LoweredModel(graph, replacements, lowered, skipped, downgraded,
                        flops_lowered, flops_total, op_modes, model=sim.model)
