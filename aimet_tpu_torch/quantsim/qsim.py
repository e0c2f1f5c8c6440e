"""QuantizationSimModel — counterpart of ``aimet_tpu/quantsim/qsim.py``:
placement, calibration in every scheme, the fake-quant forward, blockwise
parameters, the hooks the PTQ algorithms call, and encodings export and
load.

The model is traced once into a :class:`ConnectedGraph` (an aten graph
from ``make_fx``) and re-evaluated with quantizers at the configured
tensors, as the JAX package re-evaluates its jaxpr:

  - ``compute_encodings(params, data)`` runs the *observe* pass (parameters
    fake-quantized with their encodings, activation observers updated on
    the device) over the calibration batches, then computes the encodings
    on the host;
  - ``quantized_fn(params, *args)`` runs the *quantized* pass: parameters
    and activations through fake-quant;
  - ``fp_fn(params, *args)`` runs the graph without quantizers;
  - ``collect_activations(params, args, names, mode)`` runs either forward
    and returns the named products (AdaRound, SeqMSE and bias correction
    read a layer's input and output through it);
  - ``qat_fn()`` / ``static_grid_qat_fn()`` return the quantized forward
    for training: it runs with autograd on, the fake-quant gives the
    straight-through gradient to what it quantizes and, in ``qat_fn``,
    the range-learning gradients to the encodings' (min, max), which the
    caller passes as tensors; ``static_grid_qat_fn`` recomputes each
    parameter's grid from the live weights (min-max) and gives the grid
    no gradient.

Placement follows the JAX package's rule: every floating op output is
quantized unless the config says otherwise (never-quantized types,
supergroup interiors); parameters by role; float model inputs. The port
copies the rule as it is, including the quantizer on the masked attention
scores (``select_n``), whose [-1e30, 0] range flattens attention in both
packages.

Ops inside a ``scan`` / ``while`` / ``cond`` body (``graph/control_flow``)
get their quantizers as any op does, named under the enclosing op
(``scan_0/linear_1``); the interpreter runs such a body step by step, so
their observers see every step in calibration and their fake-quant acts
at every step of the quantized and QAT forwards (``_sub_act_names``: the
quantizers inside each body). The loop's parameters are quantized once,
outside it, as the JAX package quantizes scan consts.

Every public forward but the QAT ones runs under ``torch.no_grad()``.
Not ported yet (it raises ``NotImplementedError``): the StableHLO export
(``export_stablehlo``, which has no PyTorch counterpart yet).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Iterable, Optional, Sequence

import torch
from torch import fx

from .._device import DeviceLike, resolve_device
from ..graph.connected_graph import ConnectedGraph, Op
from ..graph.interpreter import flat_args, run_graph
from ..quantization import float_sim
from ..quantization.affine import (AffineEncoding,
                                   compute_encoding_from_min_max,
                                   gate_min_max, quantize_to_int,
                                   reduce_min_max)
from ..quantization.blockwise import (_to_blocks, blockwise_encoding,
                                      grouped_block_quantize_dequantize)
from ..quantization.encoding_analyzer import EncodingAnalyzer
from ..quantization.grads import quantize_dequantize
from .config import QuantSimConfig


@dataclasses.dataclass(frozen=True)
class QuantizerSpec:
    """Static configuration of one quantizer."""
    name: str
    kind: str                   # 'act' | 'param' | 'input'
    bitwidth: int = 8
    symmetric: bool = False
    strict_symmetric: bool = False
    unsigned_symmetric: bool = False
    scheme: str = "sqnr"
    percentile: float = 100.0
    channel_axis: Optional[int] = None
    enabled: bool = True
    # QuantizationDataType (aimet_common/defs.py:309): 'float' simulates an
    # FP16 round trip (bitwidth >= 16) or an FP8 fake cast whose maxval
    # comes from the calibrated range (bitwidth 8)
    data_type: str = "int"      # 'int' | 'float'
    # blockwise (v2 block_size quantizer / GroupedBlockQuantizeDequantize)
    block_size: Optional[int] = None
    block_axis: int = 0
    lpbq: bool = False
    lpbq_scale_bw: int = 4


def _broadcast_encoding(vals: torch.Tensor, x_ndim: int,
                        channel_axis: Optional[int]) -> torch.Tensor:
    """Shape per-channel (C,) encoding values for broadcasting against x."""
    if channel_axis is None or vals.dim() == 0:
        return vals
    shape = [1] * x_ndim
    shape[channel_axis] = -1
    return vals.reshape(shape)


def _is_float(dtype) -> bool:
    return dtype is not None and dtype.is_floating_point


class QuantizationSimModel:
    """Quantization simulation over a PyTorch module.

    Args:
      model: the float ``nn.Module``; it is moved to ``device``.
      example_inputs: a tuple of example inputs used for tracing.
      config: :class:`QuantSimConfig` (defaults mirror the reference's
        default_config.json).
      quant_scheme: activation calibration scheme (``minmax``, ``sqnr``,
        ``percentile``, ``mse`` or ``entropy``).
      param_quant_scheme: scheme for parameter encodings (``minmax``).
      percentile: the clip of the ``percentile`` scheme, in [50, 100].
      device: where the model, its encodings and the observers live;
        ``cuda`` by default (raises without CUDA), ``cpu`` on request.
    """

    def __init__(self, model: torch.nn.Module, example_inputs, *,
                 config: Optional[QuantSimConfig] = None,
                 quant_scheme: str = "sqnr",
                 param_quant_scheme: str = "minmax",
                 default_output_bw: int = 8, default_param_bw: int = 8,
                 percentile: float = 100.0, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        example_inputs = tuple(
            t.to(self.device) if isinstance(t, torch.Tensor) else t
            for t in example_inputs)
        self.graph = ConnectedGraph(self.model, example_inputs)
        self.config = config or QuantSimConfig.default()
        self.quant_scheme = quant_scheme
        self.param_quant_scheme = param_quant_scheme
        self.default_output_bw = default_output_bw
        self.default_param_bw = default_param_bw
        self.percentile = percentile
        self._qdq_flags = None

        self.quantizers: Dict[str, QuantizerSpec] = {}
        self._act_node_q: Dict[fx.Node, str] = {}
        self._param_node_q: Dict[fx.Node, str] = {}
        self._input_node_q: Dict[fx.Node, str] = {}
        self._node_input_q: Dict[fx.Node, list] = {}  # node -> [(arg, name)]
        self._output_node_q: Dict[fx.Node, str] = {}
        self._encodings: Dict[str, AffineEncoding] = {}
        self._parked_encodings: Dict[str, AffineEncoding] = {}
        self._frozen: set = set()
        self._build_quantizers()
        self._collect_sub_names()

    def product_quantizer(self, prod) -> Optional[str]:
        """The name of the activation or model-input quantizer on a graph
        ``Product`` (what the JAX sim keys by the product's var in
        ``_act_var_q`` / ``_input_var_q``), or None."""
        node = self.graph.resolve(prod.node)
        return self._act_node_q.get(node) or self._input_node_q.get(node)

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """The model's parameters by qualified name (detached)."""
        return {k: v.detach() for k, v in self.model.named_parameters()}

    # ------------------------------------------------------------------
    # Quantizer placement (QuantSimConfigurator equivalent)
    # ------------------------------------------------------------------
    def _supergroup_disabled_ops(self) -> set:
        """Ops whose output quantizer is disabled because they are interior
        to a supergroup (quantsim_config.py:74-110)."""
        disabled, claimed = set(), set()
        for pattern in self.config.supergroups:
            for op in self.graph.ops:
                if op.type != pattern[0] or op.name in claimed:
                    continue
                seq, cur, ok = [op], op, True
                for t in pattern[1:]:
                    cons = cur.output.consumers
                    if len(cons) != 1 or cons[0].type != t \
                            or cons[0].name in claimed:
                        ok = False
                        break
                    cur = cons[0]
                    seq.append(cur)
                if ok and len(seq) == len(pattern):
                    disabled.update(o.name for o in seq[:-1])
                    claimed.update(o.name for o in seq)
        return disabled

    def _kernel_channel_axis(self, op: Op) -> Optional[int]:
        """The output-channel axis of the op's kernel: (K, N) linear
        kernels 1, transposed (N, K) ones 0; conv weights (O, I, kh, kw) 0,
        transposed conv weights (I, O/g, kh, kw) 1."""
        if op.type in ("conv", "depthwise_conv", "conv_transpose"):
            return 1 if op.attrs.get("transposed") else 0
        if op.type == "linear" and "kernel" in op.param_products:
            return 0 if op.attrs.get("kernel_transposed") else \
                len(op.param_products["kernel"].shape) - 1
        return None

    def _act_spec(self, name, kind="act", symmetric=None) -> QuantizerSpec:
        cfg = self.config
        return QuantizerSpec(
            name=name, kind=kind, bitwidth=self.default_output_bw,
            symmetric=cfg.act_symmetric if symmetric is None else symmetric,
            strict_symmetric=cfg.strict_symmetric,
            unsigned_symmetric=cfg.unsigned_symmetric,
            scheme=self.quant_scheme, percentile=self.percentile)

    def _build_quantizers(self):
        cfg = self.config
        disabled = self._supergroup_disabled_ops()
        for op in self.graph.ops:
            ot_cfg = cfg.op_type.get(op.type)
            # output activation quantizer
            out_q = cfg.output_quantized
            if ot_cfg is not None and ot_cfg.is_output_quantized is not None:
                out_q = ot_cfg.is_output_quantized
            if op.type in cfg.never_quantized_types or op.name in disabled \
                    or not _is_float(op.output.dtype):
                out_q = False
            if out_q:
                sym = cfg.act_symmetric
                if ot_cfg is not None and ot_cfg.is_symmetric is not None:
                    sym = ot_cfg.is_symmetric
                self.quantizers[op.name] = self._act_spec(op.name,
                                                          symmetric=sym)
                self._act_node_q[op.output.node] = op.name
            # parameter quantizers
            for role, prod in op.param_products.items():
                if prod.param_path in self.quantizers:
                    continue
                is_q = cfg.param_quantized
                if role in cfg.param_overrides:
                    is_q = cfg.param_overrides[role]
                if ot_cfg is not None and role in ot_cfg.params_quantized:
                    is_q = ot_cfg.params_quantized[role]
                if role not in ("kernel", "bias") and op.type == "batchnorm":
                    is_q = False
                if not is_q:
                    continue
                ch_axis = self._kernel_channel_axis(op) if (
                    cfg.per_channel and role == "kernel") else None
                self.quantizers[prod.param_path] = QuantizerSpec(
                    name=prod.param_path, kind="param",
                    bitwidth=self.default_param_bw,
                    symmetric=cfg.param_symmetric,
                    strict_symmetric=cfg.strict_symmetric,
                    unsigned_symmetric=cfg.unsigned_symmetric,
                    scheme=self.param_quant_scheme, channel_axis=ch_axis)
                self._param_node_q[prod.node] = prod.param_path

        # per-op input quantizers ("op_type" is_input_quantized)
        for op in self.graph.ops:
            ot_cfg = cfg.op_type.get(op.type)
            in_q = cfg.input_quantized
            if ot_cfg is not None and ot_cfg.is_input_quantized is not None:
                in_q = ot_cfg.is_input_quantized
            if not in_q or not op.inputs or not _is_float(op.inputs[0].dtype):
                continue
            name = f"{op.name}_input"
            self.quantizers[name] = self._act_spec(name)
            target = op.inputs[0].node
            for n in op.nodes:
                for a in n.all_input_nodes:
                    if self.graph.resolve(a) is target:
                        self._node_input_q.setdefault(n, []).append((a, name))

        # model output quantizers
        if cfg.model_output_quantized:
            for i, node in enumerate(self.graph.output_nodes):
                rnode = self.graph.resolve(node)
                if rnode in self._act_node_q or \
                        not _is_float(self.graph._get_product(rnode).dtype):
                    continue
                name = f"model_output_{i}"
                self.quantizers[name] = self._act_spec(name)
                self._output_node_q[rnode] = name

        # model input quantizers
        if cfg.model_input_quantized:
            for i, node in enumerate(self.graph.input_nodes):
                if not _is_float(self.graph.products[node].dtype):
                    continue
                name = f"model_input_{i}"
                self.quantizers[name] = self._act_spec(name, kind="input")
                self._input_node_q[node] = name

    def _collect_sub_names(self):
        """Per control-flow node: the activation / input quantizer names
        that live (transitively) inside its body — the observers a
        calibration pass updates at every step of the loop (the
        reference's per-timestep grouped quantizers,
        qc_quantize_recurrent.py:191-306)."""
        self._sub_act_names: Dict[fx.Node, list] = {}
        for node, info in self.graph.subgraph_eqns.items():
            names = []
            for op in info["inner_ops"]:
                spec = self.quantizers.get(op.name)
                if spec is not None and spec.kind == "act":
                    names.append(op.name)
                if f"{op.name}_input" in self.quantizers:
                    names.append(f"{op.name}_input")
            self._sub_act_names[node] = sorted(set(names))

    # ------------------------------------------------------------------
    # Interpreter
    # ------------------------------------------------------------------
    def _qdq(self, x: torch.Tensor, name: str, encodings,
             learn_range: bool = False) -> torch.Tensor:
        out = self._qdq_impl(x, name, encodings, learn_range)
        flags = self._qdq_flags
        if flags is not None and name in flags:
            # quantized_fn_flagged: both values computed, the flag picks
            return torch.where(flags[name], out, x)
        return out

    def _qdq_impl(self, x: torch.Tensor, name: str, encodings,
                  learn_range: bool = False) -> torch.Tensor:
        """Fake-quant of x by quantizer ``name``; ``encodings[name]`` is an
        :class:`AffineEncoding` or a (min, max) pair (``qat_fn``)."""
        spec = self.quantizers[name]
        enc = encodings[name]
        emin, emax = (enc.min, enc.max) if isinstance(enc, AffineEncoding) \
            else enc
        if spec.data_type == "float":
            if spec.bitwidth >= 16:
                return float_sim.fake_cast_fp16(x)
            # FP8: maxval from the calibrated range (per channel where the
            # encoding is)
            maxval = torch.clamp(torch.maximum(emin.abs(), emax.abs()),
                                 min=1e-8)
            return float_sim.quantize_to_fp8(
                x, maxval.reshape(-1) if maxval.dim() else maxval,
                channel_axis=spec.channel_axis if maxval.dim() else None)
        if spec.block_size is not None:
            # blockwise: encodings in the blocked keepdims shape broadcast
            # against the blocked view
            xb = _to_blocks(x, spec.block_size, spec.block_axis)
            return quantize_dequantize(
                xb, emin, emax, bitwidth=spec.bitwidth,
                symmetric=spec.symmetric,
                strict_symmetric=spec.strict_symmetric,
                unsigned_symmetric=spec.unsigned_symmetric,
                learn_range=learn_range).reshape(x.shape)
        emin = _broadcast_encoding(emin, x.dim(), spec.channel_axis)
        emax = _broadcast_encoding(emax, x.dim(), spec.channel_axis)
        return quantize_dequantize(
            x, emin, emax, bitwidth=spec.bitwidth, symmetric=spec.symmetric,
            strict_symmetric=spec.strict_symmetric,
            unsigned_symmetric=spec.unsigned_symmetric,
            learn_range=learn_range)

    @staticmethod
    def _dynamic_param_qdq(w: torch.Tensor, spec: QuantizerSpec
                           ) -> torch.Tensor:
        """Fake-quant of w on a grid recomputed from w itself (min-max,
        gated to include zero): StaticGridQuantWrapper's per-step training
        behaviour (qc_quantize_op.py:771-777). The grid gets no gradient."""
        if spec.data_type == "float":
            if spec.bitwidth >= 16:
                return float_sim.fake_cast_fp16(w)
            mv = float_sim.init_fp8_maxval_minmax(w, spec.channel_axis)
            return float_sim.quantize_to_fp8(w, mv, spec.channel_axis)
        grid = dict(bitwidth=spec.bitwidth, symmetric=spec.symmetric,
                    strict_symmetric=spec.strict_symmetric,
                    unsigned_symmetric=spec.unsigned_symmetric)
        if spec.block_size is not None:
            wb = _to_blocks(w, spec.block_size, spec.block_axis)
            mn, mx = gate_min_max(
                wb.amin(dim=spec.block_axis + 1, keepdim=True),
                wb.amax(dim=spec.block_axis + 1, keepdim=True))
            return quantize_dequantize(wb, mn, mx, **grid).reshape(w.shape)
        mn, mx = gate_min_max(*reduce_min_max(w, spec.channel_axis))
        return quantize_dequantize(
            w, _broadcast_encoding(mn, w.dim(), spec.channel_axis),
            _broadcast_encoding(mx, w.dim(), spec.channel_axis), **grid)

    def _run(self, params, args, mode: str, obs_states=None, analyzers=None,
             encodings=None, learn_range: bool = False,
             capture: Optional[set] = None, dynamic_params: bool = False):
        """Evaluate the graph with quantization interception.

        mode: 'fp' (no quantizers), 'observe' (parameters fake-quantized
        with their encodings, activation observers updated), 'quantized'
        (the full fake-quant forward). ``learn_range``: the fake-quant gives
        (min, max) their range-learning gradients; ``dynamic_params``:
        in 'quantized' mode each parameter's grid comes from the live
        weights (``_dynamic_param_qdq``). ``capture``: product names whose
        values (after their own quantizer, as the forward reads them) are
        returned. Returns (outputs, obs_states, captured)."""
        params = self.params if params is None else params
        observing = mode == "observe" and analyzers is not None
        quantizing = mode == "quantized" and encodings is not None
        captured: Dict[str, torch.Tensor] = {}
        if capture:
            wanted = {p.node: p.name for p in self.graph.products.values()
                      if p.name in capture}

        def hook(qname, val):
            if observing and qname in analyzers:
                obs_states[qname] = analyzers[qname].update(
                    obs_states[qname], val)
            elif quantizing and qname in encodings:
                val = self._qdq(val, qname, encodings, learn_range)
            return val

        def quantize(node, val):
            if node.op == "placeholder":
                qname = self._param_node_q.get(node)
                if qname is not None:
                    if dynamic_params and mode == "quantized":
                        val = self._dynamic_param_qdq(
                            val, self.quantizers[qname])
                    elif mode in ("observe", "quantized") \
                            and encodings is not None and qname in encodings:
                        val = self._qdq(val, qname, encodings, learn_range)
                    return val
                qname = self._input_node_q.get(node)
            else:
                qname = self._act_node_q.get(node)
            return val if qname is None else hook(qname, val)

        def after(node, val):
            val = quantize(node, val)
            if capture and node in wanted:
                captured[wanted[node]] = val
            return val

        def before(node, read):
            hooks = self._node_input_q.get(node)
            if not hooks or mode == "fp":
                return None
            targets = dict(hooks)
            return fx.node.map_arg(
                (node.args, node.kwargs),
                lambda a: hook(targets[a], read(a)) if a in targets
                else read(a))

        def at_output(node, val):
            qname = self._output_node_q.get(self.graph.resolve(node))
            return val if qname is None else hook(qname, val)

        def enter(node):
            # a body with quantizers runs step by step with the hooks;
            # otherwise (and in 'fp' mode) it runs as it was traced
            return (mode != "fp" and bool(self._sub_act_names.get(node))) \
                or bool(capture)

        out = run_graph(self.graph, flat_args(self.graph, params, args),
                        before=before if self._node_input_q else None,
                        after=after, at_output=at_output, enter=enter)
        return out, obs_states, captured

    # ------------------------------------------------------------------
    # Public API
    # ------------------------------------------------------------------
    def fp_fn(self, params, *args):
        """Floating-point forward through the interpreter."""
        with torch.no_grad():
            return self._run(params, args, "fp")[0]

    def collect_activations(self, params, args, product_names: Sequence[str],
                            mode: str = "fp") -> Dict[str, torch.Tensor]:
        """The named products' values in one forward, ``fp`` or
        ``quantized`` (ActivationSampler, adaround/activation_sampler.py:175):
        a product takes its own quantizer first in the quantized forward.
        ``params`` None: the model's own."""
        enc = self._encodings if mode == "quantized" else None
        with torch.no_grad():
            return self._run(params, args, mode, encodings=enc,
                             capture=set(product_names))[2]

    def compute_param_encodings(self, params=None, only=None):
        """Parameter encodings straight from the weights; ``only`` limits
        the (re)computation to some parameter names."""
        params = self.params if params is None else params
        only = set(only) if only is not None else None
        for name, spec in self.quantizers.items():
            if spec.kind != "param" or name in self._frozen \
                    or not spec.enabled:
                continue
            if only is not None and name not in only:
                continue
            w = params[name]
            if spec.block_size is not None:
                self._encodings[name] = self._blockwise_encoding(w, spec)
                continue
            analyzer = EncodingAnalyzer(spec.scheme,
                                        channel_axis=spec.channel_axis,
                                        percentile=spec.percentile)
            st = analyzer.update(analyzer.init_state(w.shape, w.device), w)
            self._encodings[name] = analyzer.compute(
                st, bitwidth=spec.bitwidth, symmetric=spec.symmetric,
                strict_symmetric=spec.strict_symmetric,
                unsigned_symmetric=spec.unsigned_symmetric)

    @staticmethod
    def _blockwise_encoding(w, spec: QuantizerSpec) -> AffineEncoding:
        if spec.lpbq:
            return grouped_block_quantize_dequantize(
                w, spec.block_size, spec.block_axis, spec.bitwidth,
                spec.lpbq_scale_bw)[1]
        return blockwise_encoding(w, spec.block_size, spec.block_axis,
                                  bitwidth=spec.bitwidth,
                                  symmetric=spec.symmetric)

    def compute_encodings(self, params, data_iter: Iterable,
                          num_batches: Optional[int] = None):
        """Calibrate: observe activations over ``data_iter`` (each item a
        tuple of model inputs or one tensor), then compute every encoding
        (v1/quantsim.py:425-448 flow). ``params`` None: the model's own."""
        params = self.params if params is None else params
        self.compute_param_encodings(params)
        analyzers, obs = {}, {}
        for name, spec in self.quantizers.items():
            if spec.kind == "param" or not spec.enabled:
                continue      # disabled quantizers pay no observe cost
            analyzers[name] = EncodingAnalyzer(spec.scheme,
                                               percentile=spec.percentile)
            obs[name] = analyzers[name].init_state(device=self.device)
        count = 0
        with torch.no_grad():
            for batch in data_iter:
                if not isinstance(batch, (tuple, list)):
                    batch = (batch,)
                obs = self._run(params, batch, "observe", obs_states=obs,
                                analyzers=analyzers,
                                encodings=self._encodings)[1]
                count += 1
                if num_batches is not None and count >= num_batches:
                    break
        if count == 0:
            raise RuntimeError("compute_encodings: data_iter yielded no "
                               "batches")
        # kept for recompute_encoding / set_bitwidth / set_percentile_value
        self._analyzers, self._obs_states = analyzers, obs
        self._calib_params = params
        for name, analyzer in analyzers.items():
            if name in self._frozen:
                continue
            spec = self.quantizers[name]
            self._encodings[name] = analyzer.compute(
                obs[name], bitwidth=spec.bitwidth, symmetric=spec.symmetric,
                strict_symmetric=spec.strict_symmetric,
                unsigned_symmetric=spec.unsigned_symmetric)
        return self._encodings

    def set_param_blockwise(self, params, name: str, block_size: int,
                            axis: int = 0, bitwidth: int = 4,
                            symmetric: bool = True, lpbq: bool = False,
                            scale_bitwidth: int = 4):
        """Switch a parameter quantizer to blockwise (one (min, max) per
        ``block_size`` slice along ``axis``) or LPBQ (block scales on a
        per-group integer grid)."""
        params = self.params if params is None else params
        spec = self.quantizers[name]
        if spec.kind != "param":
            raise ValueError(f"{name} is not a parameter quantizer")
        self.quantizers[name] = spec = dataclasses.replace(
            spec, block_size=block_size, block_axis=axis, bitwidth=bitwidth,
            symmetric=symmetric, channel_axis=None, lpbq=lpbq,
            lpbq_scale_bw=scale_bitwidth)
        self._encodings[name] = self._blockwise_encoding(params[name], spec)

    @property
    def encodings(self) -> Dict[str, AffineEncoding]:
        return self._encodings

    def set_encoding(self, name: str, encoding: AffineEncoding,
                     freeze: bool = False):
        """Override one quantizer's encoding (set_and_freeze_param_encodings,
        v1/quantsim.py:1839)."""
        self._encodings[name] = encoding
        if freeze:
            self._frozen.add(name)

    def quantized_fn(self, params, *args):
        """The fake-quantized forward."""
        if not self._encodings:
            raise RuntimeError("call compute_encodings first")
        with torch.no_grad():
            return self._run(params, args, "quantized",
                             encodings=self._encodings)[0]

    def set_quantizer_enabled(self, name: str, enabled: bool):
        """Toggle a quantizer: a disabled one skips the observe pass and the
        fake-quant; its encoding is parked and restored on re-enable."""
        spec = self.quantizers[name]
        if spec.enabled == enabled:
            return
        self.quantizers[name] = dataclasses.replace(spec, enabled=enabled)
        if not enabled and name in self._encodings:
            self._parked_encodings[name] = self._encodings.pop(name)
        elif enabled and name in self._parked_encodings:
            self._encodings[name] = self._parked_encodings.pop(name)

    def disable_quantizer(self, name: str):
        """Remove a quantizer (exclude_layers_from_quantization,
        v1/quantsim.py:731)."""
        if self.quantizers.pop(name, None) is None:
            return
        self._encodings.pop(name, None)
        for d in (self._act_node_q, self._param_node_q, self._input_node_q,
                  self._output_node_q):
            for k in [k for k, v in d.items() if v == name]:
                del d[k]
        for node in list(self._node_input_q):
            self._node_input_q[node] = [
                (a, n) for a, n in self._node_input_q[node] if n != name]
            if not self._node_input_q[node]:
                del self._node_input_q[node]

    # ------------------------------------------------------------------
    # Sweeps and re-computation (AMP, QuantAnalyzer)
    # ------------------------------------------------------------------
    def quantized_fn_subset(self, params, *args, enabled=None, disabled=None):
        """The quantized forward with only some quantizers active
        (QuantAnalyzer / AMP enable-disable sweeps, quant_analyzer.py:63)."""
        enc = dict(self._encodings)
        if enabled is not None:
            enabled = set(enabled)
            enc = {k: v for k, v in enc.items() if k in enabled}
        for k in disabled or ():
            enc.pop(k, None)
        with torch.no_grad():
            return self._run(params, args, "quantized", encodings=enc)[0]

    def quantized_fn_flagged(self):
        """``(apply_fn, names)``: ``apply_fn(params, flags, *args)`` applies
        quantizer ``names[i]`` only where ``flags[i]`` (a bool tensor of
        ``len(names)``) is true, so one function serves every
        enable/disable combination; the flags stay on the device."""
        if not self._encodings:
            raise RuntimeError("call compute_encodings first")
        names = sorted(n for n in self._encodings if n in self.quantizers)

        def apply_fn(params, flags, *args):
            self._qdq_flags = {n: flags[i] for i, n in enumerate(names)}
            try:
                with torch.no_grad():
                    return self._run(params, args, "quantized",
                                     encodings=self._encodings)[0]
            finally:
                self._qdq_flags = None

        return apply_fn, names

    def recompute_encoding(self, name: str, bitwidth: int) -> AffineEncoding:
        """One quantizer's encoding at another bitwidth from what was
        kept of its calibration (the weights, or the observer state): no
        new data."""
        spec = dataclasses.replace(self.quantizers[name], bitwidth=bitwidth)
        if spec.kind == "param":
            params = getattr(self, "_calib_params", None)
            w = (self.params if params is None else params)[name]
            if spec.block_size is not None:
                return self._blockwise_encoding(w, spec)
            analyzer = EncodingAnalyzer(spec.scheme,
                                        channel_axis=spec.channel_axis,
                                        percentile=spec.percentile)
            st = analyzer.update(analyzer.init_state(w.shape, w.device), w)
        else:
            analyzer, st = self._analyzers[name], self._obs_states[name]
        return analyzer.compute(
            st, bitwidth=bitwidth, symmetric=spec.symmetric,
            strict_symmetric=spec.strict_symmetric,
            unsigned_symmetric=spec.unsigned_symmetric)

    def set_bitwidth(self, name: str, bitwidth: int):
        """Change a quantizer's bitwidth (its spec and its encoding)."""
        spec = self.quantizers[name]
        if spec.bitwidth == bitwidth:
            return
        self._encodings[name] = self.recompute_encoding(name, bitwidth)
        self.quantizers[name] = dataclasses.replace(spec, bitwidth=bitwidth)

    def set_percentile_value(self, name: str, percentile: float):
        """The clip of one ``percentile``-scheme quantizer
        (set_percentile_value, v1/quantsim.py:478); its encoding is
        recomputed from the kept calibration histogram, if any."""
        spec = self.quantizers[name]
        if spec.scheme != "percentile":
            raise ValueError(
                f"set_percentile_value: quantizer {name!r} uses scheme "
                f"{spec.scheme!r}, not 'percentile'")
        if not 50.0 <= percentile <= 100.0:
            raise ValueError(f"percentile must be in [50, 100]: {percentile}")
        self.quantizers[name] = spec = dataclasses.replace(
            spec, percentile=percentile)
        if name in getattr(self, "_analyzers", {}):
            analyzer = EncodingAnalyzer(spec.scheme, percentile=percentile)
            self._analyzers[name] = analyzer
            if name not in self._frozen:
                self._encodings[name] = analyzer.compute(
                    self._obs_states[name], bitwidth=spec.bitwidth,
                    symmetric=spec.symmetric,
                    strict_symmetric=spec.strict_symmetric,
                    unsigned_symmetric=spec.unsigned_symmetric)

    # ------------------------------------------------------------------
    # Export and load
    # ------------------------------------------------------------------
    def export_encodings_v1(self) -> Dict[str, Any]:
        """AIMET '1.0.0' encodings (experimental/v2/quantsim/
        export_utils.py): flat lists with vectorized scale / offset."""
        def entry(name):
            enc, spec = self._encodings[name], self.quantizers[name]
            if spec.data_type == "float":
                return {"name": name, "dtype": "FLOAT", "bw": spec.bitwidth}
            deltas = enc.delta.detach().cpu().reshape(-1).tolist()
            offsets = [int(o) for o in enc.offset.detach().cpu().reshape(-1)]
            enc_type = "PER_TENSOR" if len(deltas) == 1 else (
                "PER_BLOCK" if spec.block_size is not None else "PER_CHANNEL")
            return {"name": name, "dtype": "INT", "enc_type": enc_type,
                    "bw": spec.bitwidth, "is_sym": bool(spec.symmetric),
                    "scale": deltas, "offset": offsets}

        act, param = [], []
        for name, spec in self.quantizers.items():
            if name in self._encodings:
                (param if spec.kind == "param" else act).append(entry(name))
        return {"version": "1.0.0", "activation_encodings": act,
                "param_encodings": param}

    def export_encodings(self) -> Dict[str, Any]:
        """AIMET '0.6.1' encodings JSON dict
        (_export_encodings_to_files, v1/quantsim.py:940-1044): per name a
        list of entries, one a channel; ``is_symmetric`` a string and
        ``offset`` an int, as the reference writes them."""
        def entries(name):
            enc, spec = self._encodings[name], self.quantizers[name]
            mins = enc.min.detach().cpu().reshape(-1).tolist()
            maxs = enc.max.detach().cpu().reshape(-1).tolist()
            if spec.data_type == "float":
                if spec.bitwidth >= 16:
                    # FP16 entries carry no grid
                    return [{"bitwidth": spec.bitwidth, "dtype": "float"}]
                # FP8: min / max kept so the maxval survives a round trip
                return [{"bitwidth": spec.bitwidth, "dtype": "float",
                         "min": mn, "max": mx} for mn, mx in zip(mins, maxs)]
            deltas = enc.delta.detach().cpu().reshape(-1).tolist()
            offsets = enc.offset.detach().cpu().reshape(-1).tolist()
            return [{"bitwidth": spec.bitwidth, "dtype": "int",
                     "is_symmetric": str(spec.symmetric), "min": mn,
                     "max": mx, "scale": d, "offset": int(o)}
                    for mn, mx, d, o in zip(mins, maxs, deltas, offsets)]

        act, param = {}, {}
        for name, spec in self.quantizers.items():
            if name in self._encodings:
                (param if spec.kind == "param" else act)[name] = \
                    entries(name)
        return {"version": "0.6.1", "activation_encodings": act,
                "param_encodings": param}

    def export(self, path: str, prefix: str) -> str:
        """Write ``export_encodings()`` to ``{path}/{prefix}.encodings``."""
        out = os.path.join(path, f"{prefix}.encodings")
        with open(out, "w") as f:
            json.dump(self.export_encodings(), f, indent=2, sort_keys=True)
        return out

    def export_safetensors(self, path: str, prefix: str, params=None,
                           quantized: bool = False) -> str:
        """Write the weights to ``{path}/{prefix}.safetensors`` by parameter
        name (v1/quantsim.py:660). ``quantized``: also, for every symmetric
        parameter encoding of at most 8 bits, the integer codes
        (``<name>.int``, int8) and the scales (``<name>.scale``, f32)."""
        from safetensors.torch import save_file

        params = self.params if params is None else params
        tensors = {}
        for key, w in params.items():
            w = w.detach()
            tensors[key] = w.cpu().contiguous()
            spec = self.quantizers.get(key)
            if not quantized or key not in self._encodings or spec is None \
                    or not spec.symmetric or spec.bitwidth > 8:
                continue
            enc = self._encodings[key]
            lim = 2 ** (spec.bitwidth - 1) - 1
            if spec.block_size is not None:
                wb = _to_blocks(w, spec.block_size, spec.block_axis)
                q = quantize_to_int(wb, enc, dtype=torch.int32).reshape(
                    w.shape)
            else:
                q = quantize_to_int(w, enc, channel_axis=spec.channel_axis,
                                    dtype=torch.int32)
            tensors[key + ".int"] = q.clamp(-lim, lim).to(
                torch.int8).cpu().contiguous()
            tensors[key + ".scale"] = enc.delta.detach().reshape(-1).to(
                torch.float32).cpu().contiguous()
        out = os.path.join(path, f"{prefix}.safetensors")
        save_file(tensors, out)
        return out

    def load_encodings(self, encodings_dict: Dict[str, Any]):
        """Restore encodings from an exported '0.6.1' dict (load_encodings,
        v1/quantsim.py:1696): an entry with scale and offset gives its grid
        back exactly; float entries switch the quantizer to float (FP16
        with a placeholder grid, FP8 with its min / max); names the sim
        does not have are skipped."""
        merged = dict(encodings_dict.get("activation_encodings", {}))
        merged.update(encodings_dict.get("param_encodings", {}))

        def col(entries, key):
            t = torch.tensor([float(e[key]) for e in entries],
                             dtype=torch.float32, device=self.device)
            return t[0] if len(entries) == 1 else t

        for name, entries in merged.items():
            if name not in self.quantizers:
                continue
            spec = self.quantizers[name]
            grid = (spec.symmetric, spec.strict_symmetric,
                    spec.unsigned_symmetric)
            if entries and all(str(e.get("dtype", "int")).lower() == "float"
                               for e in entries):
                self.quantizers[name] = dataclasses.replace(
                    spec, data_type="float",
                    bitwidth=int(entries[0].get("bitwidth", 16)))
                if all("min" in e and "max" in e for e in entries):
                    self._encodings[name] = compute_encoding_from_min_max(
                        col(entries, "min"), col(entries, "max"), 8, *grid)
                else:
                    # FP16: no grid to restore; a placeholder keeps the
                    # quantizer active in the quantized forward
                    self._encodings[name] = compute_encoding_from_min_max(
                        torch.tensor(-1.0, device=self.device),
                        torch.tensor(1.0, device=self.device), 8, *grid)
                continue
            if all("scale" in e and "offset" in e for e in entries):
                self._encodings[name] = AffineEncoding(
                    min=col(entries, "min"), max=col(entries, "max"),
                    delta=col(entries, "scale"),
                    offset=col(entries, "offset"), bitwidth=spec.bitwidth,
                    symmetric=spec.symmetric,
                    strict_symmetric=spec.strict_symmetric,
                    unsigned_symmetric=spec.unsigned_symmetric)
                continue
            self._encodings[name] = compute_encoding_from_min_max(
                col(entries, "min"), col(entries, "max"), spec.bitwidth,
                *grid)

    # ------------------------------------------------------------------
    # Quantizer data type and quantization-aware training
    # ------------------------------------------------------------------
    def set_quantizer_data_type(self, name: str, data_type: str,
                                bitwidth: Optional[int] = None):
        """Switch a quantizer between 'int' and 'float' simulation
        (QuantizationDataType, aimet_common/defs.py:309). 'float' at
        bitwidth >= 16 simulates an FP16 round trip; at bitwidth 8 an FP8
        fake cast whose maxval derives from the calibrated range. The
        affine encoding is kept, and recomputed when the quantizer returns
        to 'int' at another bitwidth or from 'float'; before calibration
        such an encoding is dropped (the next ``compute_encodings``
        rebuilds it)."""
        if data_type not in ("int", "float"):
            raise ValueError(f"data_type must be 'int'|'float': {data_type}")
        spec = self.quantizers[name]
        bw = spec.bitwidth if bitwidth is None else bitwidth
        if spec.data_type == data_type and bw == spec.bitwidth:
            return
        needs_grid = (data_type == "int"
                      and (bw != spec.bitwidth or spec.data_type != "int"))
        self.quantizers[name] = dataclasses.replace(
            spec, data_type=data_type, bitwidth=bw)
        if needs_grid and name in self._encodings \
                and name not in self._frozen:
            can_recompute = (
                (spec.kind == "param" and hasattr(self, "_calib_params"))
                or (spec.kind != "param"
                    and name in getattr(self, "_analyzers", {})))
            if can_recompute:
                self._encodings[name] = self.recompute_encoding(name, bw)
            else:
                del self._encodings[name]

    def static_grid_qat_fn(self):
        """Static-grid QAT forward ``apply_fn(params, *args)``: each
        parameter's grid recomputed from the live weights (min-max) every
        call, activation encodings fixed; straight-through gradients to
        the parameters, none through the grids."""
        if not self._encodings:
            raise RuntimeError("call compute_encodings first")

        def apply_fn(params, *args):
            with torch.enable_grad():
                return self._run(params, args, "quantized",
                                 encodings=self._encodings,
                                 dynamic_params=True)[0]

        return apply_fn

    def qat_fn(self):
        """Range-learning QAT (LearnedGridQuantWrapper): returns
        ``(apply_fn, encoding_params)``; ``apply_fn(params, enc_params,
        *args)`` is the quantized forward on the grids of ``enc_params``
        (name -> (min, max) tensors, copies of the sim's encodings), and
        autograd gives each (min, max) the reference's analytic
        range-learning gradients."""
        if not self._encodings:
            raise RuntimeError("call compute_encodings first")
        enc_params = {name: (enc.min.detach().clone(),
                             enc.max.detach().clone())
                      for name, enc in self._encodings.items()}

        def apply_fn(params, enc_params, *args):
            with torch.enable_grad():
                return self._run(params, args, "quantized",
                                 encodings=enc_params, learn_range=True)[0]

        return apply_fn, enc_params

    def update_encodings_from_qat(self, enc_params):
        """Fold trained (min, max) back into the stored encodings."""
        for name, (mn, mx) in enc_params.items():
            spec = self.quantizers[name]
            self._encodings[name] = compute_encoding_from_min_max(
                mn.detach(), mx.detach(), spec.bitwidth, spec.symmetric,
                spec.strict_symmetric, spec.unsigned_symmetric)

    def export_stablehlo(self, *a, **k):
        raise NotImplementedError(
            "QuantizationSimModel.export_stablehlo is not ported to "
            "aimet_tpu_torch yet")
