"""SmoothQuant-style activation-outlier smoothing — counterpart of
``aimet_tpu/algorithms/smooth_quant.py`` (Xiao et al., 2022,
arXiv:2211.10438).

Per-channel activation outliers (post-norm hidden states whose channel
ranges spread 10-100x) break per-tensor W8A8; SmoothQuant moves that
difficulty into the weights with a per-input-channel scale

    s_j = amax_act_j**alpha / amax_w_j**(1 - alpha)

applied as ``x' = x / s`` and ``W'[j, :] = s_j * W[j, :]``. The division
is folded into the producing op's parameters (an RMSNorm / LayerNorm
gamma, or a preceding linear's output channels), so the transform is a
parameter rewrite, exact in float; the smoothed parameters drop into
``QuantizationSimModel`` / ``lower_to_int``.

Sites come from the ``ConnectedGraph``; the activation ranges from one
float forward a calibration batch (``collect_activations``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence

import torch

from ..graph.connected_graph import ConnectedGraph, Op
from ..utils.logger import AimetLogger
from ..utils.pytree import set_leaves

logger = AimetLogger.get_area_logger(AimetLogger.LogAreas.Quant)

# producer op types whose params can absorb the 1/s factor
_FOLDABLE_PRODUCERS = ("scale", "batchnorm", "linear")


@dataclasses.dataclass
class SmoothTarget:
    """One smoothing site: ``producer``'s output feeds only ``consumers``
    (linear layers contracting over their input's last axis)."""
    producer: Op
    consumers: List[Op]

    @property
    def act_product_name(self) -> str:
        return self.producer.output.name


def _kernel_in_out(op: Op) -> Optional[tuple]:
    """(input-channel axis, output-channel axis) of a 2-D linear kernel:
    (0, 1) for the flax layout (in, out), (1, 0) when the graph transposes
    an (out, in) weight on its way to the product; None otherwise."""
    k = op.param_products.get("kernel")
    if k is None or len(k.shape) != 2:
        return None
    return (1, 0) if op.attrs.get("kernel_transposed") else (0, 1)


def _linear_in_channels(op: Op) -> Optional[int]:
    """Input-channel count of a plain dense layer (contraction over the
    activation's last axis); None if not that shape."""
    axes = _kernel_in_out(op)
    if axes is None:
        return None
    return int(op.param_products["kernel"].shape[axes[0]])


def _per_channel_param_paths(op: Op, channels: int) -> List[str]:
    """Param paths of ``op`` that broadcast per channel over the last axis
    (shape (C,) or (..., 1, C))."""
    paths = []
    for prod in op.param_products.values():
        shp = tuple(prod.shape)
        n = 1
        for d in shp:
            n *= d
        if shp and shp[-1] == channels and n == channels:
            paths.append(prod.param_path)
    return paths


def find_smooth_targets(graph: ConnectedGraph) -> List[SmoothTarget]:
    """Smoothing sites: groups of dense layers sharing a producer whose
    params can exactly absorb the per-channel division. Every consumer of
    the producer's output is a 2-D ``linear`` on the same input width,
    the output is no model output, and the producer is a ``scale`` /
    ``batchnorm`` with per-channel params on that width or a ``linear``
    whose output width it is."""
    targets = []
    for op in graph.ops:
        if op.type not in _FOLDABLE_PRODUCERS:
            continue
        consumers = op.output.consumers
        if not consumers or op.output.is_model_output:
            continue
        cin = _linear_in_channels(consumers[0])
        if cin is None:
            continue
        if not all(c.type == "linear" and _linear_in_channels(c) == cin
                   for c in consumers):
            continue
        if op.type in ("scale", "batchnorm"):
            if not _per_channel_param_paths(op, cin):
                continue
        else:  # linear producer: its output channels are the smooth axis
            axes = _kernel_in_out(op)
            if axes is None or int(
                    op.param_products["kernel"].shape[axes[1]]) != cin:
                continue
        targets.append(SmoothTarget(op, list(consumers)))
    return targets


def compute_smoothing_scales(act_amax, w_amax,
                             alpha: float = 0.5) -> torch.Tensor:
    """s_j = act_j^alpha / w_j^(1-alpha), guarded so dead channels and
    degenerate ranges stay at 1 (no-op)."""
    act = torch.clamp(torch.as_tensor(act_amax, dtype=torch.float32), min=0.)
    w = torch.clamp(torch.as_tensor(w_amax, dtype=torch.float32,
                                    device=act.device), min=0.)
    s = torch.pow(act, alpha) / torch.pow(torch.clamp(w, min=1e-12),
                                          1.0 - alpha)
    s = torch.nan_to_num(s, nan=1.0, posinf=1.0, neginf=1.0)
    return torch.where((act <= 1e-12) | (w <= 1e-12) | (s <= 1e-12),
                       torch.ones_like(s), s)


def _collect_act_amax(sim, params, batches, product_names: Sequence[str]
                      ) -> Dict[str, torch.Tensor]:
    """Per-channel (last axis) abs-max of each named product over all
    calibration batches."""
    amax: Dict[str, torch.Tensor] = {}
    for batch in batches:
        args = batch if isinstance(batch, (tuple, list)) else (batch,)
        caps = sim.collect_activations(params, args, product_names,
                                       mode="fp")
        for name, val in caps.items():
            red = val.to(torch.float32).abs().amax(
                dim=tuple(range(val.dim() - 1)))
            amax[name] = red if name not in amax else torch.maximum(
                amax[name], red)
    return amax


def _spread(a: torch.Tensor) -> float:
    """max / min of the positive entries."""
    pos = torch.where(a > 0, a, torch.full_like(a, float("inf")))
    return (a.max() / torch.clamp(pos.min(), min=1e-12)).item()


def apply_smooth_quant(model: torch.nn.Module, example_inputs, params,
                       batches: Iterable, *, alpha: float = 0.5,
                       graph: Optional[ConnectedGraph] = None,
                       targets: Optional[List[SmoothTarget]] = None):
    """Smooth activation outliers into the weights ahead of W8A8.

    Args:
      model: the float ``nn.Module``.
      example_inputs: a tuple of example inputs used for tracing.
      params: the float parameters to transform (None: the model's own).
      batches: calibration inputs (a tensor, or a tuple of the model's
        inputs), as ``compute_encodings`` takes them.
      alpha: migration strength (0: all difficulty stays in the
        activations, 1: all of it moves to the weights); 0.5 is the
        paper's default.
      graph / targets: a pre-built graph / site list.

    Returns ``(new_params, info)``: info maps each producer op's name to
    the scale vector applied. The caller's tensors are not written.
    """
    from ..quantsim.qsim import QuantizationSimModel

    if params is None:
        params = {k: v.detach() for k, v in model.named_parameters()}
    device = next(iter(params.values())).device
    graph = graph or ConnectedGraph(model, example_inputs, params)
    if targets is None:
        targets = find_smooth_targets(graph)
    if not targets:
        logger.info("smooth_quant: no foldable sites found")
        return params, {}

    sim = QuantizationSimModel(model, example_inputs, device=device)
    act_amax = _collect_act_amax(
        sim, params, list(batches), [t.act_product_name for t in targets])

    cur = dict(params)
    updates: Dict[str, torch.Tensor] = {}

    def upd(path, val):
        updates[path] = val
        cur[path] = val

    def bcast(s, w, axis):
        shape = [1] * w.dim()
        shape[axis] = -1
        return s.reshape(shape).to(w.dtype)

    info: Dict[str, torch.Tensor] = {}
    for t in targets:
        cin = _linear_in_channels(t.consumers[0])
        # weight amax per input channel, max-combined across the group
        w_amax = None
        for c in t.consumers:
            in_ax, out_ax = _kernel_in_out(c)
            w = cur[c.param_products["kernel"].param_path]
            wa = w.to(torch.float32).abs().amax(dim=out_ax)
            w_amax = wa if w_amax is None else torch.maximum(w_amax, wa)
        act = act_amax[t.act_product_name]
        s = compute_smoothing_scales(act, w_amax, alpha)
        info[t.producer.name] = s

        # consumers: W'[j, :] = s_j * W[j, :]
        for c in t.consumers:
            in_ax, _ = _kernel_in_out(c)
            kp = c.param_products["kernel"].param_path
            upd(kp, cur[kp] * bcast(s, cur[kp], in_ax))
        # producer: divide its per-channel params by s
        if t.producer.type in ("scale", "batchnorm"):
            for pp in _per_channel_param_paths(t.producer, cin):
                p = cur[pp]
                upd(pp, (p.reshape(-1) / s).reshape(p.shape).to(p.dtype))
        else:  # linear producer: scale its output channels (and bias)
            _, out_ax = _kernel_in_out(t.producer)
            kp = t.producer.param_products["kernel"].param_path
            upd(kp, cur[kp] / bcast(s, cur[kp], out_ax))
            bp = t.producer.param_products.get("bias")
            if bp is not None:
                b = cur[bp.param_path]
                upd(bp.param_path, (b / s).to(b.dtype))
        logger.info("smooth_quant: %s -> %s (spread %.1fx -> %.1fx)",
                    t.producer.name, [c.name for c in t.consumers],
                    _spread(act), _spread(act / s))

    return set_leaves(params, updates), info
