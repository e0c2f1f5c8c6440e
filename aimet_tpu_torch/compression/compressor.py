"""ModelCompressor — the user-facing compression API, counterpart of
``aimet_tpu/compression/compressor.py``.

The reference's compress_model flow (aimet_torch/compress.py:50,
compression_factory.py:60, aimet_common/compression_algo.py:53): pick a
scheme (spatial SVD, weight SVD, successive SVD or channel pruning),
select per-layer compression ratios (greedy auto mode, or manual), and
return a compressed model and its statistics.

The compressed model is the traced graph evaluated with factored / pruned
op replacements (``graph/interpreter.evaluate_with_replacements``): a
``CompressedModel`` is an ``nn.Module`` holding the original model's
parameters under their names, so it traces (``ConnectedGraph``), quantizes
(``QuantizationSimModel``) and compresses again like any model. Its
replaced layers compute with weights held as constants of the model, as
in the JAX package, so a re-traced compressed graph has them as constant
kernels: ``lower_to_int`` skips them, and a second compression reads them
from the graph (``_op_weights``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import fx, nn

from ..graph.connected_graph import ConnectedGraph, Op
from ..graph.interpreter import _fetch_attr, evaluate_with_replacements
from .channel_pruning import (make_channel_pruned_replacements,
                              make_multi_channel_pruned_replacements)
from .cost import (Cost, layer_cost, model_cost, rank_for_comp_ratio,
                   ranks_for_comp_ratio_ssvd, spatial_svd_cost,
                   successive_svd_cost, weight_svd_cost)
from .greedy import GreedyCompRatioSelect, GreedySelectionParameters
from .svd import (make_spatial_svd_replacement,
                  make_successive_svd_replacement,
                  make_weight_svd_replacement)


@dataclasses.dataclass
class CompressionStats:
    original_cost: Cost
    compressed_cost: Cost
    per_layer_ratios: Dict[str, float]

    @property
    def mac_compression_ratio(self) -> float:
        return self.compressed_cost.mac / max(self.original_cost.mac, 1e-12)


class CompressedModel(nn.Module):
    """A compressed network: the base model's graph with op replacements.
    ``model(*inputs)`` runs it on its own parameters (the base model's,
    under the same names); ``model.run(params, *inputs)`` on others, as
    the JAX package's ``compressed(params, *args)``."""

    def __init__(self, base: nn.Module, graph: ConnectedGraph,
                 replacements: Dict[str, Callable],
                 stats: Optional[CompressionStats] = None):
        super().__init__()
        for name, child in base.named_children():
            self.add_module(name, child)
        for name, p in base.named_parameters(recurse=False):
            self.register_parameter(name, p)
        self.graph = graph
        self.replacements = replacements
        self.stats = stats

    def forward(self, *args):
        return self.run(dict(self.named_parameters()), *args)

    def run(self, params, *args):
        return evaluate_with_replacements(self.graph, params, args,
                                          self.replacements)


class ModelCompressor:
    """compress_model entry point (compress.py:50)."""

    SCHEMES = ("spatial_svd", "weight_svd", "successive_svd",
               "channel_pruning")

    @staticmethod
    def _compressible_layers(graph: ConnectedGraph, scheme: str,
                             ignore: Sequence[str] = ()) -> List[Op]:
        types = {"spatial_svd": ("conv",),
                 "weight_svd": ("conv", "linear"),
                 "successive_svd": ("conv",),
                 "channel_pruning": ("conv",)}[scheme]
        return [op for op in graph.ops
                if op.type in types and "kernel" in op.param_products
                and op.name not in ignore]

    @staticmethod
    def _op_weights(graph: ConnectedGraph, params, op: Op):
        """(kernel, bias) of a layer op: parameters, or, for a re-traced
        compressed graph whose layer computes with constants, the graph's
        constants."""
        if "kernel" in op.param_products:
            w = params[op.param_products["kernel"].param_path]
            bias = params[op.param_products["bias"].param_path] \
                if "bias" in op.param_products else None
            return w, bias

        def const(v):
            v = graph.resolve(v) if isinstance(v, fx.Node) else v
            if isinstance(v, fx.Node) and v.op == "get_attr":
                return _fetch_attr(graph.gm, v.target)
            return None

        node = op.nodes[0]
        w = const(node.args[1])
        if w is None:
            raise ValueError(
                f"{op.name}: weights are neither parameters nor constants; "
                f"cannot compress this layer further")
        b = node.args[2] if len(node.args) > 2 else None
        bias = const(b) if isinstance(b, fx.Node) else None
        return w, None if bias is None else bias.reshape(-1)

    @classmethod
    def _make_replacement(cls, graph, params, op, ratio, scheme,
                          act_samples=None):
        w, bias = cls._op_weights(graph, params, op)
        if scheme == "spatial_svd":
            rank = rank_for_comp_ratio(op, ratio, "spatial_svd")
            return {op.name: make_spatial_svd_replacement(op, w, bias, rank)}
        if scheme == "weight_svd":
            rank = rank_for_comp_ratio(op, ratio, "weight_svd")
            return {op.name: make_weight_svd_replacement(op, w, bias, rank)}
        if scheme == "successive_svd":
            r, s = ranks_for_comp_ratio_ssvd(op, ratio)
            return {op.name: make_successive_svd_replacement(op, w, bias,
                                                             r, s)}
        if scheme == "channel_pruning":
            x_s = y_s = None
            if act_samples is not None and op.name in act_samples:
                x_s, y_s = act_samples[op.name]
            return make_channel_pruned_replacements(graph, params, op, ratio,
                                                    x_s, y_s)
        raise ValueError(scheme)

    @classmethod
    def compress_model(cls, model: nn.Module, example_inputs, params=None,
                       scheme: str = "spatial_svd",
                       eval_fn: Optional[Callable] = None,
                       target_comp_ratio: float = 0.5,
                       num_candidates: int = 10,
                       manual_ratios: Optional[Dict[str, float]] = None,
                       ignore_layers: Sequence[str] = (),
                       act_samples=None
                       ) -> Tuple[CompressedModel, CompressionStats]:
        """Auto (greedy, needs ``eval_fn``) or manual per-layer ratios.

        ``params``: by name (default: the model's own). ``eval_fn(model)``
        -> score (higher is better), called on the single-layer candidate
        compressions of the greedy selection."""
        if scheme not in cls.SCHEMES:
            raise ValueError(f"unknown scheme {scheme!r}")
        if params is None:
            params = {k: v.detach() for k, v in model.named_parameters()}
        with torch.no_grad():
            return cls._compress(model, tuple(example_inputs), params,
                                 scheme, eval_fn, target_comp_ratio,
                                 num_candidates, manual_ratios,
                                 ignore_layers, act_samples)

    @classmethod
    def _compress(cls, model, example_inputs, params, scheme, eval_fn,
                  target_comp_ratio, num_candidates, manual_ratios,
                  ignore_layers, act_samples):
        graph = ConnectedGraph(model, example_inputs, params=params)
        layers = cls._compressible_layers(graph, scheme, ignore_layers)

        def svd_cost(op, r):
            if scheme == "spatial_svd":
                return spatial_svd_cost(
                    op, rank_for_comp_ratio(op, r, "spatial_svd"))
            if scheme == "successive_svd":
                return successive_svd_cost(op,
                                           *ranks_for_comp_ratio_ssvd(op, r))
            return weight_svd_cost(op, rank_for_comp_ratio(op, r,
                                                           "weight_svd"))

        if manual_ratios is None:
            if eval_fn is None:
                raise ValueError("auto mode needs eval_fn")

            def greedy_eval(ratio_map: Dict[str, float]) -> float:
                if scheme == "channel_pruning":
                    reps, _ = make_multi_channel_pruned_replacements(
                        graph, params, ratio_map, act_samples)
                else:
                    reps = {}
                    for name, r in ratio_map.items():
                        reps.update(cls._make_replacement(
                            graph, params, graph.get_op(name), r, scheme,
                            act_samples))
                return eval_fn(CompressedModel(model, graph, reps))

            sel = GreedyCompRatioSelect(
                graph, layers, greedy_eval,
                GreedySelectionParameters(target_comp_ratio, num_candidates),
                cost_fn=lambda op, r: (layer_cost(op).mac * r
                                       if scheme == "channel_pruning"
                                       else svd_cost(op, r).mac))
            ratios, _ = sel.select()
        else:
            ratios = dict(manual_ratios)

        replacements: Dict[str, Callable] = {}
        compressed_cost = Cost(0, 0)
        if scheme == "channel_pruning":
            # one joint winnow plan: seeds that share a channel space
            # (residual trunks, concat segments) shrink together
            active = {n: r for n, r in ratios.items() if r < 1.0}
            replacements, _ = make_multi_channel_pruned_replacements(
                graph, params, active, act_samples)
        for op in graph.ops:
            r = ratios.get(op.name, 1.0)
            if op.name in ratios and r < 1.0:
                if scheme != "channel_pruning":
                    replacements.update(cls._make_replacement(
                        graph, params, op, r, scheme, act_samples))
                    compressed_cost += svd_cost(op, r)
                else:
                    c = layer_cost(op)
                    compressed_cost += Cost(c.memory * r, c.mac * r)
            else:
                compressed_cost += layer_cost(op)
        stats = CompressionStats(model_cost(graph), compressed_cost, ratios)
        return CompressedModel(model, graph, replacements, stats), stats
