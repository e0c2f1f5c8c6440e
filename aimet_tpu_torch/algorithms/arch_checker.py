"""Architecture checker + model validator — counterpart of
``aimet_tpu/algorithms/arch_checker.py``.

Ports:
  - ArchChecker (aimet_torch/arch_checker/arch_checker.py:53-157): walks
    the connected graph applying *node checks* (per-op predicates) and
    *pattern checks* (subgraph structures), records failures per node, and
    writes an HTML report (arch_checker_utils.ArchCheckerReport).
  - the rule catalog (arch_checker/arch_checker_rules.py:57-204):
    channel-multiple/minimum checks, quantization-degrading activations,
    standalone (unfoldable) batch norms, intermediate padding in
    conv-act-[bn]-conv chains, BN behind a concat/split whose branches are
    foldable targets.
  - ModelValidator (aimet_torch/model_validator/): pre-quantsim checks.

Extensible like the reference: ``ArchChecker.add_node_check(op_type, fn)``
and ``ArchChecker.add_pattern_check(fn)``. The catalog keeps the JAX
package's TPU rules (the 128-wide MXU lane alignment, the 7 x 7 kernel
size) under their names and defaults, so both packages report the same
findings on the same model; no H100 rule replaces them.

The port's graph gives a conv's padding and kernel axes in ``attrs``
(``padding``, ``dimension_numbers.rhs_spec`` for the OIHW kernel) and a
linear's kernel layout as ``kernel_transposed``.
"""
from __future__ import annotations

import dataclasses
import html
from typing import Callable, Dict, List, Optional, Tuple

from ..graph.connected_graph import ConnectedGraph, Op
from ..graph.pattern_matcher import match_chain

_ACT_TYPES = {"relu", "clip", "sigmoid", "tanh", "gelu", "silu", "softmax",
              "leaky_relu"}
# PReLU / SiLU degrade quantization performance
# (arch_checker_rules._activation_checks:77-89)
_DEGRADING_ACTS = {"silu", "leaky_relu"}
# the port graph's type for an op no rule classifies (an op outside
# ``aten``), where the JAX graph has ``custom_jvp``
_UNCLASSIFIED = "custom"


@dataclasses.dataclass
class CheckResult:
    op_name: str
    check: str
    message: str
    severity: str = "warning"
    # for pattern checks: every op in the flagged structure
    structure: Tuple[str, ...] = ()


def _conv_channels(op: Op) -> Optional[Tuple[int, int]]:
    kernel = op.param_products.get("kernel")
    if kernel is None:
        return None
    if op.type == "linear":
        # (in, out) kernels; a transposed one is held (out, in)
        if op.attrs.get("kernel_transposed"):
            return kernel.shape[-1], kernel.shape[0]
        return kernel.shape[0], kernel.shape[-1]
    dn = op.attrs.get("dimension_numbers")
    if dn is None:
        return kernel.shape[-2], kernel.shape[-1]
    return (kernel.shape[dn.rhs_spec[1]], kernel.shape[dn.rhs_spec[0]])


# ---------------------------------------------------------------------------
# node checks (op -> Optional[CheckResult]); names mirror the reference's
# ---------------------------------------------------------------------------

def _check_conv_channel_32_base(op: Op) -> Optional[CheckResult]:
    """Channels should be multiples of 32 (arch_checker_rules:57-65)."""
    ch = _conv_channels(op)
    if ch is None:
        return None
    cin, cout = ch
    if cin % 32 == 0 and cout % 32 == 0:
        return None
    return CheckResult(
        op.name, "_check_conv_channel_32_base",
        f"{op.name}: channels in={cin} out={cout} not multiples of 32",
        severity="info")


def _check_conv_channel_larger_than_32(op: Op) -> Optional[CheckResult]:
    """Channels should be at least 32 (arch_checker_rules:67-75)."""
    ch = _conv_channels(op)
    if ch is None:
        return None
    cin, cout = ch
    if cin >= 32 and cout >= 32:
        return None
    return CheckResult(
        op.name, "_check_conv_channel_larger_than_32",
        f"{op.name}: channels in={cin} out={cout} below 32 — low compute "
        f"utilization")


def _check_mxu_lane_alignment(op: Op, lane_width: int = 128
                              ) -> Optional[CheckResult]:
    """TPU-specific: output channels not a multiple of the 128-wide MXU
    tile pay padding waste (beyond-reference rule). This is the JAX
    package's rule for the TPU, kept with its name and default so the two
    packages' findings match; it says nothing of the H100's tiles."""
    ch = _conv_channels(op)
    if ch is None:
        return None
    _, cout = ch
    if cout >= 32 and cout % lane_width != 0:
        return CheckResult(
            op.name, "_check_mxu_lane_alignment",
            f"{op.name}: output channels ({cout}) not a multiple of "
            f"{lane_width}; padding waste on the MXU", severity="info")
    return None


def _check_activation(op: Op) -> Optional[CheckResult]:
    """PReLU/SiLU degrade quantization (arch_checker_rules:77-89)."""
    if op.type in _DEGRADING_ACTS:
        return CheckResult(
            op.name, "_activation_checks",
            f"{op.name}: {op.type} degrades quantization performance — "
            f"prefer ReLU/ReLU6")
    return None


# ---------------------------------------------------------------------------
# pattern checks (graph -> List[CheckResult])
# ---------------------------------------------------------------------------

def _check_batch_norm_fold(graph: ConnectedGraph) -> List[CheckResult]:
    """Standalone (unfoldable) batch norms (arch_checker_rules:91-99 via
    find_standalone_batchnorm_ops)."""
    from .bn_fold import find_foldable_pairs
    foldable = {bn.name for _, bn in find_foldable_pairs(graph)}
    out = []
    for op in graph.ops:
        if op.type == "batchnorm" and op.name not in foldable:
            out.append(CheckResult(
                op.name, "_check_batch_norm_fold",
                f"{op.name}: standalone batchnorm cannot be folded "
                f"(hurts PTQ accuracy)"))
    return out


def _padded(op: Op) -> bool:
    pad = op.attrs.get("padding")
    if pad is None or isinstance(pad, str):
        return pad not in (None, "VALID")
    try:
        return any(int(a) or int(b) for a, b in pad)
    except TypeError:
        return False


def _check_intermediate_padding(graph: ConnectedGraph) -> List[CheckResult]:
    """conv -> act -> [bn] -> conv chains where BOTH convs pad
    (arch_checker_rules:101-140): the intermediate padding is quantized
    as zeros at the second conv's input scale — accuracy risk."""
    out = []
    seen = set()
    chains = []
    for act in ("relu", "tanh", "silu"):
        chains += match_chain(graph, ["conv", act, "batchnorm", "conv"])
        chains += match_chain(graph, ["conv", "batchnorm", act, "conv"])
        chains += match_chain(graph, ["conv", act, "conv"])
    for chain in chains:
        conv1, conv2 = chain[0], chain[-1]
        if conv2.name in seen:
            continue
        if _padded(conv1) and _padded(conv2):
            seen.add(conv2.name)
            out.append(CheckResult(
                conv2.name, "_check_intermediate_padding",
                f"{conv2.name}: padded conv follows padded conv through "
                f"activation — intermediate padding quantizes as zeros",
                severity="info",
                structure=tuple(op.name for op in chain)))
    return out


def _check_foldable_bn_with_split(graph: ConnectedGraph
                                  ) -> List[CheckResult]:
    """BN consuming a concat (or fan-out) whose branches end in foldable
    layers (arch_checker_rules:169-204): folding is ambiguous across the
    join, so the BN stays standalone at deployment."""
    foldable_types = ("conv", "depthwise_conv", "conv_transpose", "linear")
    out = []
    for op in graph.ops:
        if op.type != "batchnorm":
            continue
        prod = op.inputs[0].producer if op.inputs else None
        if prod is None or prod.type != "concat":
            continue
        writers = [p.producer for p in prod.inputs if p.producer is not None]
        bad = [w for w in writers if w.type in foldable_types]
        if bad:
            out.append(CheckResult(
                op.name, "_check_foldable_bn_with_split",
                f"{op.name}: batchnorm behind concat of "
                f"{[w.name for w in bad]} — fold target ambiguous",
                structure=(bad[0].name, prod.name, op.name)))
    return out


def _check_degrading_activation_patterns(graph: ConnectedGraph
                                         ) -> List[CheckResult]:
    """SiLU traced as mul(x, sigmoid(x)) (jax.nn.silu lowers to
    sigmoid+mul rather than one 'silu' op): same degradation flag as the
    node check (_activation_checks)."""
    out = []
    for op in graph.ops:
        if op.type != "mul" or len(op.inputs) != 2:
            continue
        a, b = op.inputs
        for sig, other in ((a, b), (b, a)):
            p = sig.producer
            if p is not None and p.type == "sigmoid" and p.inputs \
                    and p.inputs[0].node is other.node:
                out.append(CheckResult(
                    op.name, "_activation_checks",
                    f"{op.name}: silu (x * sigmoid(x)) degrades "
                    f"quantization performance — prefer ReLU/ReLU6",
                    structure=(p.name, op.name)))
                break
    return out


def _check_missing_activation(graph: ConnectedGraph) -> List[CheckResult]:
    """conv/linear whose consumers include no activation/BN — fusion and
    range-tightening opportunity (beyond-reference rule kept from r1)."""
    out = []
    for op in graph.ops:
        if op.type not in ("conv", "depthwise_conv", "linear"):
            continue
        consumers = [c.type for c in op.output.consumers]
        if consumers and not any(c in _ACT_TYPES or c == "batchnorm"
                                 for c in consumers):
            out.append(CheckResult(
                op.name, "_check_missing_activation",
                f"{op.name} feeds {consumers} without an activation "
                f"function — consider fusing or checking intent",
                severity="info"))
    return out


def _check_large_kernel_efficiency(graph: ConnectedGraph
                                   ) -> List[CheckResult]:
    """Convs with spatial kernels above 7x7: on TPU these lower to many
    MXU passes per output — prefer stacked 3x3s (kernel-size efficiency
    rule; TPU-specific sizing)."""
    out = []
    for op in graph.ops:
        if op.type not in ("conv", "depthwise_conv"):
            continue
        kernel = op.param_products.get("kernel")
        dn = op.attrs.get("dimension_numbers")
        if kernel is None or dn is None:
            continue
        spatial = [kernel.shape[d] for d in dn.rhs_spec[2:]]
        if spatial and max(spatial) > 7:
            out.append(CheckResult(
                op.name, "_check_large_kernel_efficiency",
                f"{op.name}: {spatial} spatial kernel — prefer stacked "
                f"3x3 convs for MXU efficiency", severity="info"))
    return out


class ArchChecker:
    """Rule registry + driver (arch_checker.py:53-157)."""

    _node_checks: Dict[str, List[Callable[[Op], Optional[CheckResult]]]] = {
        "conv": [_check_conv_channel_32_base,
                 _check_conv_channel_larger_than_32,
                 _check_mxu_lane_alignment],
        "depthwise_conv": [_check_conv_channel_larger_than_32],
        "linear": [_check_conv_channel_32_base, _check_mxu_lane_alignment],
        "silu": [_check_activation],
        "leaky_relu": [_check_activation],
    }
    _pattern_checks: List[Callable[[ConnectedGraph], List[CheckResult]]] = [
        _check_batch_norm_fold,
        _check_degrading_activation_patterns,
        _check_intermediate_padding,
        _check_foldable_bn_with_split,
        _check_missing_activation,
        _check_large_kernel_efficiency,
    ]

    @classmethod
    def add_node_check(cls, op_type: str,
                       check: Callable[[Op], Optional[CheckResult]]):
        """Register an extra per-node check (add_node_check parity)."""
        cls._node_checks.setdefault(op_type, []).append(check)

    @classmethod
    def add_pattern_check(
            cls, check: Callable[[ConnectedGraph], List[CheckResult]]):
        """Register an extra pattern check (add_pattern_check parity)."""
        cls._pattern_checks.append(check)

    @classmethod
    def check_model(cls, graph: ConnectedGraph, lane_width: int = 128
                    ) -> List[CheckResult]:
        results: List[CheckResult] = []
        for op in graph.ops:
            for check in cls._node_checks.get(op.type, ()):
                r = check(op)
                if r is not None:
                    results.append(r)
        for pcheck in cls._pattern_checks:
            results.extend(pcheck(graph))
        return results

    @classmethod
    def check_model_arch(cls, model, example_inputs,
                         result_path: Optional[str] = None
                         ) -> List[CheckResult]:
        """User entry point mirroring ArchChecker.check_model_arch: trace
        ``model(*example_inputs)``, run node + pattern checks, optionally
        export the HTML report."""
        graph = ConnectedGraph(model, example_inputs)
        results = cls.check_model(graph)
        if result_path is not None:
            cls.export_html(results, result_path)
        return results

    @staticmethod
    def export_html(results: List[CheckResult], path: str):
        """Per-node report (ArchCheckerReport.export_to_html): one row per
        (node, failed check), with the op structure for pattern hits."""
        rows = "".join(
            f"<tr><td>{html.escape(r.op_name)}</td><td>{r.check}</td>"
            f"<td>{r.severity}</td><td>{html.escape(r.message)}</td>"
            f"<td>{html.escape(' -> '.join(r.structure))}</td></tr>"
            for r in results)
        doc = f"""<!doctype html><html><head><title>ArchChecker</title>
<style>td,th{{border:1px solid #999;padding:4px 8px}}
table{{border-collapse:collapse}}</style></head><body>
<h1>Architecture check report</h1>
<table><tr><th>op</th><th>failed check</th><th>severity</th>
<th>message</th><th>structure</th></tr>
{rows}</table></body></html>"""
        with open(path, "w") as f:
            f.write(doc)


class ModelValidator:
    """Pre-quantsim validation (model_validator/model_validator.py)."""

    @staticmethod
    def validate_model(model, example_inputs) -> Dict[str, bool]:
        checks = {}
        try:
            graph = ConnectedGraph(model, example_inputs)
            checks["traceable"] = True
        except Exception:
            checks["traceable"] = False
            return checks
        # every quantizable op reachable & typed: the JAX graph leaves an
        # unclassified custom_jvp_call as ``custom_jvp``, the port's graph
        # a custom op as ``custom``
        unknown = [op for op in graph.ops if op.type == _UNCLASSIFIED]
        checks["all_ops_classified"] = not unknown
        # at least one quantizable layer
        checks["has_quantizable_layers"] = any(
            op.type in ("conv", "depthwise_conv", "linear", "matmul")
            for op in graph.ops)
        return checks
