"""Quantsim configuration — counterpart of ``aimet_tpu/quantsim/config.py``
(a pure-Python copy: the port imports nothing of the JAX package).

One typed config tree (+ AIMET-JSON importer). Replaces the reference's
JSON-schema config stack
(aimet_common/quantsim_config/{json_config_importer,quantsim_config}.py and
default_config.json) with a dataclass tree; ``from_aimet_json`` accepts the
reference's on-disk schema (sections defaults / params / op_type /
supergroups / model_input / model_output) for drop-in compatibility.

Application order matches QuantSimConfigurator._set_quantsim_configs
(aimet_torch/quantsim_config/quantsim_config.py:111-683): defaults -> params
-> op_type -> supergroups -> model_input -> model_output.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Tuple

# AIMET op-type names (ONNX-style) -> our graph op types
AIMET_OP_TYPE_MAP = {
    "Conv": ("conv", "depthwise_conv"),
    "ConvTranspose": ("conv_transpose",),
    "Gemm": ("linear",),
    "MatMul": ("matmul",),
    "Relu": ("relu",),
    "Clip": ("clip",),
    "Add": ("add",),
    "Mul": ("mul",),
    "Concat": ("concat",),
    "BatchNormalization": ("batchnorm",),
    "Softmax": ("softmax",),
    "Sigmoid": ("sigmoid",),
    "Tanh": ("tanh",),
    "AveragePool": ("avgpool",),
    "MaxPool": ("maxpool",),
    "Mean": ("mean",),
    "Gather": ("gather", "embedding"),
    "Squeeze": (),
    "Pad": (),
    "Cast": (),
    "Dropout": (),
    "Expand": (),
    # QNN op-def names (backend-aware path; ParserModule op vocabulary)
    "Conv2d": ("conv", "depthwise_conv"),
    "DepthWiseConv2d": ("depthwise_conv",),
    "TransposeConv2d": ("conv_transpose",),
    "FullyConnected": ("linear",),
    "ElementWiseAdd": ("add",),
    "ElementWiseSubtract": ("sub",),
    "ElementWiseMultiply": ("mul",),
    "ElementWiseDivide": ("div",),
    "PoolAvg2d": ("avgpool",),
    "PoolMax2d": ("maxpool",),
    "ReduceMean": ("mean",),
}


def _aimet_types(name: str) -> Tuple[str, ...]:
    return AIMET_OP_TYPE_MAP.get(name, (name.lower(),))


@dataclasses.dataclass
class OpTypeConfig:
    is_output_quantized: Optional[bool] = None
    is_input_quantized: Optional[bool] = None
    is_symmetric: Optional[bool] = None
    params_quantized: Dict[str, bool] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class QuantSimConfig:
    """Typed equivalent of the reference's default_config.json."""

    # defaults section
    output_quantized: bool = True
    input_quantized: bool = False
    param_quantized: bool = True
    param_symmetric: bool = True
    act_symmetric: bool = False
    strict_symmetric: bool = False
    unsigned_symmetric: bool = False
    per_channel: bool = False

    # params section: per-param-role overrides ('bias' unquantized by default)
    param_overrides: Dict[str, bool] = dataclasses.field(
        default_factory=lambda: {"bias": False})

    # op_type section
    op_type: Dict[str, OpTypeConfig] = dataclasses.field(default_factory=dict)

    # supergroups: sequences of our op types; only the last op's output is
    # quantized (quantsim_config.py:74-110 callback semantics)
    supergroups: List[Tuple[str, ...]] = dataclasses.field(
        default_factory=lambda: [
            ("conv", "batchnorm", "relu", "clip"),
            ("conv", "batchnorm", "relu"),
            ("conv", "batchnorm", "clip"),
            ("conv", "batchnorm"),
            ("conv", "relu", "clip"),
            ("conv", "relu"),
            ("conv", "clip"),
            ("depthwise_conv", "batchnorm", "relu", "clip"),
            ("depthwise_conv", "batchnorm", "relu"),
            ("depthwise_conv", "batchnorm", "clip"),
            ("depthwise_conv", "batchnorm"),
            ("depthwise_conv", "relu", "clip"),
            ("depthwise_conv", "relu"),
            ("depthwise_conv", "clip"),
            ("linear", "relu"),
            ("add", "relu"),
            ("relu", "clip"),
        ])

    model_input_quantized: bool = True
    model_output_quantized: bool = False  # extra output-quantizer on final op

    # op types that never get an output quantizer regardless of defaults.
    # scan/while/cond: their stacked/final outputs are already quantized by
    # the per-timestep quantizers inside the body; split: gates are slices
    # of an already-quantized pre-activation.
    never_quantized_types: Tuple[str, ...] = (
        "mean", "gather", "reduce_sum", "reduce_max", "reduce_min",
        "window_sum", "cast", "dropout", "scan", "while", "cond", "split")

    @classmethod
    def default(cls) -> "QuantSimConfig":
        cfg = cls()
        # mirror default_config.json's op_type section
        cfg.op_type["batchnorm"] = OpTypeConfig(
            params_quantized={"p0": False, "p1": False, "p2": False, "p3": False})
        return cfg

    @classmethod
    def per_channel_default(cls) -> "QuantSimConfig":
        cfg = cls.default()
        cfg.per_channel = True
        return cfg

    @classmethod
    def from_aimet_json(cls, path: str) -> "QuantSimConfig":
        """Import a reference-format config JSON
        (schema: aimet_common/quantsim_config/quantsim_config_schema.py)."""
        with open(path) as f:
            raw = json.load(f)

        def as_bool(v, default=None):
            if v is None:
                return default
            if isinstance(v, bool):
                return v
            return str(v).lower() == "true"

        cfg = cls()
        d = raw.get("defaults", {})
        ops_d = d.get("ops", {})
        params_d = d.get("params", {})
        cfg.output_quantized = as_bool(ops_d.get("is_output_quantized"), True)
        cfg.input_quantized = as_bool(ops_d.get("is_input_quantized"), False)
        cfg.act_symmetric = as_bool(ops_d.get("is_symmetric"), False)
        cfg.param_quantized = as_bool(params_d.get("is_quantized"), True)
        cfg.param_symmetric = as_bool(params_d.get("is_symmetric"), True)
        cfg.strict_symmetric = as_bool(d.get("strict_symmetric"), False)
        cfg.unsigned_symmetric = as_bool(d.get("unsigned_symmetric"), False)
        cfg.per_channel = as_bool(d.get("per_channel_quantization"), False)

        cfg.param_overrides = {}
        for pname, pcfg in raw.get("params", {}).items():
            q = as_bool(pcfg.get("is_quantized"))
            if q is not None:
                cfg.param_overrides[pname] = q

        cfg.op_type = {}
        for aimet_name, ocfg in raw.get("op_type", {}).items():
            entry = OpTypeConfig(
                is_output_quantized=as_bool(ocfg.get("is_output_quantized")),
                is_input_quantized=as_bool(ocfg.get("is_input_quantized")),
                is_symmetric=as_bool(ocfg.get("is_symmetric")),
                params_quantized={
                    p: as_bool(pc.get("is_quantized"), True)
                    for p, pc in ocfg.get("params", {}).items()})
            for t in _aimet_types(aimet_name):
                cfg.op_type[t] = entry

        sgs = []
        for sg in raw.get("supergroups", []):
            expansions = [()]
            for aimet_name in sg.get("op_list", []):
                types = _aimet_types(aimet_name)
                expansions = [e + (t,) for e in expansions for t in types]
            sgs.extend(tuple(e) for e in expansions)
        if sgs:
            cfg.supergroups = sgs

        cfg.model_input_quantized = as_bool(
            raw.get("model_input", {}).get("is_input_quantized"), False)
        cfg.model_output_quantized = as_bool(
            raw.get("model_output", {}).get("is_output_quantized"), False)
        return cfg
