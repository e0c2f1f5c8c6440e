"""Backend-aware quantsim — counterpart of
``aimet_tpu/quantsim/backend_aware.py``: constrain quantizer settings to
what the target backend supports.

Port of the reference's op-def pipeline:
  - ``ModelOpDefParser`` (DlQuantization/src/ParserModule.cpp:1-699,
    XmlTypes.h): parses a *master* op-def XML (``<OpDefList><OpDef>``, one
    per op, with per-``<Input>/<Output>/<Parameter>`` ``<Datatype>`` lists,
    ``<Shape><Rank>``, ``<Mandatory>`` and weight-describing
    ``<Description>``) plus a *supplemental backend* XML
    (``<SupplementalOpDefList><SupplementalOpDef>``) that narrows
    ``BACKEND_SPECIFIC`` datatypes and lists ``<SupportedOps>``.
  - supported-kernels validation with the reference's action semantics
    (aimet_torch/v1/quantsim.py:1891 ``_validate_supported_kernels_for_
    quantizers``, SupportedKernelsAction {allow/warn/assert}).
  - backend_aware_quantsim_utility.py: snapping quantizers to the nearest
    supported (bitwidth, data_type) kernel.

Also accepted: a JSON op-def (native format) and the single-file
"QNN-style XML subset" of earlier rounds (kept for compatibility).
"""
from __future__ import annotations

import dataclasses
import json
import re
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Sequence, Tuple

from .config import _aimet_types
from .qsim import QuantizationSimModel

# QnnDatatype_t (ParserModule.cpp strToDtype) -> (bitwidth, data_type) for
# the quantizable fixed-point/float types; raw INT/UINT/BOOL types are
# carried through by name but produce no quantizer kernel.
QNN_DTYPE_TO_KERNEL: Dict[str, Tuple[int, str]] = {
    "QNN_DATATYPE_SFIXED_POINT_4": (4, "int"),
    "QNN_DATATYPE_UFIXED_POINT_4": (4, "int"),
    "QNN_DATATYPE_SFIXED_POINT_8": (8, "int"),
    "QNN_DATATYPE_UFIXED_POINT_8": (8, "int"),
    "QNN_DATATYPE_SFIXED_POINT_16": (16, "int"),
    "QNN_DATATYPE_UFIXED_POINT_16": (16, "int"),
    "QNN_DATATYPE_SFIXED_POINT_32": (32, "int"),
    "QNN_DATATYPE_UFIXED_POINT_32": (32, "int"),
    "QNN_DATATYPE_FLOAT_16": (16, "float"),
    "QNN_DATATYPE_FLOAT_32": (32, "float"),
}

# strToRank (ParserModule.cpp)
QNN_RANKS: Dict[str, Optional[int]] = {
    "SCALAR": 0, "1D": 1, "2D": 2, "3D": 3, "4D": 4, "5D": 5, "ND": None,
}

_WEIGHT_DESCRIPTIONS = ("filters", "weights")


@dataclasses.dataclass(frozen=True)
class SupportedKernel:
    act_bitwidth: int
    act_dtype: str = "int"
    param_bitwidth: int = 8
    param_dtype: str = "int"


@dataclasses.dataclass
class Attribute:
    """One input/output/parameter constraint (ParserModule Attribute)."""
    name: str
    datatypes: List[str] = dataclasses.field(default_factory=list)
    rank: Optional[int] = None          # None = ND / unconstrained
    mandatory: bool = False
    multi_flag: bool = False            # "in[N]"-style repeated argument
    description: str = ""

    def kernels(self) -> List[Tuple[int, str]]:
        """Quantizable (bitwidth, data_type) pairs among the datatypes."""
        out = []
        for d in self.datatypes:
            k = QNN_DTYPE_TO_KERNEL.get(d)
            if k is not None and k not in out:
                out.append(k)
        return out


@dataclasses.dataclass
class OpConstraints:
    """Per-op argument constraints (ParserModule OpConstraints)."""
    inputs: List[Attribute] = dataclasses.field(default_factory=list)
    outputs: List[Attribute] = dataclasses.field(default_factory=list)
    parameters: Dict[str, Attribute] = dataclasses.field(default_factory=dict)
    filter_index: int = -1              # which input is the weight tensor

    def supported_kernels(self) -> List[SupportedKernel]:
        """Cross the output-activation kernels with the weight-input
        kernels (the reference reports candidates as
        ((act_bw, act_dtype), (param_bw, param_dtype)))."""
        acts = self.outputs[0].kernels() if self.outputs else []
        params: List[Tuple[int, str]] = []
        if 0 <= self.filter_index < len(self.inputs):
            params = self.inputs[self.filter_index].kernels()
        if not acts:
            return []
        if not params:
            return [SupportedKernel(a_bw, a_dt) for a_bw, a_dt in acts]
        return [SupportedKernel(a_bw, a_dt, p_bw, p_dt)
                for a_bw, a_dt in acts for p_bw, p_dt in params]


def _parse_attribute(node, backend_node, section: str) -> Attribute:
    """Parse one <Input>/<Output>/<Parameter> element; BACKEND_SPECIFIC
    datatype lists are replaced by the same-named element's datatypes in
    the supplemental backend op-def (extractDtype{Ip,Out,Param})."""
    name = (node.findtext("Name") or "").strip()
    dtypes = [d.text.strip() for d in node.findall("Datatype")
              if d.text is not None]
    if "BACKEND_SPECIFIC" in dtypes and backend_node is not None:
        for bnode in backend_node.findall(section):
            if (bnode.findtext("Name") or "").strip() == name:
                dtypes = [d.text.strip() for d in bnode.findall("Datatype")
                          if d.text is not None]
                break
    shape = node.find("Shape")
    rank = None
    if shape is not None:
        rank = QNN_RANKS.get((shape.findtext("Rank") or "ND").strip())
    mandatory = (node.findtext("Mandatory") or "").strip().lower() == "true"
    desc = ""
    d = node.find("Description")
    if d is not None:
        desc = (d.findtext("Content") or "").strip()
    attr = Attribute(name=name, datatypes=dtypes, rank=rank,
                     mandatory=mandatory, description=desc)
    # "in[N]" / "out[N]" repeated-argument indicator
    m = re.match(r"^(in|out)\[(\d+)\]", name)
    if m:
        attr.multi_flag = True
    return attr


class ModelOpDefParser:
    """Op-def database: {op-type: [SupportedKernel]} plus (when built from
    master/backend XML) the full per-argument OpConstraints."""

    def __init__(self, op_defs: Dict[str, List[SupportedKernel]],
                 constraints: Optional[Dict[str, OpConstraints]] = None,
                 op_list: Optional[List[str]] = None):
        self.op_defs = op_defs
        self.constraints = constraints or {}
        self.op_list = op_list or sorted(op_defs)

    # -- reference-style construction (master + supplemental backend) -----
    @classmethod
    def from_qnn_xml(cls, master_path: str,
                     backend_path: Optional[str] = None
                     ) -> "ModelOpDefParser":
        """ModelOpDefParser(masterPath, backendPath) parity
        (ParserModule.cpp populate): ops come from the backend file's
        <SupportedOps> (or every master OpDef when no backend file);
        per-arg datatype/rank/mandatory constraints from the master file,
        with BACKEND_SPECIFIC datatypes resolved in the supplemental
        per-op node."""
        master = ET.parse(master_path).getroot()
        backend = ET.parse(backend_path).getroot() \
            if backend_path is not None else None

        backend_ops: Dict[str, ET.Element] = {}
        op_list: List[str] = []
        if backend is not None:
            for el in backend.iter("SupplementalOpDef"):
                nm = (el.findtext("Name") or "").strip()
                backend_ops[nm.lower()] = el
            sup = backend.find("SupportedOps")
            if sup is not None:
                op_list = [e.text.strip() for e in sup if e.text]

        cons: Dict[str, OpConstraints] = {}
        defs: Dict[str, List[SupportedKernel]] = {}
        names: List[str] = []
        for opdef in master.iter("OpDef"):
            name = (opdef.findtext("Name") or "").strip()
            if not name:
                continue
            if op_list and name.lower() not in {o.lower() for o in op_list}:
                continue
            bnode = backend_ops.get(name.lower())
            oc = OpConstraints()
            for i, node in enumerate(opdef.findall("Input")):
                attr = _parse_attribute(node, bnode, "Input")
                if attr.description.lower() in _WEIGHT_DESCRIPTIONS:
                    m = re.match(r"^in\[(\d+)\]", attr.name)
                    oc.filter_index = int(m.group(1)) if m else i
                oc.inputs.append(attr)
            for node in opdef.findall("Output"):
                oc.outputs.append(_parse_attribute(node, bnode, "Output"))
            for node in opdef.findall("Parameter"):
                attr = _parse_attribute(node, bnode, "Parameter")
                oc.parameters[attr.name] = attr
            sks = oc.supported_kernels()
            names.append(name)
            for t in _aimet_types(name):
                cons[t] = oc
                defs[t] = sks
        return cls(defs, cons, names)

    # -- native JSON -------------------------------------------------------
    @classmethod
    def from_json(cls, path: str) -> "ModelOpDefParser":
        with open(path) as f:
            raw = json.load(f)
        out: Dict[str, List[SupportedKernel]] = {}
        for name, kernels in raw.items():
            sks = [SupportedKernel(
                act_bitwidth=k["activation"]["bitwidth"],
                act_dtype=k["activation"].get("dtype", "int"),
                param_bitwidth=k.get("param", {}).get("bitwidth", 8),
                param_dtype=k.get("param", {}).get("dtype", "int"))
                for k in kernels]
            for t in _aimet_types(name):
                out[t] = sks
        return cls(out)

    # -- single-file XML (compat subset + auto-detect of master format) ---
    @classmethod
    def from_xml(cls, path: str,
                 backend_path: Optional[str] = None) -> "ModelOpDefParser":
        root = ET.parse(path).getroot()
        if root.tag == "OpDefList" or root.find("OpDef") is not None \
                and root.find("OpDef").find("Input") is not None:
            return cls.from_qnn_xml(path, backend_path)
        out: Dict[str, List[SupportedKernel]] = {}
        for opdef in root.iter("OpDef"):
            name_el = opdef.find("Name")
            if name_el is None:
                continue
            sks = []
            for sk in opdef.iter("SupportedKernel"):
                act = sk.find("Activation")
                par = sk.find("Param")
                sks.append(SupportedKernel(
                    act_bitwidth=int(act.get("bitwidth", "8"))
                    if act is not None else 8,
                    act_dtype=(act.get("dtype", "int")
                               if act is not None else "int"),
                    param_bitwidth=int(par.get("bitwidth", "8"))
                    if par is not None else 8,
                    param_dtype=(par.get("dtype", "int")
                                 if par is not None else "int")))
            for t in _aimet_types(name_el.text.strip()):
                out[t] = sks
        return cls(out)

    # -- getters (ModelOpDefParser C++/pybind API parity) -----------------
    def supported_kernels_for(self, op_type: str
                              ) -> Optional[List[SupportedKernel]]:
        return self.op_defs.get(op_type)

    def _cons(self, op_type: str) -> OpConstraints:
        try:
            return self.constraints[op_type]
        except KeyError:
            raise KeyError(f"no op-def constraints for {op_type!r}")

    def get_size(self, op_type: str) -> Dict[str, int]:
        """{'input_size', 'output_size', 'param_size'} (getSize)."""
        c = self._cons(op_type)
        return {"input_size": len(c.inputs), "output_size": len(c.outputs),
                "param_size": len(c.parameters)}

    def get_input_datatypes(self, op_type: str, index: int) -> List[str]:
        return self._cons(op_type).inputs[index].datatypes

    def get_output_datatypes(self, op_type: str, index: int) -> List[str]:
        return self._cons(op_type).outputs[index].datatypes

    def get_param_datatypes(self, op_type: str, name: str) -> List[str]:
        return self._cons(op_type).parameters[name].datatypes

    def get_input_rank(self, op_type: str, index: int) -> Optional[int]:
        return self._cons(op_type).inputs[index].rank

    def get_output_rank(self, op_type: str, index: int) -> Optional[int]:
        return self._cons(op_type).outputs[index].rank

    def get_filters_index(self, op_type: str) -> int:
        return self._cons(op_type).filter_index


def check_rank_constraints(sim: QuantizationSimModel,
                           parser: ModelOpDefParser) -> List[str]:
    """Flag graph tensors whose rank the backend op-def cannot ingest
    (the rank side of ParserModule's per-arg constraints)."""
    messages = []
    for op in sim.graph.ops:
        c = parser.constraints.get(op.type)
        if c is None:
            continue
        if c.inputs and op.inputs:
            r = c.inputs[0].rank
            if r is not None and len(op.inputs[0].shape) != r:
                messages.append(
                    f"RANK {op.name}: input rank {len(op.inputs[0].shape)}"
                    f" != backend rank {r}")
        if c.outputs and op.output is not None:
            r = c.outputs[0].rank
            if r is not None and len(op.output.shape) != r:
                messages.append(
                    f"RANK {op.name}: output rank {len(op.output.shape)}"
                    f" != backend rank {r}")
    return messages


def _closest_kernel(kernels: Sequence[SupportedKernel], bw: int, dtype: str,
                    which: str) -> Tuple[int, str]:
    """Nearest supported (bitwidth, dtype): exact dtype match preferred,
    then minimum bitwidth distance (ties -> higher precision)."""
    def key(k):
        kbw = k.act_bitwidth if which == "act" else k.param_bitwidth
        kdt = k.act_dtype if which == "act" else k.param_dtype
        return (kdt != dtype, abs(kbw - bw), -kbw)
    best = min(kernels, key=key)
    if which == "act":
        return best.act_bitwidth, best.act_dtype
    return best.param_bitwidth, best.param_dtype


def apply_backend_constraints(sim: QuantizationSimModel,
                              parser: ModelOpDefParser,
                              strict: bool = False) -> List[str]:
    """Snap each quantizer to the closest supported kernel — bitwidth AND
    data_type (backend_aware_quantsim_utility semantics); returns a list
    of human-readable adjustment/violation messages."""
    messages = []
    for op in sim.graph.ops:
        kernels = parser.supported_kernels_for(op.type)
        if not kernels:
            continue
        act_ok = {(k.act_bitwidth, k.act_dtype) for k in kernels}
        param_ok = {(k.param_bitwidth, k.param_dtype) for k in kernels}
        if op.name in sim.quantizers:
            spec = sim.quantizers[op.name]
            cur = (spec.bitwidth, spec.data_type)
            if cur not in act_ok:
                bw, dt = _closest_kernel(kernels, *cur, which="act")
                if strict:
                    messages.append(
                        f"VIOLATION {op.name}: activation {cur} unsupported"
                        f" (supported: {sorted(act_ok)})")
                else:
                    sim.set_quantizer_data_type(op.name, dt, bw)
                    messages.append(
                        f"{op.name}: activation {cur} -> ({bw}, {dt})")
        for prod in op.param_products.values():
            name = prod.param_path
            if name not in sim.quantizers:
                continue
            spec = sim.quantizers[name]
            cur = (spec.bitwidth, spec.data_type)
            if cur not in param_ok:
                bw, dt = _closest_kernel(kernels, *cur, which="param")
                if strict:
                    messages.append(
                        f"VIOLATION {name}: param {cur} unsupported"
                        f" (supported: {sorted(param_ok)})")
                else:
                    sim.set_quantizer_data_type(name, dt, bw)
                    messages.append(f"{name}: param {cur} -> ({bw}, {dt})")
    return messages


def validate_supported_kernels(sim: QuantizationSimModel,
                               parser: ModelOpDefParser,
                               action: str = "warn") -> List[str]:
    """The reference's ``_validate_supported_kernels_for_quantizers``
    (v1/quantsim.py:1891): for every op with supported_kernels, the current
    ((act_bw, act_dtype), (param_bw, param_dtype)) candidate must appear in
    the list. ``action``: 'allow' (no-op), 'warn' (collect messages),
    'assert' (raise RuntimeError on the first violation)."""
    if action == "allow":
        return []
    if action not in ("warn", "assert"):
        raise ValueError(f"action must be allow|warn|assert: {action!r}")
    messages = []
    for op in sim.graph.ops:
        kernels = parser.supported_kernels_for(op.type)
        if not kernels:
            continue
        act = None
        if op.name in sim.quantizers:
            s = sim.quantizers[op.name]
            act = (s.bitwidth, s.data_type)
        params = [(sim.quantizers[p.param_path].bitwidth,
                   sim.quantizers[p.param_path].data_type)
                  for p in op.param_products.values()
                  if p.param_path in sim.quantizers]
        if act is not None and params:
            ok = any((k.act_bitwidth, k.act_dtype) == act
                     and (k.param_bitwidth, k.param_dtype) == pc
                     for k in kernels for pc in params)
            if not ok:
                msg = (f"candidate (act={act}, params={params}) is not "
                       f"under the supported_kernels for {op.name}")
                if action == "assert":
                    raise RuntimeError(msg)
                messages.append(msg)
        elif act is not None:
            if not any((k.act_bitwidth, k.act_dtype) == act
                       for k in kernels):
                msg = (f"activation {act} is not under the "
                       f"supported_kernels for {op.name}")
                if action == "assert":
                    raise RuntimeError(msg)
                messages.append(msg)
    return messages
