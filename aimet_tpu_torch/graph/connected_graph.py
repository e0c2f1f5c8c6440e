"""ConnectedGraph: an op/product IR built by tracing a PyTorch module —
counterpart of ``aimet_tpu/graph/connected_graph.py``.

The JAX package traces ``fn(params, *inputs)`` to a jaxpr; here
``torch.fx.experimental.proxy_tensor.make_fx`` traces
``torch.func.functional_call(model, params, inputs)`` to an aten-level
graph whose placeholders are the parameters (in ``named_parameters``
order) and then the flattened inputs, with concrete shapes in each node's
``meta["val"]``. Module-level ops are rebuilt from it by the same rules:

  - every node is classified *param-derived* (computed only from
    parameters and constants, e.g. ``kernel.to(bf16)`` or the rope tables)
    or *data-derived*; param-derived nodes are weight preprocessing, not
    ops;
  - ``mm`` / ``bmm`` / ``addmm`` with a parameter operand is a ``linear``
    op (its bias add folds in), otherwise a ``matmul``; ``convolution`` is
    a ``conv`` / ``depthwise_conv`` / ``conv_transpose`` whose ``attrs``
    hold its ``window_strides``, its ``padding`` (a ``constant_pad_nd`` of its
    input folded in) and its kernel's axes (``dimension_numbers.rhs_spec``,
    (0, 1, 2, 3) for OIHW);
  - a chain of elementwise ops each mixing data with a parameter or a
    literal becomes one ``scale`` op (``batchnorm`` when two or more carry
    parameters, ``relu`` / ``clip`` for literal max / min);
  - shape-only ops (``view``, ``_unsafe_view``, ``transpose``,
    ``permute``, ``expand``, ``clone``, ``_to_copy``, ``slice``,
    ``constant_pad_nd``, ...) pass through and never receive quantizers;
  - ``max_pool2d_with_indices`` with its values item is one ``maxpool``
    op (the CNNs' pooling), ``mean`` over the spatial axes a ``mean``;
    any other aten op is named after itself, and an op outside ``aten``
    (a custom op) is a ``custom`` op.

Ops are named ``{type}_{n}`` in execution order, so the ``linear`` ops
come out with the JAX package's names, in its order, on parameters whose
port names (``layer_0.attn.wq.kernel``) map one for one to the JAX key
strings (``aimet_tpu_torch.convert``). ``silu`` is traced as
``x * sigmoid(x)``, the form jax.nn.silu takes in a jaxpr, and
``log_softmax`` as jax.nn.log_softmax's max / sub / exp / sum / log / sub.
``split`` is one op whose value is its first piece, as JAX's ``split``
primitive.

Control flow (``graph/control_flow``: ``scan``, ``while_loop``, ``cond``)
traces to one node whose body is a sub-graph. Its body's nodes become
*inner ops* named under the enclosing op (``scan_0/linear_1``,
``cond_0/b1/tanh_0``), each with ``Op.scope`` naming that op; the
control-flow node itself is one ``scan`` / ``while`` / ``cond`` op. A
parameter read inside a body reaches it as one of the node's consts (or,
scanned over, as its xs), and ``_direct_param_leaf`` follows it back
across that boundary to the parameter. ``subgraph_eqns`` records, per
control-flow node, its kind and its inner ops. A conv or matmul in a
``while_loop`` condition raises ``NotImplementedError``, as in JAX.
"""
from __future__ import annotations

import dataclasses
import operator
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import fx
from torch.fx.experimental.proxy_tensor import make_fx
from torch.utils import _pytree as pytree

from . import control_flow

aten = torch.ops.aten

# Shape-only ops: never quantized, transparent for dataflow.
PASSTHROUGH = {
    aten.view, aten._unsafe_view, aten.reshape, aten.transpose,
    aten.permute, aten.t, aten.expand, aten.clone, aten._to_copy,
    aten.unsqueeze, aten.squeeze, aten.slice, aten.select, aten.alias,
    aten.detach, aten.lift_fresh_copy, aten.unbind, aten.constant_pad_nd,
    aten.flip,
}
_SPLIT = {aten.split, aten.split_with_sizes}
# Passthroughs that swap a parameter's axes on its way to a product.
TRANSPOSING = {aten.t, aten.transpose, aten.permute}
# Elementwise ops of affine chains, by the JAX primitive they stand for.
ELEMENTWISE = {
    aten.add: "add", aten.sub: "sub", aten.rsub: "sub", aten.mul: "mul",
    aten.div: "div", aten.maximum: "max", aten.clamp_min: "max",
    aten.minimum: "min", aten.clamp_max: "min",
}
# Single-op activations and reductions.
NAMED = {
    aten.relu: "relu", aten.sigmoid: "sigmoid", aten.tanh: "tanh",
    aten.exp: "exp", aten.gelu: "gelu", aten.silu: "silu",
    aten.hardtanh: "clip", aten._softmax: "softmax", aten.softmax: "softmax",
    aten.mean: "mean", aten.sum: "reduce_sum", aten.amax: "reduce_max",
    aten.amin: "reduce_min", aten.cat: "concat", aten.masked_fill: "select_n",
    aten.where: "select_n", aten.avg_pool2d: "avgpool",
}
_LINEAR = {aten.mm, aten.bmm, aten.addmm}


def _log_softmax(x, dim, half_to_float=False):
    """jax.nn.log_softmax's eqns: max (with initial -inf: a clip), sub,
    exp, sum, log, sub."""
    m = torch.clamp_min(torch.amax(x, dim, keepdim=True), float("-inf"))
    shifted = x - m
    return shifted - torch.log(torch.sum(torch.exp(shifted), dim,
                                         keepdim=True))


# silu and log_softmax as the jaxpr has them (jax.nn.silu = x *
# sigmoid(x)), so quantizers sit on the same tensors in both packages
_DECOMPOSITIONS = {aten.silu.default: lambda x: x * torch.sigmoid(x),
                   aten._log_softmax.default: _log_softmax}


def _packet(target):
    return getattr(target, "overloadpacket", target)


def _tensor_nodes(args) -> List[fx.Node]:
    out: List[fx.Node] = []
    fx.node.map_arg(args, lambda n: out.append(n))
    return out


@dataclasses.dataclass(eq=False)
class Product:
    """A tensor edge in the graph (an fx node's value)."""
    node: fx.Node
    name: str
    shape: Tuple[int, ...]
    dtype: Any
    kind: str                      # 'input' | 'param' | 'activation'
    param_path: Optional[str] = None
    producer: Optional["Op"] = None
    consumers: List["Op"] = dataclasses.field(default_factory=list)
    is_model_output: bool = False


@dataclasses.dataclass(eq=False)
class Op:
    """A module-level operation grouping one or more graph nodes; its value
    is the last node's."""
    index: int
    type: str
    name: str
    nodes: List[fx.Node]
    inputs: List[Product]
    output: Product
    param_products: Dict[str, Product] = dataclasses.field(
        default_factory=dict)
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    scope: Optional[str] = None     # the enclosing scan / while / cond op

    @property
    def input_ops(self) -> List["Op"]:
        """The ops producing this op's data inputs."""
        return [p.producer for p in self.inputs if p.producer is not None]

    @property
    def output_ops(self) -> List["Op"]:
        """The ops consuming this op's output."""
        return list(self.output.consumers)

    def __repr__(self):
        return f"Op({self.name}: {self.type})"


@dataclasses.dataclass(frozen=True)
class ConvDimensionNumbers:
    """The kernel's axes, as ``lax.ConvDimensionNumbers.rhs_spec`` orders
    them: (out channels, in channels, spatial...). An OIHW conv weight is
    (0, 1, 2, 3), a transposed conv's (I, O/g, kh, kw) weight (1, 0, 2,
    3)."""
    rhs_spec: Tuple[int, ...]


def _meta(node: fx.Node):
    v = node.meta.get("val")
    if isinstance(v, torch.Tensor):
        return tuple(v.shape), v.dtype
    return (), None


class ConnectedGraph:
    """Graph IR over ``model(*example_inputs)``. Parameters are named by
    their qualified module names; ``params`` (default: the model's own,
    detached) fixes which tensors are parameters and their order."""

    def __init__(self, model: torch.nn.Module, example_inputs,
                 params: Optional[Dict[str, torch.Tensor]] = None):
        if params is None:
            params = {k: v.detach() for k, v in model.named_parameters()}
        self.param_names: List[str] = list(params)
        flat_inputs, self._in_spec = pytree.tree_flatten(tuple(example_inputs))
        n_params = len(self.param_names)
        names = self.param_names
        spec = {}

        def fn(*flat):
            p = dict(zip(names, flat[:n_params]))
            inputs = pytree.tree_unflatten(list(flat[n_params:]),
                                           self._in_spec)
            out = torch.func.functional_call(model, p, inputs)
            leaves, spec["out"] = pytree.tree_flatten(out)
            return leaves

        with torch.no_grad():
            # tensors the model holds outside its parameters (a compressed
            # model's factored kernels) become constants of the graph
            self.gm = make_fx(fn, tracing_mode="fake",
                              decomposition_table=_DECOMPOSITIONS,
                              _allow_non_fake_inputs=True)(
                *params.values(), *flat_inputs)
        control_flow.outline(self.gm)
        self.gm.graph.eliminate_dead_code()
        self.out_spec = spec["out"]
        self.nodes: List[fx.Node] = list(self.gm.graph.nodes)
        placeholders = [n for n in self.nodes if n.op == "placeholder"]
        self.param_nodes: Dict[str, fx.Node] = dict(
            zip(names, placeholders[:n_params]))
        self.input_nodes: List[fx.Node] = placeholders[n_params:]
        self._param_leaf_index = {k: i for i, k in enumerate(names)}
        out_node = next(n for n in self.nodes if n.op == "output")
        self.output_nodes: List[fx.Node] = _tensor_nodes(out_node.args[0])

        self.products: Dict[fx.Node, Product] = {}
        for name, node in self.param_nodes.items():
            shape, dtype = _meta(node)
            self.products[node] = Product(node, name, shape, dtype, "param",
                                          param_path=name)
        for i, node in enumerate(self.input_nodes):
            shape, dtype = _meta(node)
            self.products[node] = Product(node, f"input{i + 1}", shape, dtype,
                                          "input")
        self._build()
        outs = {self.resolve(n) for n in self.output_nodes}
        for node, p in self.products.items():
            p.is_model_output = node in outs

    # ------------------------------------------------------------------
    def resolve(self, node):
        """Follow pass-through aliases to the semantic node."""
        while node in self.alias:
            node = self.alias[node]
        return node

    def resolve_var(self, node):
        """The JAX package's name for :meth:`resolve` (its graph's values
        are jaxpr vars, the port's fx nodes)."""
        return self.resolve(node)

    def _get_product(self, node: fx.Node) -> Product:
        node = self.resolve(node)
        if node not in self.products:
            shape, dtype = _meta(node)
            self.products[node] = Product(node, f"act_{len(self.products)}",
                                          shape, dtype, "activation")
        return self.products[node]

    def _is_param_only(self, v) -> bool:
        return not isinstance(v, fx.Node) or self._param_only[self.resolve(v)]

    def _direct_param_leaf(self, v) -> Tuple[Optional[Product], bool]:
        """If v is a chain of pass-through ops on one parameter, return
        (that parameter's Product, whether the chain swapped its axes)."""
        transposed = False
        for _ in range(8):
            if not isinstance(v, fx.Node):
                return None, False
            if v in self._invar_link:
                # a body placeholder: its value comes from the enclosing
                # control-flow node's operand
                v = self._invar_link[v]
                continue
            if v.op == "placeholder":
                p = self.products.get(v)
                return (p, transposed) if p is not None and \
                    p.kind == "param" else (None, False)
            if v.op != "call_function" or _packet(v.target) not in PASSTHROUGH:
                return None, False
            transposed ^= _packet(v.target) in TRANSPOSING
            v = v.args[0]
        return None, False

    def _new_op(self, op_type, nodes, data_in, out_node, counters,
                params=None, attrs=None) -> Op:
        n = counters.get(op_type, 0)
        counters[op_type] = n + 1
        inputs = [self._get_product(v) for v in data_in
                  if isinstance(v, fx.Node)]
        out_p = self._get_product(out_node)
        op = Op(index=len(self.ops), type=op_type,
                name=f"{self._prefix}{op_type}_{n}",
                nodes=list(nodes), inputs=inputs, output=out_p,
                param_products=params or {}, attrs=attrs or {},
                scope=self._scope_stack[-1] if self._scope_stack else None)
        out_p.producer = op
        out_p.name = f"{op.name}.out"
        for p in inputs:
            p.consumers.append(op)
        self.ops.append(op)
        for sink in self._sink_stack:
            sink.append(op)
        return op

    def _single_user(self, node: fx.Node) -> Optional[fx.Node]:
        users = [u for u in node.users if u not in self._consumed]
        return users[0] if len(users) == 1 and len(node.users) == 1 else None

    def _fold_bias(self, node: fx.Node, group: List[fx.Node],
                   params: Dict[str, Product]) -> fx.Node:
        """Fold a following ``add`` of a parameter (through single-user
        views) into the op; returns the op's output node."""
        chain, cur = [], node
        while True:
            nxt = self._single_user(cur)
            if nxt is None or nxt.op != "call_function":
                return node
            pk = _packet(nxt.target)
            if pk in (aten.view, aten._unsafe_view, aten.reshape):
                chain.append(nxt)
                cur = nxt
                continue
            if pk is not aten.add or len(nxt.args) != 2 or nxt.kwargs:
                return node
            other = nxt.args[1] if nxt.args[0] is cur else nxt.args[0]
            bp, _ = self._direct_param_leaf(other)
            if bp is None:
                return node
            params["bias"] = bp
            group.extend(chain + [nxt])
            self._consumed.update(chain + [nxt])
            return nxt

    # ------------------------------------------------------------------
    def _build(self):
        self.alias: Dict[fx.Node, fx.Node] = {}
        self.ops: List[Op] = []
        self._consumed: set = set()
        self._param_only: Dict[fx.Node, bool] = {}
        self._param_roots: Dict[fx.Node, set] = {}
        self._invar_link: Dict[fx.Node, fx.Node] = {}  # body ph -> operand
        self._scope_stack: List[str] = []
        self._sink_stack: List[List[Op]] = []
        self._prefix = ""
        # control-flow node -> {"kind", "inner_ops"} (the JAX package keys
        # it by eqn; here by fx node)
        self.subgraph_eqns: Dict[fx.Node, Dict[str, Any]] = {}
        names = {v: k for k, v in self.param_nodes.items()}
        for node in self.nodes:
            if node.op == "placeholder":
                name = names.get(node)
                self._param_only[node] = name is not None
                self._param_roots[node] = {name} if name else set()
        self._classify(self.nodes)
        self._build_scope(self.nodes, {})

    def _classify(self, nodes):
        """Classification prepass over one scope, recursing into bodies: it
        runs to completion before any building, because the peephole
        grouping (BN affine chains, bias folds) looks ahead at later nodes'
        operand classes."""
        for node in nodes:
            if node.op == "get_attr":
                self._param_only[node] = True
                self._param_roots[node] = set()
            elif node.op == "call_function":
                ins = _tensor_nodes((node.args, node.kwargs))
                self._param_only[node] = all(self._param_only[i] for i in ins)
                roots = set()
                for i in ins:
                    if self._param_only[i]:
                        roots |= self._param_roots[i]
                self._param_roots[node] = roots
                kind = control_flow.CONTROL_FLOW.get(node.target)
                if kind is not None and not self._param_only[node]:
                    self._seed_bodies(node, kind)

    def _cf_parts(self, node, kind):
        """[(body GraphModule, [(placeholder operand, forced data)], inner
        prefix suffix)] of a control-flow node, in building order."""
        def fetch(n):
            # a nested body's sub-graphs hang on its own module
            return getattr(n.graph.owning_module, n.target)

        if kind == "scan":
            body, init, xs, consts = node.args[:4]
            ops = [(v, True) for v in init] + [(v, False) for v in xs] + \
                [(v, False) for v in consts]
            return [(fetch(body), ops, "")]
        if kind == "while":
            cond_g, body_g, init, _cc, bc = node.args[:5]
            ops = [(v, True) for v in init] + [(v, False) for v in bc]
            return [(fetch(body_g), ops, "")]
        _pred, branches, operands, consts = node.args[:4]
        return [(fetch(b), [(v, False) for v in list(operands) + list(c)],
                 f"/b{i}") for i, (b, c) in enumerate(zip(branches, consts))]

    def _is_literal(self, v) -> bool:
        """A 0-dim constant computed from no parameter (``torch.zeros(())``,
        a lifted ``torch.tensor(0)``)."""
        v = self.resolve(v)
        return self._param_only[v] and not self._param_roots[v] and \
            v.op != "placeholder" and _meta(v)[0] == ()

    def _seed_bodies(self, node, kind):
        for body, operands, _ in self._cf_parts(node, kind):
            phs = [n for n in body.graph.nodes if n.op == "placeholder"]
            for ph, (v, as_data) in zip(phs, operands):
                if not isinstance(v, fx.Node):
                    self._param_only[ph] = True
                    self._param_roots[ph] = set()
                    continue
                self._invar_link[ph] = v
                if as_data and self._is_literal(v):
                    # a scalar constant carry (a loop counter) is the JAX
                    # graph's Literal: never data
                    self._param_only[ph] = True
                    self._param_roots[ph] = set()
                elif as_data:
                    self._param_only[ph] = False
                    self._param_roots[ph] = set()
                else:
                    self._param_only[ph] = self._param_only[self.resolve(v)]
                    self._param_roots[ph] = set(
                        self._param_roots[self.resolve(v)])
            self._classify(list(body.graph.nodes))

    def _build_scope(self, nodes, counters: Dict[str, int]):
        """Build the ops of one scope (the model's graph or a body's)."""
        for node in nodes:
            if node.op != "call_function" or node in self._consumed \
                    or self._param_only[node]:
                continue
            pk = _packet(node.target)
            kind = control_flow.CONTROL_FLOW.get(node.target)
            if kind is not None:
                self._control_flow(node, kind, counters)
                continue
            if node.target is operator.getitem and (
                    node.args[0].target in control_flow.CONTROL_FLOW
                    or _packet(node.args[0].target) in _SPLIT):
                continue      # each result of a loop or split: a product
            if pk in PASSTHROUGH or node.target is operator.getitem:
                self.alias[node] = node.args[0]
                continue
            if pk in _SPLIT:
                # one op valued by its first piece (JAX's split primitive);
                # the other pieces are products of their own
                first = [u for u in node.users
                         if u.target is operator.getitem and u.args[1] == 0]
                group = [node] + first[:1]
                self._consumed.update(first[:1])
                self._new_op("split", group, [node.args[0]], group[-1],
                             counters)
                continue
            if pk in _LINEAR:
                self._linear(node, pk, counters)
            elif pk is aten.convolution:
                self._conv(node, counters)
            elif pk is aten.max_pool2d_with_indices:
                # (values, indices): the op's value is item 0
                values = [u for u in node.users
                          if u.target is operator.getitem and u.args[1] == 0]
                group = [node] + values[:1]
                self._consumed.update(values[:1])
                self._new_op("maxpool", group, [node.args[0]], group[-1],
                             counters)
            elif pk in ELEMENTWISE:
                self._elementwise(node, pk, counters)
            elif pk in (aten.index, aten.embedding):
                table, idx = ((node.args[0], node.args[1][0])
                              if pk is aten.index else node.args[:2])
                kp, _ = self._direct_param_leaf(table)
                if kp is not None:
                    self._new_op("embedding", [node], [idx], node, counters,
                                 {"kernel": kp})
                else:
                    self._new_op("gather", [node],
                                 _tensor_nodes(node.args), node, counters)
            else:
                op_type = NAMED.get(pk)
                attrs = {}
                if op_type is None:
                    op_type = pk.__name__.split(".")[-1]
                    if pk is aten.pow and node.args[1] == 2:
                        op_type = "square"
                    elif not getattr(pk, "_qualified_op_name",
                                     "").startswith("aten::"):
                        # a custom op no rule classifies (the JAX graph's
                        # opaque custom_jvp_call)
                        op_type = "custom"
                elif op_type == "mean":
                    nd = len(_meta(node.args[0])[0])
                    dims = node.args[1] if len(node.args) > 1 else \
                        range(nd)
                    attrs["axes"] = tuple(sorted(int(d) % nd for d in dims))
                elif op_type == "concat":
                    nd = len(_meta(node)[0])
                    dim = node.args[1] if len(node.args) > 1 else \
                        node.kwargs.get("dim", 0)
                    attrs["dimension"] = int(dim) % nd
                self._new_op(op_type, [node],
                             _tensor_nodes((node.args, node.kwargs)), node,
                             counters, attrs=attrs)

    def _control_flow(self, node, kind, counters):
        """One scan / while / cond op, after the inner ops of its body
        (each branch of a cond under ``{name}/b{i}``)."""
        op_name = f"{self._prefix}{kind}_{counters.get(kind, 0)}"
        inner: List[Op] = []
        for body, _, suffix in self._cf_parts(node, kind):
            scope = op_name + suffix
            saved = self._prefix
            self._scope_stack.append(scope)
            self._sink_stack.append(inner)
            self._prefix = scope + "/"
            try:
                self._build_scope(list(body.graph.nodes), {})
            finally:
                self._prefix = saved
                self._sink_stack.pop()
                self._scope_stack.pop()
        self.subgraph_eqns[node] = {"kind": kind, "inner_ops": inner}
        if kind == "scan":
            data = list(node.args[1]) + list(node.args[2]) + \
                list(node.args[3])
            primary = len(node.args[1])
            attrs = {"num_consts": len(node.args[3]),
                     "num_carry": len(node.args[1]),
                     "length": int(_meta(node.args[2][0])[0][0]),
                     "reverse": bool(node.kwargs.get("reverse", False))}
        elif kind == "while":
            data, primary = list(node.args[2]), 0
            attrs = {"cond_nconsts": len(node.args[3]),
                     "body_nconsts": len(node.args[4])}
        else:
            data, primary, attrs = list(node.args[2]), 0, {}
        data = [v for v in data if isinstance(v, fx.Node)
                and not self._is_param_only(v)]
        items = {u.args[1]: u for u in node.users
                 if u.target is operator.getitem}
        out = items.get(primary, node)
        self._new_op(kind, [node], data, out, counters, attrs=attrs)

    def _linear(self, node, pk, counters):
        if pk is aten.addmm:
            bias_v, lhs, rhs = node.args[:3]
        else:
            bias_v, (lhs, rhs) = None, node.args[:2]
        kp, transposed = self._direct_param_leaf(rhs)
        params: Dict[str, Product] = {}
        group = [node]
        if kp is not None and not self._is_param_only(lhs):
            params["kernel"] = kp
            op_type, data_in = "linear", [lhs]
            if bias_v is not None:
                bp, _ = self._direct_param_leaf(bias_v)
                if bp is not None:
                    params["bias"] = bp
            out = self._fold_bias(node, group, params) \
                if "bias" not in params else node
        else:
            op_type, data_in, out = "matmul", [lhs, rhs], node
        self._new_op(op_type, group, data_in, out, counters, params,
                     {"kernel_transposed": transposed, "x_node": lhs})

    def _conv(self, node, counters):
        x, w, b = node.args[:3]
        transposed, groups = node.args[6], node.args[8]
        params: Dict[str, Product] = {}
        kp, _ = self._direct_param_leaf(w)
        if kp is not None:
            params["kernel"] = kp
        group = [node]
        out = node
        if isinstance(b, fx.Node):
            bp, _ = self._direct_param_leaf(b)
            if bp is not None:
                params["bias"] = bp
        else:
            out = self._fold_bias(node, group, params)
        op_type = ("conv_transpose" if transposed else
                   "depthwise_conv" if groups > 1 else "conv")
        self._new_op(op_type, group, [x], out, counters, params,
                     {"transposed": transposed, "x_node": x,
                      "window_strides": tuple(int(v) for v in node.args[3]),
                      "padding": self._conv_padding(x, node.args[4]),
                      "dimension_numbers": ConvDimensionNumbers(
                          (1, 0, 2, 3) if transposed else (0, 1, 2, 3))})

    def _conv_padding(self, x, padding) -> Tuple[Tuple[int, int], ...]:
        """((low, high) a spatial axis): the convolution's own padding
        plus a ``constant_pad_nd`` of its input (through views), where a
        flax-"SAME" conv pads its two sides unequally."""
        pads = [[int(p), int(p)] for p in padding]
        while isinstance(x, fx.Node) and x.op == "call_function" \
                and _packet(x.target) in PASSTHROUGH:
            if _packet(x.target) is aten.constant_pad_nd:
                flat = list(x.args[1])     # last axis first, (low, high)
                for i in range(min(len(flat) // 2, len(pads))):
                    pads[-1 - i][0] += int(flat[2 * i])
                    pads[-1 - i][1] += int(flat[2 * i + 1])
                break
            x = x.args[0]
        return tuple((a, b) for a, b in pads)

    def _elementwise(self, node, pk, counters):
        a = node.args[0]
        b = node.args[1] if len(node.args) > 1 else None
        a_p, b_p = self._is_param_only(a), self._is_param_only(b)
        prim = ELEMENTWISE[pk]
        if a_p ^ b_p:
            # mixed data / (param | literal): an affine chain (BN-like)
            group, out = [node], node
            roots = set()
            for v in _tensor_nodes(node.args):
                if self._is_param_only(v):
                    roots |= self._param_roots[self.resolve(v)]
            while True:
                nxt = self._single_user(out)
                if nxt is None or nxt.op != "call_function" or \
                        _packet(nxt.target) not in ELEMENTWISE or \
                        len(nxt.args) < 2:
                    break
                na_p = self._is_param_only(nxt.args[0])
                nb_p = self._is_param_only(nxt.args[1])
                if not (na_p ^ nb_p):
                    break
                group.append(nxt)
                self._consumed.add(nxt)
                for v in _tensor_nodes(nxt.args):
                    if self._is_param_only(v):
                        roots |= self._param_roots[self.resolve(v)]
                out = nxt
            lit = a if a_p else b
            is_lit = not isinstance(lit, fx.Node)
            if len(group) >= 2 and roots:
                op_type = "batchnorm"
            elif prim == "max" and is_lit and lit == 0:
                op_type = "relu"
            elif prim in ("min", "max") and is_lit and not roots:
                op_type = "clip"
            else:
                op_type = "scale"
            params = {f"p{i}": self.products[self.param_nodes[r]]
                      for i, r in enumerate(sorted(roots))}
            self._new_op(op_type, group, [b if a_p else a], out, counters,
                         params, {"param_roots": sorted(roots)})
            return
        op_type = prim
        if prim == "max" and any(not isinstance(v, fx.Node) and v == 0
                                 for v in (a, b)):
            op_type = "relu"
        self._new_op(op_type, [node], _tensor_nodes(node.args), node,
                     counters)

    # ------------------------------------------------------------------
    def get_op(self, name: str) -> Op:
        for op in self.ops:
            if op.name == name:
                return op
        raise KeyError(name)

    def ops_of_type(self, op_type: str) -> List[Op]:
        return [op for op in self.ops if op.type == op_type]

    def downstream_op(self, op: Op) -> Optional[Op]:
        """The unique consumer of op's output, or None."""
        cons = op.output.consumers
        return cons[0] if len(cons) == 1 else None

    def __repr__(self):
        lines = [f"ConnectedGraph({len(self.ops)} ops)"]
        for op in self.ops:
            ins = ", ".join(p.name for p in op.inputs)
            ps = ", ".join(f"{k}={p.param_path}"
                           for k, p in op.param_products.items())
            lines.append(f"  {op.name}({ins}{'; ' + ps if ps else ''}) -> "
                         f"{op.output.name}")
        return "\n".join(lines)
