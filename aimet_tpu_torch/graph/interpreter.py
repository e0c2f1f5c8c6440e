"""Graph evaluation with hooks and op replacement — counterpart of
``aimet_tpu/graph/interpreter.py``.

``run_graph`` executes the traced aten graph node by node, frees each
value after its last use, and lets a caller rewrite a node's operands or
result (the quantsim's observers and fake-quant) or compute a node's value
in its place (an op replaced by an integer kernel). A ``scan`` / ``while``
/ ``cond`` node runs its body step by step in a Python loop, with the same
hooks on the body's nodes (the JAX package threads its observer states
through one fused ``lax.scan``; the port's observers live in a dict the
hooks update, so a plain loop carries them).
``evaluate_with_replacements`` runs each replaced op's function on the
op's data input in place of its nodes, as the JAX package's interpreter
does with an op's eqns. ``OpReplay`` runs one op's own nodes alone, from
its data input and the parameters (the algorithms' per-layer forward and
the batchnorm probes).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional

from torch import fx
from torch.utils import _pytree as pytree

from .._device import no_tf32
from .connected_graph import ConnectedGraph, Op
from .control_flow import CONTROL_FLOW

# node -> fn(read) computing its value in place of running it; None: skip
Emit = Dict[fx.Node, Optional[Callable[[Callable], Any]]]


def _fetch_attr(gm, target: str):
    obj = gm
    for part in target.split("."):
        obj = getattr(obj, part)
    return obj


def _last_uses(nodes: List[fx.Node], extra: Dict[fx.Node, Iterable[fx.Node]]
               ) -> Dict[fx.Node, List[fx.Node]]:
    last: Dict[fx.Node, fx.Node] = {}
    for node in nodes:
        for inp in node.all_input_nodes:
            last[inp] = node
        for inp in extra.get(node, ()):
            last[inp] = node
    out: Dict[fx.Node, List[fx.Node]] = {}
    for value, user in last.items():
        out.setdefault(user, []).append(value)
    return out


def run_graph(graph: ConnectedGraph, flat_args, *,
              before: Optional[Callable] = None,
              after: Optional[Callable] = None,
              at_output: Optional[Callable] = None,
              emit: Optional[Emit] = None,
              emit_reads: Optional[Dict[fx.Node, List[fx.Node]]] = None,
              enter: Optional[Callable] = None):
    """Execute the graph on ``flat_args`` (parameters, then the flattened
    inputs) and return the model's output structure.

    ``before(node, read)`` may return the (args, kwargs) a call runs with;
    ``after(node, value)`` may replace a placeholder's or a call's value;
    ``at_output(node, value)`` may replace a model output; ``emit`` maps a
    node to ``fn(read)`` computing its value in place of running it (None:
    skipped), ``emit_reads`` names the nodes such a function reads. A
    control-flow node (``scan`` / ``while`` / ``cond``) runs its body step
    by step with the same ``before`` / ``after`` hooks on the body's nodes
    (a plain Python loop), unless ``enter(node)`` returns False: then the
    body runs without hooks. f32 convolutions run in f32 (TF32 off,
    ``_device.no_tf32``)."""
    with no_tf32():
        runner = _Runner(graph, before, after, enter)
        env: Dict[fx.Node, Any] = {}
        args = iter(flat_args)
        for node in graph.nodes:
            if node.op == "placeholder":
                val = next(args)
                env[node] = after(node, val) if after is not None else val
        runner.exec(graph.nodes, env, emit or {},
                    _last_uses(graph.nodes, emit_reads or {}))
        outs = [at_output(n, env[n]) if at_output else env[n]
                for n in graph.output_nodes]
        return pytree.tree_unflatten(outs, graph.out_spec)


class _Runner:
    """Executes node lists; control-flow nodes run their sub-graphs."""

    def __init__(self, graph, before, after, enter):
        self.graph, self.before, self.after = graph, before, after
        self.enter = enter
        # sub-graph -> (nodes, placeholders, outputs, last uses)
        self._plans: Dict[fx.GraphModule, tuple] = {}

    def exec(self, nodes, env, emit, dead):
        read = env.__getitem__
        before, after = self.before, self.after
        for node in nodes:
            op = node.op
            if op == "placeholder" or op == "output":
                continue
            if op == "get_attr":
                # a sub-graph's attributes live on its own module
                val = _fetch_attr(node.graph.owning_module or self.graph.gm,
                                  node.target)
            elif node in emit:
                fn = emit[node]
                if fn is None:
                    continue
                val = fn(read)
            else:
                call = before(node, read) if before is not None else None
                a, kw = call if call is not None else fx.node.map_arg(
                    (node.args, node.kwargs), read)
                if node.target in CONTROL_FLOW and (self.enter is None
                                                    or self.enter(node)):
                    # the loop runs its sub-graphs through the hooks
                    a = pytree.tree_map(self._hooked, a)
                val = node.target(*a, **kw)
            if after is not None:
                val = after(node, val)
            env[node] = val
            for v in dead.get(node, ()):
                env.pop(v, None)

    def _hooked(self, v):
        """A sub-graph as a function that runs its nodes with the hooks."""
        if not isinstance(v, fx.GraphModule):
            return v
        return lambda *args: self.body(v, args)

    def body(self, gm: fx.GraphModule, args):
        """One run of a sub-graph with the hooks: its output list."""
        plan = self._plans.get(gm)
        if plan is None:
            nodes = list(gm.graph.nodes)
            plan = self._plans[gm] = (
                nodes, [n for n in nodes if n.op == "placeholder"],
                next(n for n in reversed(nodes) if n.op == "output").args[0],
                _last_uses(nodes, {}))
        nodes, phs, outs, dead = plan
        env = dict(zip(phs, args))
        self.exec(nodes, env, {}, dead)
        return [env[n] if isinstance(n, fx.Node) else n for n in outs]


def flat_args(graph: ConnectedGraph, params: Dict[str, Any], args) -> list:
    """Parameters in the traced order, then the flattened inputs."""
    return [params[k] for k in graph.param_names] + \
        pytree.tree_flatten(tuple(args))[0]


def _as_shape(out, shape):
    return out.reshape(shape) if out.numel() == math.prod(shape) else out


def evaluate_with_replacements(graph: ConnectedGraph, params, args,
                               replacements: Optional[Dict[str, Callable]]
                               = None, out_tree=None):
    """Evaluate the graph; each op in ``replacements`` has its nodes skipped
    and its value set to ``replacement(x)``, x being the op's data operand
    as its first node reads it (after any dtype cast and view), reshaped to
    the op's traced output shape where it has as many elements (a
    compression replacement's output may have lost channels). A
    replacement with ``_nary`` set is called as
    ``replacement(*inputs, read=read)`` on the values of all the op's data
    input products. ``out_tree`` (a ``torch.utils._pytree`` spec)
    regroups the output leaves; by default they keep the model's own
    structure."""
    emit: Emit = {}
    reads: Dict[fx.Node, List[fx.Node]] = {}
    for name, fn in (replacements or {}).items():
        op = graph.get_op(name)
        last = op.nodes[-1]
        for n in op.nodes[:-1]:
            emit[n] = None
        if getattr(fn, "_nary", False):
            # fn(*inputs, read=read): every data input product's value
            # (and the graph's values, for what else the op reads); the
            # op's shape may change (a winnowed channel count)
            ins = [p.node for p in op.inputs]
            emit[last] = (lambda read, fn=fn, ins=ins:
                          fn(*[read(n) for n in ins], read=read))
            reads[last] = ins + [a for n in op.nodes
                                 for a in n.all_input_nodes]
            continue
        x_node = op.attrs.get("x_node", op.inputs[0].node)
        emit[last] = (lambda read, fn=fn, x_node=x_node,
                      shape=tuple(last.meta["val"].shape):
                      _as_shape(fn(read(x_node)), shape))
        reads[last] = [x_node]
    out = run_graph(graph, flat_args(graph, params, args), emit=emit,
                    emit_reads=reads)
    if out_tree is not None:
        out = pytree.tree_unflatten(pytree.tree_leaves(out), out_tree)
    return out


class OpReplay:
    """One op's value from its data input and the parameters: the op's own
    nodes and the weight preprocessing they read, replayed in graph order
    from ``source`` (default: the op's first data input product, which
    pass-through aliases may put before a view or a pad, so the replay
    includes them: a flax-"SAME" conv's ``constant_pad_nd`` runs here as
    in the model). f32 convolutions run in f32 (TF32 off). Autograd flows
    through the replay, so it serves as a differentiable layer forward."""

    def __init__(self, graph: ConnectedGraph, op: Op,
                 source: Optional[fx.Node] = None):
        self.graph, self.op = graph, op
        self.source = op.inputs[0].node if source is None else source
        self.out = op.output.node
        needed, stack = set(), [self.out]
        while stack:
            n = stack.pop()
            if n in needed or n is self.source:
                continue
            needed.add(n)
            stack.extend(n.all_input_nodes)
        self.nodes = [n for n in graph.nodes if n in needed]
        names = {v: k for k, v in graph.param_nodes.items()}
        self.params = {}
        for n in self.nodes:
            if n.op == "placeholder":
                if n not in names:
                    raise ValueError(f"{op.name} reads the model input "
                                     f"{n.name} besides its source")
                self.params[n] = names[n]

    def __call__(self, x, params: Mapping[str, Any]):
        """The op's value with ``x`` at the source and ``params`` (by name;
        only the parameters the op reads are looked up)."""
        env: Dict[fx.Node, Any] = {self.source: x}
        with no_tf32():
            for n in self.nodes:
                if n.op == "placeholder":
                    env[n] = params[self.params[n]]
                elif n.op == "get_attr":
                    env[n] = _fetch_attr(self.graph.gm, n.target)
                else:
                    a, kw = fx.node.map_arg((n.args, n.kwargs),
                                            env.__getitem__)
                    env[n] = n.target(*a, **kw)
        return env[self.out]
