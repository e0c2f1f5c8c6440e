"""Structured control flow — the port's counterpart of ``lax.scan``,
``lax.while_loop`` and ``lax.cond``.

A model written with these helpers runs as a plain Python loop (or branch)
when it is called, and shows up as ONE node of the traced graph with its
body as a sub-graph (a ``GraphModule`` child of the traced module) when
``ConnectedGraph`` traces it. The quantsim runs those bodies step by step
with its observers and fake-quant inside (``graph/interpreter.run_graph``).

Tracing: under ``make_fx`` each helper records its body once, inline,
between two marker ops (``aimet_cf::begin`` hands the body fresh values
shaped like one step's carry and inputs; ``aimet_cf::end`` takes the
body's results and stands for the loop's). ``outline`` then moves each
marked region into a sub-graph and puts one call of ``scan_call`` /
``while_call`` / ``cond_call`` in its place, whose arguments are the
sub-graphs, the loop's inputs and the outer values the body reads (the
parameters, as JAX's scan consts). PyTorch's own higher-order ops are not
used: their tracing differs between PyTorch releases (some trace the body
through ``torch.compile``), and outside a trace they compile.

Semantics follow JAX:

  - ``scan(fn, init, xs, reverse=False)``: ``fn(carry, x) -> (carry, y)``;
    returns ``(carry, ys)`` with the ys stacked on a new leading axis;
    ``reverse`` walks xs from the end and stores each y at its own step;
  - ``while_loop(cond_fn, body_fn, init_val)``: ``body_fn(val) -> val``
    while ``cond_fn(val)``; ``val`` a pytree of tensors (a counter as a
    0-dim tensor);
  - ``cond(pred, true_fn, false_fn, *operands)``: two branches; JAX lists
    them (false, true), and so do the sub-graphs here (``b0`` the false
    branch). ``lax.switch`` over more branches is written as nested
    ``cond``\\ s.
"""
from __future__ import annotations

import operator
from typing import Callable, Dict, List, Sequence

import torch
from torch import fx
from torch.utils import _pytree as pytree

_TAG = 0


def _tracing() -> bool:
    """True while ``make_fx`` traces (a proxy dispatch mode is active)."""
    from torch.fx.experimental.proxy_tensor import get_proxy_mode
    return get_proxy_mode() is not None


# -- the marker ops (traced only; their eager versions keep shapes) --------
@torch.library.custom_op("aimet_cf::begin", mutates_args=())
def _begin(tag: int, carry: List[torch.Tensor], xs: List[torch.Tensor]
           ) -> List[torch.Tensor]:
    return [c.clone() for c in carry] + [x[0].clone() for x in xs]


@_begin.register_fake
def _(tag, carry, xs):
    return [torch.empty_like(c) for c in carry] + \
        [torch.empty_like(x[0]) for x in xs]


@torch.library.custom_op("aimet_cf::end", mutates_args=())
def _end(tag: int, kind: int, carry: List[torch.Tensor],
         ys: List[torch.Tensor], length: int) -> List[torch.Tensor]:
    return [c.clone() for c in carry] + \
        [y.unsqueeze(0).repeat(length, *([1] * y.dim())) for y in ys]


@_end.register_fake
def _(tag, kind, carry, ys, length):
    return [torch.empty_like(c) for c in carry] + \
        [y.new_empty((length,) + tuple(y.shape)) for y in ys]


# kinds of an end marker
_SCAN, _SCAN_REVERSE, _WHILE, _COND = range(4)


def _new_tag() -> int:
    global _TAG
    _TAG += 1
    return _TAG


# -- the helpers ------------------------------------------------------------
def scan(fn: Callable, init, xs, reverse: bool = False):
    """``lax.scan``: ``fn(carry, x) -> (carry, y)`` over the leading axis of
    ``xs``; returns the last carry and the stacked ys."""
    c_leaves, c_spec = pytree.tree_flatten(init)
    x_leaves, x_spec = pytree.tree_flatten(xs)
    length = x_leaves[0].shape[0]
    if _tracing():
        tag = _new_tag()
        vals = _begin(tag, c_leaves, x_leaves)
        carry = pytree.tree_unflatten(vals[:len(c_leaves)], c_spec)
        x = pytree.tree_unflatten(vals[len(c_leaves):], x_spec)
        carry, y = fn(carry, x)
        # a None y (JAX's empty pytree) stacks to None
        y_leaves, y_spec = pytree.tree_flatten(y) if y is not None \
            else ([], None)
        outs = _end(tag, _SCAN_REVERSE if reverse else _SCAN,
                    pytree.tree_leaves(carry), y_leaves, length)
        n = len(c_leaves)
        return (pytree.tree_unflatten(outs[:n], c_spec),
                None if y is None else pytree.tree_unflatten(outs[n:],
                                                             y_spec))
    steps = range(length - 1, -1, -1) if reverse else range(length)
    carry, ys = init, []
    for t in steps:
        carry, y = fn(carry, pytree.tree_map(lambda a: a[t], xs))
        ys.append(y)
    if reverse:
        ys.reverse()
    if ys[0] is None:
        return carry, None
    return carry, pytree.tree_map(lambda *a: torch.stack(a), *ys)


def while_loop(cond_fn: Callable, body_fn: Callable, init_val):
    """``lax.while_loop``: apply ``body_fn`` to ``init_val`` while
    ``cond_fn`` holds; ``init_val`` is a pytree of tensors."""
    if _tracing():
        leaves, spec = pytree.tree_flatten(init_val)
        tag = _new_tag()
        pred = cond_fn(pytree.tree_unflatten(_begin(tag, leaves, []), spec))
        out = pytree.tree_leaves(
            body_fn(pytree.tree_unflatten(_begin(tag, leaves, []), spec)))
        res = _end(tag, _WHILE, [torch.as_tensor(pred)] + out, [], 0)
        return pytree.tree_unflatten(res[1:], spec)
    val = init_val
    while bool(cond_fn(val)):
        val = body_fn(val)
    return val


def cond(pred, true_fn: Callable, false_fn: Callable, *operands):
    """``lax.cond`` with two branches: ``true_fn(*operands)`` if ``pred``
    else ``false_fn(*operands)``; both return the same structure."""
    if _tracing():
        leaves, spec = pytree.tree_flatten(tuple(operands))
        tag = _new_tag()
        outs = []
        for fn in (false_fn, true_fn):
            vals = _begin(tag, leaves, [])
            o_leaves, out_spec = pytree.tree_flatten(
                fn(*pytree.tree_unflatten(vals, spec)))
            outs.append(o_leaves)
        res = _end(tag, _COND, [torch.as_tensor(pred)] + outs[0] + outs[1],
                   [], 0)
        return pytree.tree_unflatten(res[1:1 + len(outs[0])], out_spec)
    return true_fn(*operands) if bool(pred) else false_fn(*operands)


# -- the outlined nodes: what a traced graph calls -------------------------
def scan_call(body, init: Sequence[torch.Tensor], xs: Sequence[torch.Tensor],
              consts: Sequence[torch.Tensor], reverse: bool = False):
    """One outlined scan: ``body(*carry, *x_t, *consts) -> [*carry, *y]``;
    returns ``[*carry, *ys]``."""
    n = len(init)
    length = xs[0].shape[0]
    steps = range(length - 1, -1, -1) if reverse else range(length)
    carry, ys = list(init), []
    for t in steps:
        out = body(*carry, *[x[t] for x in xs], *consts)
        carry, y = list(out[:n]), out[n:]
        ys.append(y)
    if reverse:
        ys.reverse()
    return carry + [torch.stack(col) for col in zip(*ys)]


def while_call(cond_graph, body_graph, init: Sequence[torch.Tensor],
               cond_consts: Sequence[torch.Tensor],
               body_consts: Sequence[torch.Tensor]):
    """One outlined while loop over the carry ``init``."""
    carry = list(init)
    while bool(cond_graph(*carry, *cond_consts)[0]):
        carry = list(body_graph(*carry, *body_consts))
    return carry


def cond_call(pred, branches, operands: Sequence[torch.Tensor],
              consts: Sequence[Sequence[torch.Tensor]]):
    """One outlined cond: ``branches[int(pred)]`` (b0 false, b1 true)."""
    i = int(bool(pred))
    return list(branches[i](*operands, *consts[i]))


CONTROL_FLOW = {scan_call: "scan", while_call: "while", cond_call: "cond"}


# -- outlining ----------------------------------------------------------------
_QUANTIZABLE = {torch.ops.aten.mm, torch.ops.aten.bmm, torch.ops.aten.addmm,
                torch.ops.aten.convolution, torch.ops.aten.matmul}


def _is(node: fx.Node, op) -> bool:
    return node.op == "call_function" and node.target is op


def _items(node: fx.Node) -> Dict[int, fx.Node]:
    """The getitem users of a list-valued node, by index."""
    return {u.args[1]: u for u in node.users
            if u.op == "call_function" and u.target is operator.getitem}


class _Region:
    """The nodes between a begin marker and the values ``outs``: ``phs``
    (the marker's items: the body's placeholders), ``body`` (what the outs
    need of the nodes depending on them, in graph order), ``outer`` (the
    outer values the body reads: its consts) and ``dep`` (every node
    depending on the marker but the construct's own end)."""

    def __init__(self, begin: fx.Node, end: fx.Node, outs, order):
        items = _items(begin)
        self.begin = begin
        self.phs = [items[i] for i in sorted(items)]
        self.dep, stack = set(self.phs), list(self.phs)
        while stack:
            for u in stack.pop().users:
                if u is not end and u not in self.dep:
                    self.dep.add(u)
                    stack.append(u)
        need, stack = set(), list(outs)
        while stack:
            n = stack.pop()
            if n in need or n in self.phs or n not in self.dep:
                continue
            need.add(n)
            stack.extend(n.all_input_nodes)
        self.body = sorted(need, key=order.get)
        self.outer, seen = [], set(self.phs) | need
        # what the body reads from outside, then any output that is an
        # outer value itself
        for a in [a for n in self.body for a in n.all_input_nodes] + \
                list(outs):
            if a not in seen:
                seen.add(a)
                self.outer.append(a)
        self.outs = list(outs)

    def graph_module(self, root: fx.GraphModule) -> fx.GraphModule:
        g = fx.Graph()
        env: Dict[fx.Node, fx.Node] = {}
        for i, n in enumerate(self.phs + self.outer):
            env[n] = g.placeholder(f"arg{i}")
            env[n].meta = dict(n.meta)
        for n in self.body:
            env[n] = g.node_copy(n, lambda a: env[a])
        g.output([env[o] for o in self.outs])
        return fx.GraphModule(root, g)


def outline(gm: fx.GraphModule) -> fx.GraphModule:
    """Move every marked control-flow region of a traced graph into a
    sub-graph, with one ``scan_call`` / ``while_call`` / ``cond_call`` node
    in its place (outermost construct first; nested ones are outlined
    inside their parent's sub-graph)."""
    graph = gm.graph
    begin_op = torch.ops.aimet_cf.begin.default
    end_op = torch.ops.aimet_cf.end.default

    def attach(prefix, region):
        i = 0
        while hasattr(gm, f"{prefix}_{i}"):
            i += 1
        gm.add_submodule(f"{prefix}_{i}", region.graph_module(gm))
        return graph.get_attr(f"{prefix}_{i}")

    while True:
        nodes = list(graph.nodes)
        order = {n: i for i, n in enumerate(nodes)}
        begins = [n for n in nodes if _is(n, begin_op)]
        if not begins:
            break
        tag = begins[0].args[0]          # the outermost construct
        bs = [n for n in begins if n.args[0] == tag]
        end = next(n for n in nodes if _is(n, end_op) and n.args[0] == tag)
        kind, vals = end.args[1], list(end.args[2])
        with graph.inserting_before(end):
            if kind in (_SCAN, _SCAN_REVERSE):
                r = _Region(bs[0], end, vals + list(end.args[3]), order)
                call = graph.call_function(
                    scan_call, (attach("scan_body", r), list(bs[0].args[1]),
                                list(bs[0].args[2]), tuple(r.outer)),
                    {"reverse": kind == _SCAN_REVERSE})
                regions, shift, count = [r], 0, len(end.meta["val"])
            elif kind == _WHILE:
                rc = _Region(bs[0], end, vals[:1], order)
                rb = _Region(bs[1], end, vals[1:], order)
                for n in rc.body:
                    if getattr(n.target, "overloadpacket", None) \
                            in _QUANTIZABLE:
                        raise NotImplementedError(
                            "quantsim: a while_loop *condition* contains a "
                            "conv / matmul — quantizer interception inside "
                            "while conditions is not supported; move the "
                            "compute into the body")
                call = graph.call_function(
                    while_call, (attach("while_cond", rc),
                                 attach("while_body", rb),
                                 list(bs[0].args[1]), tuple(rc.outer),
                                 tuple(rb.outer)))
                regions, shift, count = [rc, rb], 1, len(vals) - 1
            else:
                n = (len(vals) - 1) // 2
                rf = _Region(bs[0], end, vals[1:1 + n], order)
                rt = _Region(bs[1], end, vals[1 + n:], order)
                call = graph.call_function(
                    cond_call, (vals[0], [attach("cond_false", rf),
                                          attach("cond_true", rt)],
                                list(bs[0].args[1]),
                                [tuple(rf.outer), tuple(rt.outer)]))
                regions, shift, count = [rf, rt], 1, n
        call.meta = {"val": list(end.meta["val"])[shift:shift + count]}
        for i, g in _items(end).items():
            if not shift <= i < shift + count:
                continue
            with graph.inserting_before(g):
                ng = graph.call_function(operator.getitem, (call, i - shift))
            ng.meta = dict(g.meta)
            g.replace_all_uses_with(ng)
        # erase the end marker, then each region (users before producers)
        dead = {end} | set(_items(end).values())
        for r in regions:
            dead |= r.dep | {r.begin}
        for n in reversed(list(graph.nodes)):
            if n in dead:
                if n.users:
                    bad = [u for u in n.users if u not in dead]
                    if bad:
                        raise ValueError(
                            f"a value computed inside a control-flow body "
                            f"({n.name}) is read outside it ({bad[0].name})")
                graph.erase_node(n)
    graph.lint()
    gm.recompile()
    for _, child in list(gm.named_children()):
        if isinstance(child, fx.GraphModule) and any(
                _is(n, begin_op) for n in child.graph.nodes):
            outline(child)
    return gm
