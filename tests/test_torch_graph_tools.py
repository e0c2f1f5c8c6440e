"""The tools that sit on the connected graph — ``graph/pattern_matcher``,
``algorithms/arch_checker`` (ArchChecker, ModelValidator) and the graph's
``Op.input_ops`` / ``output_ops`` / ``ConnectedGraph.downstream_op`` and
conv attributes — in aimet_tpu_torch against the JAX package, on the
models of tests/test_pattern_matcher.py and tests/test_utils_aux.py (flax
in the JAX package, their NCHW copies with the flax module names here,
weights drawn with numpy and carried across).

Everything here is structural, so every comparison is exact: the same
bindings (op names) for every pattern, the same findings (check, op,
severity, structure) in the same order, the same validator verdicts, the
same neighbours, padding, strides and channel counts. The port's graph
names ops as the JAX graph does on these models (convs, batchnorms,
relus, adds, concats; silu as sigmoid + mul in both).
"""
import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.nn import functional as F

from aimet_tpu.algorithms import arch_checker as jac
from aimet_tpu.graph import pattern_matcher as jpm
from aimet_tpu.graph.connected_graph import ConnectedGraph as JaxGraph
from aimet_tpu_torch import convert
from aimet_tpu_torch.algorithms import arch_checker as tac
from aimet_tpu_torch.graph import pattern_matcher as tpm
from aimet_tpu_torch.graph.connected_graph import ConnectedGraph
from aimet_tpu_torch.models.layers import BatchNorm, Conv
from torch_ptq_util import init_variables, nchw, pair


# ---------------------------------------------------------------------------
# models: flax and the port, same module names
# ---------------------------------------------------------------------------

class JaxResidualNet(nn.Module):
    """tests/test_pattern_matcher.py's ResidualNet."""
    @nn.compact
    def __call__(self, x):
        x = nn.Conv(8, (3, 3), padding="SAME")(x)
        y = nn.Conv(8, (3, 3), padding="SAME")(x)
        y = nn.BatchNorm(use_running_average=True)(y)
        y = nn.relu(y)
        y = nn.Conv(8, (3, 3), padding="SAME")(y)
        x = nn.relu(x + y)
        y2 = nn.Conv(8, (3, 3), padding="SAME")(x)
        y2 = nn.BatchNorm(use_running_average=True)(y2)
        y2 = nn.relu(y2)
        y2 = nn.Conv(8, (3, 3), padding="SAME")(y2)
        return nn.relu(x + y2)


class ResidualNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        for i, cin in enumerate((3, 8, 8, 8, 8)):
            setattr(self, f"Conv_{i}", Conv(cin, 8, (3, 3), use_bias=True))
        self.BatchNorm_0, self.BatchNorm_1 = BatchNorm(8), BatchNorm(8)

    def forward(self, x):
        x = self.Conv_0(x)
        y = self.Conv_2(torch.relu(self.BatchNorm_0(self.Conv_1(x))))
        x = torch.relu(x + y)
        y2 = self.Conv_4(torch.relu(self.BatchNorm_1(self.Conv_3(x))))
        return torch.relu(x + y2)


def _two_convs(c1, c2, act, k=(3, 3), strides=(1, 1)):
    """conv(c1) -> act -> conv(c2) [-> silu] in both packages (the
    ArchChecker rule models of tests/test_utils_aux.py)."""
    class J(nn.Module):
        @nn.compact
        def __call__(self, x):
            x = nn.Conv(c1, k, strides=strides, padding="SAME")(x)
            if c2 is None:
                return x
            x = nn.Conv(c2, (3, 3), padding="SAME")(nn.relu(x))
            return jax.nn.silu(x) if act == "silu" else x

    class T(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.Conv_0 = Conv(3, c1, k, strides, use_bias=True)
            if c2 is not None:
                self.Conv_1 = Conv(c1, c2, (3, 3), use_bias=True)

        def forward(self, x):
            x = self.Conv_0(x)
            if c2 is None:
                return x
            x = self.Conv_1(torch.relu(x))
            return F.silu(x) if act == "silu" else x
    return J, T


class JaxConcatBn(nn.Module):
    @nn.compact
    def __call__(self, x):
        a = nn.Conv(8, (3, 3), padding="SAME")(x)
        b = nn.Conv(8, (3, 3), padding="SAME")(x)
        y = jnp.concatenate([a, b], axis=-1)
        return nn.relu(nn.BatchNorm(use_running_average=True)(y))


class ConcatBn(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.Conv_0 = Conv(3, 8, (3, 3), use_bias=True)
        self.Conv_1 = Conv(3, 8, (3, 3), use_bias=True)
        self.BatchNorm_0 = BatchNorm(16)

    def forward(self, x):
        y = torch.cat([self.Conv_0(x), self.Conv_1(x)], dim=1)
        return torch.relu(self.BatchNorm_0(y))


def _graphs(jm_cls, tm_cls, shape, seed=0):
    rs = np.random.RandomState(seed)
    jm, tm = jm_cls(), tm_cls()
    x = rs.randn(*shape).astype(np.float32)
    v = init_variables(jm, x, rs)
    tm.load_state_dict(convert.cnn_params_from_flax(v))
    jv = jax.tree_util.tree_map(jnp.asarray, v)
    jg = JaxGraph(lambda p, t: jm.apply(p, t), (jv, jnp.asarray(x)))
    return jg, ConnectedGraph(tm, (nchw(x),)), (jm, jv, x), (tm, nchw(x))


_SILU = _two_convs(32, 32, "silu")
_CH = _two_convs(24, 64, None)
MODELS = {
    "residual": (JaxResidualNet, ResidualNet, (1, 8, 8, 3)),
    "channels": (*_CH, (1, 8, 8, 3)),
    "silu_padding": (*_SILU, (1, 8, 8, 3)),
    "concat_bn": (JaxConcatBn, ConcatBn, (1, 8, 8, 3)),
    "large_kernel": (*_two_convs(32, None, None, k=(11, 11)),
                     (1, 16, 16, 3)),
    "stride4": (*_two_convs(32, None, None, strides=(4, 4)),
                (1, 16, 16, 3)),
}


@pytest.fixture(scope="module")
def graphs():
    out = {name: _graphs(*m) for name, m in MODELS.items()}
    for name in ("conv_bn_relu", "tiny_mlp", "tiny_cnn", "resnet_basic"):
        fn, v, tm, x, _ = pair(name)
        jv = jax.tree_util.tree_map(jnp.asarray, v)
        out[name] = (JaxGraph(fn, (jv, jnp.asarray(x))),
                     ConnectedGraph(tm, (nchw(x),)), None, None)
    return out


def _names(binding):
    return {k: op.name for k, op in binding.items()}


# ---------------------------------------------------------------------------
# graph API
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["residual", "resnet_basic", "tiny_cnn",
                                  "concat_bn"])
def test_neighbours_match_jax(graphs, name):
    jg, tg, *_ = graphs[name]
    assert [(o.name, o.type) for o in tg.ops] == \
        [(o.name, o.type) for o in jg.ops]
    for jo, to in zip(jg.ops, tg.ops):
        assert [o.name for o in to.input_ops] == \
            [o.name for o in jo.input_ops], to.name
        assert [o.name for o in to.output_ops] == \
            [o.name for o in jo.output_ops], to.name
        jd, td = jg.downstream_op(jo), tg.downstream_op(to)
        assert (td and td.name) == (jd and jd.name), to.name


@pytest.mark.parametrize("name", ["residual", "resnet_basic", "stride4",
                                  "large_kernel", "tiny_cnn"])
def test_conv_attributes_match_jax(graphs, name):
    jg, tg, *_ = graphs[name]
    for jo, to in zip(jg.ops, tg.ops):
        if to.type not in ("conv", "depthwise_conv"):
            continue
        assert tuple(to.attrs["window_strides"]) == \
            tuple(jo.attrs["window_strides"])
        assert tuple(tuple(p) for p in to.attrs["padding"]) == \
            tuple(tuple(int(v) for v in p) for p in jo.attrs["padding"])
        assert jac._padded(jo) == tac._padded(to)
        assert tac._conv_channels(to) == jac._conv_channels(jo)


def test_linear_channels_read_the_kernel_layout(graphs):
    jg, tg, *_ = graphs["tiny_mlp"]
    for jo, to in zip(jg.ops_of_type("linear"), tg.ops_of_type("linear")):
        assert tac._conv_channels(to) == jac._conv_channels(jo)
        # the same op with its kernel held (out, in)
        k = to.param_products["kernel"]
        flipped = type(to)(to.index, to.type, to.name, to.nodes, to.inputs,
                           to.output, {"kernel": type(k)(
                               k.node, k.name, k.shape[::-1], k.dtype,
                               k.kind, k.param_path)},
                           dict(to.attrs, kernel_transposed=True))
        assert tac._conv_channels(flipped) == jac._conv_channels(jo)


# ---------------------------------------------------------------------------
# pattern matcher
# ---------------------------------------------------------------------------

PATTERNS = [
    (dict(nodes={"c1": "conv", "bn": "batchnorm", "act": "relu",
                 "c2": "conv", "join": "add"},
          edges=[("c1", "bn"), ("bn", "act"), ("act", "c2"),
                 ("c2", "join")]), False),
    (dict(nodes={"trunk": ("conv", "relu"), "branch": "conv",
                 "join": "add"},
          edges=[("trunk", "branch"), ("trunk", "join")]), True),
    (dict(nodes={"trunk": ("conv", "relu"), "branch": "conv",
                 "join": "add"},
          edges=[("trunk", "branch"), ("trunk", "join")]), False),
    (dict(nodes={"a": "softmax", "b": "conv"}, edges=[("a", "b")]), False),
]


@pytest.mark.parametrize("name", ["residual", "resnet_basic"])
@pytest.mark.parametrize("case", range(len(PATTERNS)))
def test_find_pattern_matches_jax(graphs, name, case):
    jg, tg, *_ = graphs[name]
    spec, overlap = PATTERNS[case]
    want = [_names(m) for m in jpm.find_pattern(
        jg, jpm.SubgraphPattern(**spec), allow_overlap=overlap)]
    got = [_names(m) for m in tpm.find_pattern(
        tg, tpm.SubgraphPattern(**spec), allow_overlap=overlap)]
    assert got == want
    if name == "residual" and case == 0:
        assert len(got) == 2              # both residual blocks


@pytest.mark.parametrize("types,overlap", [
    (["conv", "batchnorm", "relu"], False), (["conv", "batchnorm"], True),
    (["conv", "relu", "conv"], False), (["relu", "add", "relu"], True)])
def test_match_chain_matches_jax(graphs, types, overlap):
    for name in ("residual", "resnet_basic"):
        jg, tg, *_ = graphs[name]
        want = [[o.name for o in c] for c in
                jpm.match_chain(jg, types, allow_overlap=overlap)]
        got = [[o.name for o in c] for c in
               tpm.match_chain(tg, types, allow_overlap=overlap)]
        assert got == want, name


def test_pattern_rejects_unknown_nodes():
    with pytest.raises(ValueError):
        tpm.SubgraphPattern(nodes={"a": "conv"}, edges=[("a", "b")])


# ---------------------------------------------------------------------------
# ArchChecker and ModelValidator
# ---------------------------------------------------------------------------

def _findings(results):
    return [(r.check, r.op_name, r.severity, tuple(r.structure))
            for r in results]


@pytest.mark.parametrize("name", list(MODELS) + ["conv_bn_relu", "tiny_mlp",
                                                 "tiny_cnn", "resnet_basic"])
def test_arch_checker_findings_match_jax(graphs, name):
    jg, tg, *_ = graphs[name]
    want = _findings(jac.ArchChecker.check_model(jg))
    got = _findings(tac.ArchChecker.check_model(tg))
    assert got == want
    assert got or name == "tiny_mlp"


def test_arch_checker_rule_catalogue_fires(graphs):
    """tests/test_utils_aux.py's TestArchCheckerRules, in the port."""
    def checks(name):
        return {r.check for r in tac.ArchChecker.check_model(
            graphs[name][1])}
    assert {"_check_conv_channel_32_base",
            "_check_conv_channel_larger_than_32",
            "_check_mxu_lane_alignment"} <= checks("channels")
    assert "_check_conv_channel_larger_than_32" in checks("conv_bn_relu")
    silu = tac.ArchChecker.check_model(graphs["silu_padding"][1])
    assert "_activation_checks" in {r.check for r in silu}
    pads = [r for r in silu if r.check == "_check_intermediate_padding"]
    assert pads and len(pads[0].structure) == 3
    assert {"_check_foldable_bn_with_split",
            "_check_batch_norm_fold"} <= checks("concat_bn")
    assert "_check_large_kernel_efficiency" in checks("large_kernel")


def test_arch_checker_registry_entry_point_and_html(graphs, tmp_path):
    _, _, (jm, jv, x), (tm, tx) = graphs["stride4"]

    def no_big_stride(op):
        if max(op.attrs.get("window_strides", (1,))) > 2:
            return tac.CheckResult(op.name, "no_big_stride", "stride > 2")
        return None
    tac.ArchChecker.add_node_check("conv", no_big_stride)
    try:
        res = tac.ArchChecker.check_model_arch(
            tm, (tx,), result_path=str(tmp_path / "t.html"))
    finally:
        tac.ArchChecker._node_checks["conv"].remove(no_big_stride)
    assert any(r.check == "no_big_stride" for r in res)
    assert not any(r.check == "no_big_stride"
                   for r in tac.ArchChecker.check_model(graphs["stride4"][1]))
    # the report: the JAX package's HTML for the same findings
    jres = jac.ArchChecker.check_model_arch(
        lambda p, t: jm.apply(p, t), (jv, jnp.asarray(x)))
    tres = [r for r in res if r.check != "no_big_stride"]
    jac.ArchChecker.export_html(jres, str(tmp_path / "j.html"))
    tac.ArchChecker.export_html(tres, str(tmp_path / "t2.html"))
    txt = (tmp_path / "t2.html").read_text()
    assert txt == (tmp_path / "j.html").read_text()
    assert "failed check" in txt and "structure" in txt


def test_model_validator_matches_jax():
    fn, v, tm, x, _ = pair("tiny_mlp")
    jv = jax.tree_util.tree_map(jnp.asarray, v)
    want = jac.ModelValidator.validate_model(fn, (jv, jnp.asarray(x)))
    got = tac.ModelValidator.validate_model(tm, (nchw(x),))
    assert got == want == {"traceable": True, "all_ops_classified": True,
                           "has_quantizable_layers": True}


def test_model_validator_flags_an_unclassified_op():
    """A custom op (outside aten) is the port graph's unclassified node,
    as an opaque custom_jvp_call is the JAX graph's."""
    lib = torch.library.Library("aimet_port_test", "DEF")
    lib.define("twice(Tensor x) -> Tensor")
    lib.impl("twice", lambda x: x * 2, "CompositeExplicitAutograd")
    torch.library.register_fake("aimet_port_test::twice",
                                lambda x: torch.empty_like(x), lib=lib)

    class M(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.ones(4, 4))

        def forward(self, x):
            return torch.ops.aimet_port_test.twice(x @ self.w)
    try:
        g = ConnectedGraph(M(), (torch.ones(2, 4),))
        assert [o.type for o in g.ops] == ["linear", "custom"]
        got = tac.ModelValidator.validate_model(M(), (torch.ones(2, 4),))
        assert got == {"traceable": True, "all_ops_classified": False,
                       "has_quantizable_layers": True}
    finally:
        lib._destroy()

    class Broken(torch.nn.Module):
        def forward(self, x):
            raise RuntimeError("untraceable")
    assert tac.ModelValidator.validate_model(Broken(), (torch.ones(1),)) == \
        {"traceable": False}
