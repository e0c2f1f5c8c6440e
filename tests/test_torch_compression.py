"""Compression in aimet_tpu_torch against the JAX package (the intent of
tests/test_compression.py and tests/test_winnow_joins.py): costs, ranks
and greedy ratios equal; SVD reconstructions, channel-pruning keeps and
least-squares reconstructions, and compressed models' outputs within the
stated tolerances; ``WinnowPlan``s equal; the ResNet-18 pipeline's MAC
ratios equal and its outputs close; a compressed model's lowering skips
its factored layers as the JAX lowering does.

The same weights (drawn with numpy, or flax's initial values where a
test keeps a JAX test's accuracy gate) and inputs go through both
packages, the port on the CPU in NCHW. SVD
factors are unique only up to signs, so the tests hold products of
factors and models' outputs against the JAX package, never the factors.
Kernel axes are compared by role (the output / input channel axis), since
the port's kernels are OIHW and the JAX package's HWIO. In a re-traced
compressed graph only the conv ops are compared by name: the JAX package
replays flax's relu as its inner ``max``, which joins the preceding
rebuilt affine op, where the port keeps a ``relu`` op.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aimet_tpu.algorithms.bn_fold import _conv_axes as jax_conv_axes
from aimet_tpu.compression import greedy as jgreedy
from aimet_tpu.compression import svd as jsvd
from aimet_tpu.compression.compressor import ModelCompressor as JaxMC
from aimet_tpu.compression.cost import layer_cost as jax_layer_cost
from aimet_tpu.compression.cost import model_cost as jax_model_cost
from aimet_tpu.compression.cost import rank_for_comp_ratio as jax_rank
from aimet_tpu.compression.cost import \
    ranks_for_comp_ratio_ssvd as jax_ranks_ssvd
from aimet_tpu.compression.cost import spatial_svd_cost as jax_ssvd_cost
from aimet_tpu.compression.winnow import plan_winnow as jax_plan_winnow
from aimet_tpu.compression.winnow import winnow_model as jax_winnow_model
from aimet_tpu.graph.connected_graph import ConnectedGraph as JaxGraph
from aimet_tpu.models.cnn import TinyMLP as JaxTinyMLP
from aimet_tpu.quantsim.lowering import lower_to_int as jax_lower_to_int
from aimet_tpu.quantsim.qsim import QuantizationSimModel as JaxSim
from aimet_tpu_torch import convert
from aimet_tpu_torch.algorithms.bn_fold import _conv_axes
from aimet_tpu_torch.compression import greedy, svd
from aimet_tpu_torch.compression.channel_pruning import (
    lstsq, reconstruct_weights, select_channels_to_keep)
from aimet_tpu_torch.compression.compressor import ModelCompressor
from aimet_tpu_torch.compression.cost import (layer_cost, model_cost,
                                              rank_for_comp_ratio,
                                              ranks_for_comp_ratio_ssvd,
                                              spatial_svd_cost,
                                              successive_svd_cost)
from aimet_tpu_torch.compression.winnow import plan_winnow, winnow_model
from aimet_tpu_torch.graph.connected_graph import ConnectedGraph
from aimet_tpu_torch.graph.interpreter import evaluate_with_replacements
from aimet_tpu_torch.models.cnn import TinyMLP
from aimet_tpu_torch.models.layers import BatchNorm, Conv, Dense
from aimet_tpu_torch.models.resnet import ResNet18
from aimet_tpu_torch.quantsim.lowering import lower_to_int
from aimet_tpu_torch.quantsim.qsim import QuantizationSimModel
from test_compression import SmallConvNet as JaxSmallConvNet
from torch_ptq_util import init_variables
from test_winnow_joins import BlockedNet as JaxBlockedNet
from test_winnow_joins import ConcatNet as JaxConcatNet
from test_winnow_joins import ConcatSharedSegmentNet as JaxSharedNet
from test_winnow_joins import ResidualNet as JaxResidualNet

# outputs of compressed models: rtol 1e-4 / atol 1e-5 (SVD and least
# squares in f32 through different LAPACKs); plain f32 paths as
# tests/test_torch_quantsim.py
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x).transpose(0, 3, 1, 2)))


def nhwc(t):
    a = t.detach().numpy()
    return a.transpose(0, 2, 3, 1) if a.ndim == 4 else a


def hwio(t):
    return t.detach().numpy().transpose(2, 3, 1, 0)


# ---------------------------------------------------------------------------
# the port's counterparts of the JAX tests' flax nets (flax's names)
# ---------------------------------------------------------------------------
class SmallConvNet(torch.nn.Module):
    def __init__(self, hw=8):
        super().__init__()
        self.Conv_0 = Conv(3, 16, (3, 3), use_bias=True)
        self.Conv_1 = Conv(16, 16, (3, 3), use_bias=True)
        self.Dense_0 = Dense(16 * hw * hw, 4)

    def forward(self, x):
        x = torch.relu(self.Conv_1(torch.relu(self.Conv_0(x))))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return self.Dense_0(x)


class ResidualNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv0 = Conv(3, 12, (3, 3), use_bias=True)
        self.conv1 = Conv(12, 12, (3, 3), use_bias=True)
        self.bn1 = BatchNorm(12)
        self.conv2 = Conv(12, 12, (3, 3), use_bias=True)
        self.conv3 = Conv(12, 8, (3, 3), use_bias=True)

    def forward(self, x):
        x = self.conv0(x)
        y = self.conv2(torch.relu(self.bn1(self.conv1(x))))
        return self.conv3(torch.relu(x + y))


class ConcatNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv_a = Conv(3, 6, (3, 3), use_bias=True)
        self.conv_b = Conv(3, 10, (3, 3), use_bias=True)
        self.conv_out = Conv(16, 4, (3, 3), use_bias=True)

    def forward(self, x):
        y = torch.cat([self.conv_a(x), self.conv_b(x)], dim=1)
        return self.conv_out(torch.relu(y))


class BlockedNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.Conv_0 = Conv(3, 8, (3, 3), use_bias=True)
        self.Conv_1 = Conv(8, 4, (3, 3), use_bias=True)

    def forward(self, x):
        return self.Conv_1(torch.softmax(self.Conv_0(x), dim=1))


class SharedSegmentNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv_a = Conv(3, 8, (3, 3), use_bias=True)
        self.conv_b = Conv(3, 8, (3, 3), use_bias=True)
        self.conv_cat = Conv(16, 4, (3, 3), use_bias=True)
        self.conv_seg = Conv(8, 4, (3, 3), use_bias=True)

    def forward(self, x):
        a, b = self.conv_a(x), self.conv_b(x)
        return self.conv_cat(torch.cat([a, b], dim=1)) + self.conv_seg(b)


@functools.lru_cache(maxsize=None)
def _flax_init(jax_cls, shape, seed):
    jm = jax_cls()
    v = jax.jit(jm.init)(jax.random.PRNGKey(seed), jnp.ones(shape))
    return jax.tree_util.tree_map(np.array, v)


def flax_variables(jax_cls, shape, seed=0):
    """flax's initial variables (numpy), as the JAX tests'
    ``init_model(model, shape, seed)`` makes them: where a test keeps the
    JAX test's accuracy gate, the gate holds on the JAX test's weights.
    One jitted init a model (the eager init compiles every op alone)."""
    return jax.tree_util.tree_map(np.array, _flax_init(jax_cls, shape,
                                                       seed))


def _pair(jax_cls, port_cls, shape, seed=0, randomize_bn=False,
          flax_init=False):
    """(JAX graph, fn, variables, port model, port graph, x NHWC numpy):
    weights drawn with numpy as flax's initializers draw them
    (``torch_ptq_util.init_variables``), or, with ``flax_init``, flax's
    own initial values; with ``randomize_bn``, non-trivial BatchNorm
    statistics drawn with numpy."""
    jm = jax_cls()
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    v = flax_variables(jax_cls, (1,) + shape[1:], seed) if flax_init else \
        init_variables(jm, x, np.random.RandomState(seed + 1))
    if randomize_bn:
        rs = np.random.RandomState(seed + 1)
        for name, st in v.get("batch_stats", {}).items():
            st["mean"] = rs.randn(*st["mean"].shape).astype(np.float32)
            st["var"] = (np.abs(rs.randn(*st["var"].shape)) + 0.5).astype(
                np.float32)
            p = v["params"][name]
            p["scale"] = (rs.rand(*p["scale"].shape) + 0.5).astype(
                np.float32)
            p["bias"] = rs.randn(*p["bias"].shape).astype(np.float32)
    vj = jax.tree_util.tree_map(jnp.asarray, v)
    fn = lambda v, x: jm.apply(v, x)  # noqa: E731
    tm = port_cls()
    tm.load_state_dict(convert.cnn_params_from_flax(v))
    return (JaxGraph(fn, (vj, jnp.asarray(x))), fn, vj, tm,
            ConnectedGraph(tm, (nchw(x),)), x)


def _c(cost):
    """A cost of either package, comparable."""
    return (cost.memory, cost.mac)


def _params(tm):
    return {k: p.detach() for k, p in tm.named_parameters()}


def _plan_rows(plan, graph, axes_of):
    """A plan with kernel axes by role and keeps as tuples."""
    def role(opn, r, a):
        if r != "kernel":
            return r, "out"
        out_ax, in_ax, _ = axes_of(graph.get_op(opn))
        return r, "out" if a == out_ax else "in"

    return ({n: sorted(role(n, r, a) + (tuple(int(i) for i in k),)
                       for r, a, k in s)
             for n, s in plan.layer_slices.items()},
            dict(plan.rebuilt_ops),
            {n: tuple(int(i) for i in k)
             for n, (_, k) in plan.affine_ops.items()},
            {n: tuple(int(i) for i in k) for n, k in plan.gathers.items()},
            sorted(plan.fallbacks))


def _assert_plans_equal(jplan, jg, pplan, pg):
    assert _plan_rows(pplan, pg, _conv_axes) == \
        _plan_rows(jplan, jg, jax_conv_axes)


# ---------------------------------------------------------------------------
# costs, SVD factors, greedy fit
# ---------------------------------------------------------------------------
def test_monotonic_fit_matches_jax():
    r = np.linspace(0.1, 0.9, 9)
    s = np.array([0.1, 0.3, 0.2, 0.5, 0.4, 0.6, 0.9, 0.8, 1.0])
    f = greedy.monotonic_fit(r, s)
    assert np.all(np.diff(f) >= -1e-12)
    np.testing.assert_allclose(f.mean(), s.mean(), rtol=1e-6)
    np.testing.assert_array_equal(f, jgreedy.monotonic_fit(r, s))


@pytest.fixture(scope="module")
def small_conv():
    return _pair(JaxSmallConvNet, SmallConvNet, (2, 8, 8, 3),
                 flax_init=True)


def test_costs_and_ranks_match_jax(small_conv):
    jg, _, _, _, pg, _ = small_conv
    for name in ("conv_0", "conv_1"):
        jop, pop = jg.get_op(name), pg.get_op(name)
        assert _c(layer_cost(pop)) == _c(jax_layer_cost(jop))
        for r in (1, 4, 8, 16):
            assert _c(spatial_svd_cost(pop, r)) == _c(jax_ssvd_cost(jop, r))
        for ratio in (0.25, 0.5, 0.75):
            for mode in ("spatial_svd", "weight_svd"):
                assert rank_for_comp_ratio(pop, ratio, mode) == \
                    jax_rank(jop, ratio, mode)
            assert ranks_for_comp_ratio_ssvd(pop, ratio) == \
                jax_ranks_ssvd(jop, ratio)
    assert _c(model_cost(pg)) == _c(jax_model_cost(jg))
    op = pg.get_op("conv_1")
    costs = [spatial_svd_cost(op, r).mac for r in (1, 4, 8, 16)]
    assert all(np.diff(costs) > 0)
    r_half = rank_for_comp_ratio(op, 0.5, "spatial_svd")
    assert spatial_svd_cost(op, r_half).mac <= 0.5 * layer_cost(op).mac


@pytest.mark.parametrize("rank", [10_000, 12])
def test_spatial_svd_reconstruction_matches_jax(small_conv, rank):
    """Full rank reproduces the kernel; a cut rank gives JAX's truncated
    reconstruction (products of the factors, at 1e-4)."""
    jg, _, v, tm, pg, _ = small_conv
    w = tm.Conv_1.kernel.detach()
    w1, w2 = svd.spatial_svd_factor(pg.get_op("conv_1"), w, rank)
    recon = torch.einsum("rikx,orxw->oikw", w1, w2)
    j1, j2 = jsvd.spatial_svd_factor(jg.get_op("conv_1"),
                                     v["params"]["Conv_1"]["kernel"], rank)
    want = np.einsum("haif,bwfo->hwio", np.asarray(j1), np.asarray(j2))
    _close(hwio(recon), want)
    if rank >= 48:
        _close(recon, w, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("rank", [16, 5])
def test_weight_svd_reconstruction_matches_jax(rank):
    rng = np.random.RandomState(0)
    w = rng.randn(32, 16).astype(np.float32)
    w1, w2 = svd.weight_svd_factor_linear(torch.from_numpy(w), rank)
    j1, j2 = jsvd.weight_svd_factor_linear(jnp.asarray(w), rank)
    _close(w1 @ w2, np.asarray(j1) @ np.asarray(j2))
    if rank == 16:
        _close(w1 @ w2, w)
    conv = torch.from_numpy(rng.randn(8, 6, 3, 3).astype(np.float32))
    op = ConnectedGraph(torch.nn.Conv2d(6, 8, 3), (torch.ones(1, 6, 5, 5),)
                        ).get_op("conv_0")
    c1, c2 = svd.weight_svd_factor_conv(op, conv, rank)
    jop = JaxGraph(lambda w, x: jax.lax.conv_general_dilated(
        x, w, (1, 1), "VALID", dimension_numbers=("NHWC", "HWIO", "NHWC")),
        (jnp.zeros((3, 3, 6, 8)), jnp.zeros((1, 5, 5, 6)))).get_op("conv_0")
    jc1, jc2 = jsvd.weight_svd_factor_conv(jop, jnp.asarray(hwio(conv)), rank)
    recon = torch.einsum("rikw,orxy->oikw", c1, c2)
    _close(hwio(recon), np.einsum("hwir,xyro->hwio", np.asarray(jc1),
                                  np.asarray(jc2)))


def test_successive_svd_full_rank_exact_and_compress(small_conv):
    """SSVD at full (r, s) reproduces the conv (ISVD.hpp:69-71); at 0.5
    the compressed model matches JAX's."""
    jg, fn, v, tm, pg, x = small_conv
    op = pg.get_op("conv_0")
    w, b = tm.Conv_0.kernel.detach(), tm.Conv_0.bias.detach()
    full_r, full_s = min(3 * 9, 16), 3
    rep = svd.make_successive_svd_replacement(op, w, b, full_r, full_s)
    got = evaluate_with_replacements(pg, _params(tm), (nchw(x),),
                                     {"conv_0": rep})
    _close(got, fn(v, jnp.asarray(x)), rtol=2e-4, atol=2e-4)
    r, s = ranks_for_comp_ratio_ssvd(op, 0.5)
    assert successive_svd_cost(op, r, s).mac <= 0.5 * layer_cost(op).mac
    ratios = {"conv_0": 0.5, "conv_1": 0.5}
    model, stats = ModelCompressor.compress_model(
        tm, (nchw(x),), None, "successive_svd", manual_ratios=ratios)
    jmodel, jstats = JaxMC.compress_model(fn, (v, jnp.asarray(x)), v,
                                          "successive_svd",
                                          manual_ratios=ratios)
    assert _c(stats.compressed_cost) == _c(jstats.compressed_cost)
    assert _c(stats.original_cost) == _c(jstats.original_cost)
    with torch.no_grad():
        _close(model(nchw(x)), jax.jit(jmodel.__call__)(v, jnp.asarray(x)))


# ---------------------------------------------------------------------------
# ModelCompressor
# ---------------------------------------------------------------------------
def test_manual_spatial_svd_model_matches_jax(small_conv):
    jg, fn, v, tm, pg, xb = small_conv    # tests/test_compression.py's xb
    model, stats = ModelCompressor.compress_model(
        tm, (nchw(xb),), None, "spatial_svd", manual_ratios={"conv_1": 0.5})
    jmodel, jstats = JaxMC.compress_model(fn, (v, jnp.asarray(xb)), v,
                                          "spatial_svd",
                                          manual_ratios={"conv_1": 0.5})
    assert _c(stats.compressed_cost) == _c(jstats.compressed_cost)
    assert stats.mac_compression_ratio < 1.0
    with torch.no_grad():
        out = model(nchw(xb))
        ref = tm(nchw(xb))
    _close(out, jax.jit(jmodel.__call__)(v, jnp.asarray(xb)))
    assert float((out - ref).abs().mean() / ref.abs().mean()) < 0.5
    # other parameters through run(): a zero head gives zero outputs
    p = _params(tm)
    p["Dense_0.kernel"] = torch.zeros_like(p["Dense_0.kernel"])
    p["Dense_0.bias"] = torch.zeros_like(p["Dense_0.bias"])
    assert float(model.run(p, nchw(xb)).abs().max()) == 0.0


def test_manual_weight_svd_mlp_matches_jax():
    jm = JaxTinyMLP(features=32)
    x = jnp.ones((4, 16), jnp.float32)
    v = init_variables(jm, x, np.random.RandomState(0))
    tm = TinyMLP(16, 32, 10)
    tm.load_state_dict(convert.cnn_params_from_flax(
        jax.tree_util.tree_map(np.asarray, v)))
    xt = torch.from_numpy(np.array(x))
    model, stats = ModelCompressor.compress_model(
        tm, (xt,), None, "weight_svd", manual_ratios={"linear_1": 0.5})
    jmodel, jstats = JaxMC.compress_model(
        lambda v, x: jm.apply(v, x), (v, x), v, "weight_svd",
        manual_ratios={"linear_1": 0.5})
    assert _c(stats.compressed_cost) == _c(jstats.compressed_cost)
    assert stats.mac_compression_ratio < 1.0
    with torch.no_grad():
        out = model(xt)
    assert out.shape == (4, 10)
    _close(out, jmodel(v, x))


@pytest.fixture(scope="module")
def pruning_pair():
    jg, fn, v, tm, pg, x = _pair(JaxSmallConvNet, SmallConvNet, (4, 8, 8, 3),
                                 flax_init=True)
    xb = np.random.RandomState(2).randn(4, 8, 8, 3).astype(np.float32)
    jsim = JaxSim(fn, (v, jnp.asarray(x)), quant_scheme="minmax")
    jcaps = jsim.collect_activations(v, (jnp.asarray(xb),),
                                     ["relu_0.out", "conv_1.out"])
    sim = QuantizationSimModel(tm, (nchw(x),), quant_scheme="minmax",
                               device="cpu")
    caps = sim.collect_activations(None, (nchw(xb),),
                                   ["relu_0.out", "conv_1.out"])
    _close(caps["relu_0.out"], nchw(jcaps["relu_0.out"]), atol=1e-6)
    return jg, fn, v, tm, pg, x, xb, caps, jcaps


def test_channel_keep_and_lstsq_reconstruction_match_jax(pruning_pair):
    """The kept channels equal JAX's (its weights have no near-ties); the
    least-squares refit on the patches equals jnp.linalg.lstsq's."""
    from aimet_tpu.compression.channel_pruning import \
        reconstruct_weights as jax_reconstruct
    from aimet_tpu.compression.channel_pruning import \
        select_channels_to_keep as jax_select
    jg, _, v, tm, pg, _, _, caps, jcaps = pruning_pair
    w = tm.Conv_1.kernel.detach()
    mag = w.abs().sum(dim=(0, 2, 3)).sort().values
    assert float((mag[1:] - mag[:-1]).min()) > 1e-4      # no near-ties
    keep = select_channels_to_keep(w, 8, 1)
    jw = v["params"]["Conv_1"]["kernel"]
    np.testing.assert_array_equal(keep, jax_select(jw, 8, 2))
    b = tm.Conv_1.bias.detach()
    w_new = reconstruct_weights(caps["relu_0.out"], caps["conv_1.out"],
                                pg.get_op("conv_1"), keep, w, b)
    j_new = jax_reconstruct(jcaps["relu_0.out"], jcaps["conv_1.out"],
                            jg.get_op("conv_1"), keep, jw,
                            v["params"]["Conv_1"]["bias"])
    _close(hwio(w_new), j_new, rtol=1e-3, atol=1e-4)
    # minimum norm on a rank-deficient system, as jnp.linalg.lstsq
    rng = np.random.RandomState(3)
    a = rng.randn(40, 6).astype(np.float32)
    a[:, 5] = a[:, 4]
    bb = rng.randn(40, 3).astype(np.float32)
    _close(lstsq(torch.from_numpy(a), torch.from_numpy(bb)),
           jnp.linalg.lstsq(jnp.asarray(a), jnp.asarray(bb))[0])


def test_channel_pruning_with_reconstruction_matches_jax(pruning_pair):
    jg, fn, v, tm, pg, x, xb, caps, jcaps = pruning_pair
    act = {"conv_1": (caps["relu_0.out"], caps["conv_1.out"])}
    jact = {"conv_1": (jcaps["relu_0.out"], jcaps["conv_1.out"])}
    model, stats = ModelCompressor.compress_model(
        tm, (nchw(x),), None, "channel_pruning",
        manual_ratios={"conv_1": 0.5}, act_samples=act)
    jmodel, jstats = JaxMC.compress_model(
        fn, (v, jnp.asarray(x)), v, "channel_pruning",
        manual_ratios={"conv_1": 0.5}, act_samples=jact)
    assert _c(stats.compressed_cost) == _c(jstats.compressed_cost)
    with torch.no_grad():
        out, ref = model(nchw(xb)), tm(nchw(xb))
    _close(out, jax.jit(jmodel.__call__)(v, jnp.asarray(xb)), rtol=1e-3,
           atol=1e-4)
    rel = float((out - ref).abs().mean() / ref.abs().mean())
    assert rel < 0.6
    model2, _ = ModelCompressor.compress_model(
        tm, (nchw(x),), None, "channel_pruning",
        manual_ratios={"conv_1": 0.5})
    with torch.no_grad():
        out2 = model2(nchw(xb))
    rel2 = float((out2 - ref).abs().mean() / ref.abs().mean())
    assert rel <= rel2 * 1.2


def test_greedy_auto_selection_matches_jax(small_conv):
    jg, fn, v, tm, pg, _ = small_conv
    xb = np.random.RandomState(4).randn(2, 8, 8, 3).astype(np.float32)
    with torch.no_grad():
        ref = tm(nchw(xb))
    jref = fn(v, jnp.asarray(xb))

    def eval_fn(m):
        with torch.no_grad():
            return -float(((m(nchw(xb)) - ref) ** 2).mean())

    def jeval_fn(m):
        return -float(jnp.mean((m(v, jnp.asarray(xb)) - jref) ** 2))

    model, stats = ModelCompressor.compress_model(
        tm, (nchw(xb),), None, "spatial_svd", eval_fn=eval_fn,
        target_comp_ratio=0.6, num_candidates=5)
    _, jstats = JaxMC.compress_model(
        fn, (v, jnp.asarray(xb)), v, "spatial_svd", eval_fn=jeval_fn,
        target_comp_ratio=0.6, num_candidates=5)
    assert stats.per_layer_ratios == jstats.per_layer_ratios
    assert _c(stats.compressed_cost) == _c(jstats.compressed_cost)
    assert 0 < stats.mac_compression_ratio <= 1.0
    with torch.no_grad():
        assert torch.isfinite(model(nchw(xb))).all()


def test_compressed_model_lowering_skips_constant_kernels(small_conv):
    """The factored conv's kernels are constants of the compressed model:
    its lowering skips them, as the JAX lowering does, and lowers the
    rest; the lowered forward (plain versions) matches JAX's."""
    jg, fn, v, tm, pg, x = small_conv
    model, _ = ModelCompressor.compress_model(
        tm, (nchw(x),), None, "spatial_svd", manual_ratios={"conv_1": 0.5})
    jmodel, _ = JaxMC.compress_model(fn, (v, jnp.asarray(x)), v,
                                     "spatial_svd",
                                     manual_ratios={"conv_1": 0.5})
    jfn = lambda v, x: jmodel(v, x)  # noqa: E731
    data = [np.random.RandomState(5 + i).randn(2, 8, 8, 3).astype(
        np.float32) for i in range(2)]
    jsim = JaxSim(jfn, (v, jnp.asarray(x)), quant_scheme="minmax")
    jsim.compute_encodings(v, iter([jnp.asarray(d) for d in data]))
    sim = QuantizationSimModel(model, (nchw(x),), quant_scheme="minmax",
                               device="cpu")
    sim.compute_encodings(None, iter([nchw(d) for d in data]))
    assert [(o.name, o.type) for o in sim.graph.ops if o.type == "conv"] == \
        [(o.name, o.type) for o in jsim.graph.ops if o.type == "conv"]
    want = jax_lower_to_int(jsim, v, mode="w8")
    got = lower_to_int(sim, mode="w8")
    assert got.lowered_ops == want.lowered_ops
    assert got.skipped_ops == want.skipped_ops
    assert {"conv_1", "conv_2"} <= set(got.skipped_ops)
    _close(got(sim.params, nchw(x)),
           jax.jit(want.__call__)(v, jnp.asarray(x)))


# ---------------------------------------------------------------------------
# winnow (tests/test_winnow_joins.py)
# ---------------------------------------------------------------------------
def _winnow_case(jax_cls, port_cls, masks, randomize_bn=False):
    jg, fn, v, tm, pg, x = _pair(jax_cls, port_cls, (2, 8, 8, 3),
                                 randomize_bn=randomize_bn)
    reduced, reps = winnow_model(pg, _params(tm), masks)
    jreduced, _ = jax_winnow_model(jg, v, masks)
    _assert_plans_equal(jreduced.plan, jg, reduced.plan, pg)
    with torch.no_grad():
        out = reduced(_params(tm), nchw(x))
    _close(out, nchw(jax.jit(jreduced)(v, jnp.asarray(x))))
    return reduced.plan, out, tm, x


def test_residual_add_join_propagates_both_branches():
    """conv3's input crosses the residual add: conv0 and conv2 (writers)
    and conv1 (another reader) all slice."""
    plan, out, tm, x = _winnow_case(JaxResidualNet, ResidualNet,
                                    {"conv_3": [1, 4, 9]})
    assert not plan.fallbacks
    assert {"conv_0", "conv_1", "conv_2", "conv_3"} <= set(plan.layer_slices)
    assert out.shape == (2, 8, 8, 8) and torch.isfinite(out).all()


def test_residual_internal_space_with_bn():
    plan, out, tm, x = _winnow_case(JaxResidualNet, ResidualNet,
                                    {"conv_2": [0, 3, 7, 11]},
                                    randomize_bn=True)
    assert not plan.fallbacks
    bn = next(n for n, k in plan.rebuilt_ops.items() if k == "affine")
    assert plan.affine_ops[bn][1].size == 8
    with torch.no_grad():
        want = tm(nchw(x))
    corr = np.corrcoef(want.numpy().ravel(), out.numpy().ravel())[0, 1]
    assert corr > 0.5


def test_winnow_exact_when_channels_dead():
    """Removed channels that are exactly dead leave the model unchanged."""
    jg, fn, v, tm, pg, x = _pair(JaxResidualNet, ResidualNet, (2, 8, 8, 3))
    remove = [2, 5]
    with torch.no_grad():
        tm.conv1.kernel[remove] = 0.0
        tm.conv1.bias[remove] = 0.0
        tm.bn1.scale[remove] = 0.0
        tm.bn1.bias[remove] = 0.0
        tm.bn1.mean[remove] = 0.0
        tm.bn1.var[remove] = 1.0
        reduced, _ = winnow_model(pg, _params(tm), {"conv_2": remove})
        assert not reduced.plan.fallbacks
        _close(reduced(_params(tm), nchw(x)), tm(nchw(x)), rtol=2e-5,
               atol=1e-5)


def test_concat_segment_mapping():
    plan, out, _, _ = _winnow_case(JaxConcatNet, ConcatNet,
                                   {"conv_2": [4, 5, 8]})
    assert not plan.fallbacks
    a_out = [k for r, a, k in plan.layer_slices["conv_0"] if r == "kernel"]
    b_out = [k for r, a, k in plan.layer_slices["conv_1"] if r == "kernel"]
    assert set(range(6)) - set(a_out[0].tolist()) == {4, 5}
    assert set(range(10)) - set(b_out[0].tolist()) == {2}
    assert out.shape == (2, 4, 8, 8)


def test_blocked_seed_falls_back_to_gather():
    plan, out, _, _ = _winnow_case(JaxBlockedNet, BlockedNet,
                                   {"conv_1": [0, 7]})
    assert "conv_1" in plan.fallbacks and "conv_1" in plan.gathers
    assert "conv_0" not in plan.layer_slices
    assert out.shape == (2, 4, 8, 8) and torch.isfinite(out).all()


@pytest.mark.parametrize("masks,b_removed", [
    ({"conv_2": [8], "conv_3": [0]}, {0}),
    ({"conv_2": [9], "conv_3": [0]}, {0, 1})])
def test_concat_frame_merge(masks, b_removed):
    """A concat consumer and a segment consumer seeding the same or
    different physical channels of segment b: one plan, every frame
    consistent (the fixpoint closes)."""
    plan, out, _, _ = _winnow_case(JaxSharedNet, SharedSegmentNet, masks)
    assert not plan.fallbacks
    b_keep = None
    for r, a, k in plan.layer_slices["conv_1"]:
        if r == "kernel" and a == 0:
            b_keep = k if b_keep is None else np.intersect1d(b_keep, k)
    assert set(range(8)) - set(b_keep.tolist()) == b_removed
    assert "conv_0" not in plan.layer_slices
    assert out.shape == (2, 4, 8, 8)


def test_out_of_range_mask_raises():
    jg, _, _, tm, pg, _ = _pair(JaxConcatNet, ConcatNet, (2, 8, 8, 3))
    with pytest.raises(ValueError, match="out of range"):
        plan_winnow(pg, {"conv_2": [16]})
    with pytest.raises(ValueError, match="out of range"):
        jax_plan_winnow(jg, {"conv_2": [16]})


# ---------------------------------------------------------------------------
# the ResNet-18 pipeline (BASELINE row 7 in miniature)
# ---------------------------------------------------------------------------
def test_resnet18_50pct_mac_pipeline_matches_jax():
    """Channel pruning across residual trunks, then spatial SVD on the 8
    heaviest convs of the re-traced pruned model: the MAC ratios equal
    JAX's, the outputs match, and the MAC is at most 0.55 of the
    original."""
    from aimet_tpu.models.resnet import ResNet18 as JaxResNet18
    jm = JaxResNet18(num_classes=4, num_filters=8)
    xs = np.random.RandomState(0).randn(2, 32, 32, 3).astype(np.float32)
    v = jax.tree_util.tree_map(jnp.asarray, flax_variables(
        functools.partial(JaxResNet18, num_classes=4, num_filters=8),
        (1, 32, 32, 3)))
    fn = lambda v, x: jm.apply(v, x)  # noqa: E731
    cp = {"conv_3": 0.5, "conv_4": 0.5, "conv_9": 0.5, "conv_14": 0.5,
          "conv_19": 0.5}
    jm1, js1 = JaxMC.compress_model(fn, (v, jnp.asarray(xs)), v,
                                    "channel_pruning", manual_ratios=cp)
    fn2 = lambda v, x: jm1(v, x)  # noqa: E731
    jg2 = JaxGraph(fn2, (v, jnp.asarray(xs)))
    jcosts = sorted(((jax_layer_cost(op).mac, op.name)
                     for op in jg2.ops if op.type == "conv"), reverse=True)
    jm2, js2 = JaxMC.compress_model(
        fn2, (v, jnp.asarray(xs)), v, "spatial_svd",
        manual_ratios={n: 0.5 for _, n in jcosts[:8]})

    tm = ResNet18(num_classes=4, num_filters=8)
    tm.load_state_dict(convert.cnn_params_from_flax(
        jax.tree_util.tree_map(np.asarray, v)))
    x = nchw(xs)
    m1, s1 = ModelCompressor.compress_model(tm, (x,), None,
                                            "channel_pruning",
                                            manual_ratios=cp)
    with torch.no_grad():
        _close(m1(x), jax.jit(jm1.__call__)(v, jnp.asarray(xs)))
    g2 = ConnectedGraph(m1, (x,))
    assert model_cost(g2).mac / s1.original_cost.mac == \
        jax_model_cost(jg2).mac / js1.original_cost.mac < 0.65
    costs = sorted(((layer_cost(op).mac, op.name)
                    for op in g2.ops if op.type == "conv"), reverse=True)
    assert costs == jcosts
    m2, s2 = ModelCompressor.compress_model(
        m1, (x,), None, "spatial_svd",
        manual_ratios={n: 0.5 for _, n in costs[:8]})
    overall = s2.compressed_cost.mac / s1.original_cost.mac
    assert overall == js2.compressed_cost.mac / js1.original_cost.mac
    assert overall <= 0.55
    with torch.no_grad():
        out2 = m2(x)
        ref = tm(x)
    _close(out2, jax.jit(jm2.__call__)(v, jnp.asarray(xs)))
    corr = np.corrcoef(ref.numpy().ravel(), out2.numpy().ravel())[0, 1]
    assert corr > 0.85


class TwoReaderNet(torch.nn.Module):
    """conv_0 -> relu -> conv_1 (a trunk writer that also reads one) ->
    relu -> conv_2 + conv_3 (two readers of conv_1's space)."""

    def __init__(self):
        super().__init__()
        self.Conv_0 = Conv(3, 8, (3, 3), use_bias=True)
        self.Conv_1 = Conv(8, 12, (3, 3), use_bias=True)
        self.Conv_2 = Conv(12, 4, (3, 3), use_bias=True)
        self.Conv_3 = Conv(12, 4, (3, 3), use_bias=True)

    def forward(self, x):
        t = torch.relu(self.Conv_1(torch.relu(self.Conv_0(x))))
        return self.Conv_2(t) + self.Conv_3(t)


def test_reconstruction_takes_every_output_slice():
    """A reconstructed seed whose output space takes removals in several
    deltas (two other seeds read it) keeps the intersection of all its
    output slices, so its consumers get the channels they expect. (The JAX
    package's ``make_multi_channel_pruned_replacements`` takes the first
    slice alone and builds a layer wider than its consumers.)"""
    torch.manual_seed(0)
    tm = TwoReaderNet()
    for p in tm.parameters():
        torch.nn.init.normal_(p, 0.0, 0.3)
    x = torch.randn(2, 3, 8, 8)
    sim = QuantizationSimModel(tm, (x,), device="cpu")
    seeds = ["conv_1", "conv_2", "conv_3"]
    names = [n for s in seeds for n in (sim.graph.get_op(s).inputs[0].name,
                                        sim.graph.get_op(s).output.name)]
    caps = sim.collect_activations(None, (x,), names)
    act = {s: (caps[sim.graph.get_op(s).inputs[0].name],
               caps[sim.graph.get_op(s).output.name]) for s in seeds}
    model, _ = ModelCompressor.compress_model(
        tm, (x,), None, "channel_pruning",
        manual_ratios={s: 0.5 for s in seeds}, act_samples=act)
    graph = ConnectedGraph(tm, (x,))
    plan = plan_winnow(graph, {s: sorted(set(range(n)) - set(
        select_channels_to_keep(p, n // 2, 1).tolist()))
        for s, p, n in (("conv_1", tm.Conv_1.kernel.detach(), 8),
                        ("conv_2", tm.Conv_2.kernel.detach(), 12),
                        ("conv_3", tm.Conv_3.kernel.detach(), 12))})
    outs = [k for r, a, k in plan.layer_slices["conv_1"]
            if r == "kernel" and a == 0]
    assert len(outs) >= 2                    # removals in several deltas
    with torch.no_grad():
        out = model(x)
    assert out.shape == (2, 4, 8, 8) and torch.isfinite(out).all()
