"""aimet_tpu_torch.algorithms' BN fold, CLE (with the high-bias fold) and
bias correction against the JAX package's, on tests/test_ptq.py's models
and MobileNetV2(num_classes=10, width_mult=0.25) at 32 x 32, the weights
made with numpy and carried across (tests/torch_ptq_util.py); the port's
results are carried back (OIHW -> HWIO, ``mean`` / ``var`` into
``batch_stats``) and compared leaf by leaf at tests/test_ptq.py's
``rtol=1e-4, atol=1e-5``, and the JAX test's own checks hold in the port.
Where a layer has no bias, the port's scaling also divides the folded
BN's shift (the JAX package does not, and moves the float outputs): the
MobileNetV2 comparison undoes that division, and a bias-free ResNet holds
its float outputs.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aimet_tpu.algorithms import bias_correction as jbc
from aimet_tpu.algorithms import bn_fold as jbf
from aimet_tpu.algorithms import cle as jcle
from aimet_tpu.graph.connected_graph import ConnectedGraph as JaxGraph
from aimet_tpu.quantsim.qsim import QuantizationSimModel as JaxSim
from aimet_tpu_torch import QuantizationSimModel
from aimet_tpu_torch.algorithms import (bn_affine_params, correct_bias,
                                        correct_bias_analytical,
                                        equalize_model, find_cls_sets,
                                        find_foldable_pairs,
                                        fold_all_batch_norms, scale_cls_sets)
from aimet_tpu_torch.algorithms import cle as tcle
from aimet_tpu_torch.graph.connected_graph import ConnectedGraph
from aimet_tpu_torch.models.resnet import Bottleneck, ResNet
from torch_ptq_util import (ConvBnConv, assert_tree_close, from_flax,
                            init_variables, nchw, nhwc, one_thread, pair,
                            to_flax)

RTOL, ATOL = 1e-4, 1e-5


@functools.lru_cache(maxsize=None)
def _graphs(name, kernel_scale=None):
    """(jax fn, variables (numpy), jax variables, jax graph, port model,
    port graph, port params, x, rs)."""
    fn, v, tm, x, rs = pair(name, kernel_scale=kernel_scale)
    jv = jax.tree_util.tree_map(jnp.asarray, v)
    jg = JaxGraph(fn, (jv, jnp.asarray(x)))
    tg = ConnectedGraph(tm, (nchw(x),))
    params = {k: p.detach() for k, p in tm.named_parameters()}
    return fn, v, jv, jg, tm, tg, params, x, rs


def _forward(tm, params, x):
    with torch.no_grad():
        return torch.func.functional_call(tm, params, (nchw(x),))


def test_affine_extraction_matches_formula_and_jax():
    fn, v, jv, jg, tm, tg, params, x, _ = _graphs("conv_bn_relu")
    (bn,) = tg.ops_of_type("batchnorm")
    a, b = bn_affine_params(tg, params, bn, channel_axis=1)
    stats, p = v["batch_stats"]["BatchNorm_0"], v["params"]["BatchNorm_0"]
    a_ref = p["scale"] / np.sqrt(stats["var"] + 1e-5)
    b_ref = p["bias"] - stats["mean"] * a_ref
    np.testing.assert_allclose(a.numpy(), a_ref, rtol=RTOL)
    np.testing.assert_allclose(b.numpy(), b_ref, rtol=RTOL, atol=ATOL)
    ja, jb = jbf.bn_affine_params(jg, jv, jg.ops_of_type("batchnorm")[0], 3)
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=1e-6)
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("name", ["conv_bn_relu", "conv_bn_relu_nobias",
                                  "tiny_cnn"])
def test_fold_matches_jax_and_preserves_outputs(name):
    fn, v, jv, jg, tm, tg, params, x, rs = _graphs(name)
    assert [(a.name, b.name) for a, b in find_foldable_pairs(tg)] == \
        [(a.name, b.name) for a, b in jbf.find_foldable_pairs(jg)]
    folded = fold_all_batch_norms(tg, params)
    assert_tree_close(to_flax(folded, v), jbf.fold_all_batch_norms(jg, jv),
                      RTOL, ATOL)
    xb = rs.randn(*x.shape).astype(np.float32)
    np.testing.assert_allclose(_forward(tm, folded, xb).numpy(),
                               _forward(tm, params, xb).numpy(), rtol=RTOL,
                               atol=ATOL)
    # the folded BN is the identity scaling
    a, _ = bn_affine_params(tg, folded, tg.ops_of_type("batchnorm")[0], 1)
    np.testing.assert_allclose(a.numpy(), np.ones(a.shape), rtol=RTOL)
    # the caller's params are untouched
    assert all(torch.equal(params[k], p.detach())
               for k, p in tm.named_parameters())


@pytest.mark.parametrize("name,sets", [("conv_bn_conv", [2]),
                                       ("dw_separable", [3]),
                                       ("mobilenet_v2",
                                        [2] + [3] * 16 + [2])])
def test_cls_sets_match_jax(name, sets):
    fn, v, jv, jg, tm, tg, params, x, _ = _graphs(name)
    got = [tuple(op.name for op in s) for s in find_cls_sets(tg)]
    assert got == [tuple(op.name for op in s)
                   for s in jcle.find_cls_sets(jg)]
    assert [len(s) for s in got] == sets


def test_scaling_matches_jax_and_equalizes():
    fn, v, jv, jg, tm, tg, params, x, rs = _graphs("conv_bn_conv", (-2, 2))
    folded = fold_all_batch_norms(tg, params)
    scaled, info = scale_cls_sets(tg, folded)
    jscaled, jinfo = jcle.scale_cls_sets(jg, jbf.fold_all_batch_norms(jg, jv))
    assert_tree_close(to_flax(scaled, v), jscaled, RTOL, ATOL)
    for k, d in info.items():
        np.testing.assert_allclose(d["scale"].numpy(), jinfo[k]["scale"],
                                   rtol=RTOL)
    xb = np.abs(rs.randn(*x.shape)).astype(np.float32)
    np.testing.assert_allclose(_forward(tm, scaled, xb).numpy(),
                               _forward(tm, folded, xb).numpy(), rtol=1e-3,
                               atol=1e-4)

    def spread(w):
        r = w.abs().amax(dim=(1, 2, 3))
        return float(r.max() / r.min())

    assert spread(scaled["Conv_0.kernel"]) < \
        spread(folded["Conv_0.kernel"]) / 10


@pytest.mark.parametrize("name", ["conv_bn_conv", "dw_separable",
                                  "mobilenet_v2"])
def test_equalize_model_matches_jax(name):
    """On MobileNetV2 (no conv biases) the port also divides the folded
    BN's shift by the layer's scale, which the JAX package leaves out
    (cle.py's docstring): there each such BN ``bias`` times S equals the
    JAX package's, and every other leaf equals it."""
    fn, v, jv, jg, tm, tg, params, x, rs = _graphs(name)
    eq = equalize_model(tg, params)
    want = jcle.equalize_model(jg, jv)
    if name == "mobilenet_v2":
        _, info = scale_cls_sets(tg, fold_all_batch_norms(tg, params))
        undo = dict(eq)
        for layer, d in info.items():
            for bn in tcle._path_to_next(tg.get_op(layer))[1]:
                if bn.type == "batchnorm":
                    path = tcle._bn_role_paths(bn)["bias"]
                    undo[path] = eq[path] * d["scale"]
        assert any(not torch.equal(undo[k], eq[k]) for k in eq)
        assert_tree_close(to_flax(undo, v), want, RTOL, ATOL)
        return
    assert_tree_close(to_flax(eq, v), want, RTOL, ATOL)
    # the high-bias fold is exact only in the relus' linear region:
    # closeness, as tests/test_ptq.py asks
    xb = np.abs(rs.randn(4, *x.shape[1:])).astype(np.float32)
    out0, out1 = _forward(tm, params, xb), _forward(tm, eq, xb)
    assert float((out1 - out0).abs().mean() / out0.abs().mean()) < 0.2


def test_equalize_keeps_a_bias_free_resnets_outputs():
    """ResNet's convs have no bias: the folded BNs keep their shifts, which
    the scaling divides too, so BN fold and cross-layer scaling (and no
    high-bias fold: no layer bias to take it) leave the float outputs as
    they were, through ReLU."""
    rs = np.random.RandomState(5)
    tm = ResNet([1, 1], Bottleneck, num_classes=10, num_filters=8)
    with torch.no_grad():
        for n, p in tm.named_parameters():
            leaf = n.rsplit(".", 1)[-1]
            v = rs.randn(*p.shape).astype(np.float32)
            p.copy_(torch.from_numpy(
                np.abs(v) + 0.5 if leaf == "var" else
                np.abs(v) * 0.5 + 0.5 if leaf == "scale" else v * 0.3))
    x = torch.from_numpy(rs.randn(2, 3, 32, 32).astype(np.float32))
    tg = ConnectedGraph(tm, (x,))
    params = {k: p.detach() for k, p in tm.named_parameters()}
    _, info = scale_cls_sets(tg, fold_all_batch_norms(tg, params))
    assert len(info) == 4
    eq = equalize_model(tg, params)
    with torch.no_grad():
        ref = tm(x)
        out = torch.func.functional_call(tm, eq, (x,))
    assert float((out - ref).abs().max() / ref.abs().max()) < 1e-5


def test_equalization_improves_per_tensor_int8():
    """tests/test_ptq.py's DFQ claim in miniature, built as that test
    builds it (its model, its BN randomization, its seed, its batch; the
    initial weights drawn with numpy), carried into the port."""
    import test_ptq as jax_tests
    rng = np.random.RandomState(0)
    model = jax_tests.ConvBnConv()
    v = init_variables(model, np.ones((2, 8, 8, 3), np.float32), rng)
    v = jax_tests.randomize_bn(v, rng)
    k0 = v["params"]["Conv_0"]["kernel"]
    v["params"]["Conv_0"]["kernel"] = k0 * jnp.asarray(
        np.logspace(-2, 1, k0.shape[-1]).astype(np.float32))
    tm = ConvBnConv()
    tm.load_state_dict(from_flax(v))
    xb = nchw(rng.randn(8, 8, 8, 3).astype(np.float32))
    tg = ConnectedGraph(tm, (xb,))
    folded = fold_all_batch_norms(tg, {k: p.detach() for k, p in
                                       tm.named_parameters()})
    scaled, _ = scale_cls_sets(tg, folded)

    def int8_err(p):
        sim = QuantizationSimModel(tm, (xb,), quant_scheme="minmax",
                                   device="cpu")
        sim.compute_encodings(p, [xb])
        ref = torch.func.functional_call(tm, p, (xb,))
        return float((sim.quantized_fn(p, xb) - ref).abs().mean())

    with torch.no_grad():
        assert int8_err(scaled) < int8_err(folded)


def _bias_sims(name="conv_bn_conv"):
    fn, v, tm, x, rs = pair(name)
    batches = [rs.randn(4, *x.shape[1:]).astype(np.float32)
               for _ in range(3)]
    jv = jax.tree_util.tree_map(jnp.asarray, v)
    js = JaxSim(fn, (jv, jnp.asarray(batches[0])), quant_scheme="minmax",
                default_param_bw=4)
    ts = QuantizationSimModel(tm, (nchw(batches[0]),), quant_scheme="minmax",
                              default_param_bw=4, device="cpu")
    return v, jv, js, tm, ts, batches


def test_bias_correction_matches_jax_and_reduces_error():
    v, jv, js, tm, ts, batches = _bias_sims()
    js.compute_encodings(jv, iter([jnp.asarray(b) for b in batches]))
    ts.compute_encodings(None, [nchw(b) for b in batches])
    want = jbc.correct_bias(js, jv, [jnp.asarray(b) for b in batches])
    got = correct_bias(ts, None, [nchw(b) for b in batches])
    assert_tree_close(to_flax(got, v), want, RTOL, ATOL)
    xb = nchw(batches[0])
    ref = ts.fp_fn(None, xb)
    err_before = (ts.quantized_fn(None, xb) - ref).abs().mean()
    err_after = (ts.quantized_fn(got, xb) - ref).abs().mean()
    assert err_after < err_before


def test_analytical_bias_correction_matches_jax():
    v, jv, js, tm, ts, batches = _bias_sims()
    js.compute_param_encodings(jv)
    want = jbc.correct_bias_analytical(js, jv)
    got = correct_bias_analytical(ts, None)
    assert_tree_close(to_flax(got, v), want, RTOL, ATOL)
    assert not torch.allclose(got["Conv_1.bias"], ts.params["Conv_1.bias"])
    # relu6 and identity expectations against the JAX closed forms
    rs = np.random.RandomState(1)
    gamma = np.abs(rs.randn(16)).astype(np.float32) + 0.1
    beta = rs.randn(16).astype(np.float32) * 3
    from aimet_tpu_torch.algorithms import bias_correction as tbc
    for act in ("none", "relu", "relu6"):
        np.testing.assert_allclose(
            tbc._expectation_through_activation(
                torch.from_numpy(gamma), torch.from_numpy(beta), act).numpy(),
            np.asarray(jbc._expectation_through_activation(
                jnp.asarray(gamma), jnp.asarray(beta), act)),
            rtol=1e-5, atol=1e-6)


def test_mobilenet_v2_equalize_and_correct_bias():
    """The PTQ phase chip_smoke.py runs on MobileNetV2, at 32 x 32 on the
    CPU: equalize, calibrate, correct the biases on 2 batches; the
    per-channel mean of the quantized model's error shrinks."""
    fn, v, jv, jg, tm, tg, params, x, rs = _graphs("mobilenet_v2")
    eq = equalize_model(tg, params)
    batches = [nchw(rs.rand(*x.shape).astype(np.float32)) for _ in range(2)]
    sim = QuantizationSimModel(tm, (batches[0],), quant_scheme="sqnr",
                               device="cpu")
    sim.compute_encodings(eq, batches)
    corrected = correct_bias(sim, eq, batches)
    changed = [k for k in eq if not torch.equal(eq[k], corrected[k])]
    assert changed and all(k.endswith("bias") for k in changed)
    ref = sim.fp_fn(eq, batches[0])
    shift = lambda p: float((sim.quantized_fn(p, batches[0]) - ref)
                            .mean(dim=0).abs().mean())
    assert shift(corrected) < shift(eq)


def test_pytree_helpers_never_write_into_the_callers_params():
    from aimet_tpu_torch.utils.pytree import get_leaf, leaf_index_map, \
        set_leaves
    params = {"a.kernel": torch.ones(2), "b.bias": torch.zeros(3)}
    assert leaf_index_map(params) == {"a.kernel": 0, "b.bias": 1}
    assert get_leaf(params, "b.bias") is params["b.bias"]
    new = set_leaves(params, {"a.kernel": torch.full((2,), 5.0)})
    assert torch.equal(params["a.kernel"], torch.ones(2))
    assert torch.equal(new["a.kernel"], torch.full((2,), 5.0))
    assert new["b.bias"] is params["b.bias"] and list(new) == list(params)
    with pytest.raises(KeyError):
        set_leaves(params, {"c": torch.ones(1)})
    with pytest.raises(KeyError):
        get_leaf(params, "c")


def test_resolve_var_and_out_tree_match_jax():
    """``ConnectedGraph.resolve_var`` and ``evaluate_with_replacements(...,
    out_tree=)`` against the JAX package's: the last conv replaced by a
    function of its input, the output regrouped as a 1-tuple."""
    from torch.utils import _pytree

    from aimet_tpu.graph.interpreter import \
        evaluate_with_replacements as jax_evaluate
    from aimet_tpu_torch.graph.interpreter import evaluate_with_replacements
    fn, v, jv, jg, tm, tg, params, x, rs = _graphs("conv_bn_conv")
    for node in tg.nodes:
        assert tg.resolve_var(node) is tg.resolve(node)
    op = tg.get_op("conv_1")
    assert tg.resolve_var(op.attrs["x_node"]) is op.inputs[0].node
    want = jax_evaluate(jg, jv, (jnp.asarray(x),),
                        {"conv_1": lambda t: t[..., :4] * 2.0},
                        out_tree=jax.tree_util.tree_structure((0,)))
    got = evaluate_with_replacements(
        tg, params, (nchw(x),), {"conv_1": lambda t: t[:, :4] * 2.0},
        out_tree=_pytree.tree_structure((torch.zeros(1),)))
    assert isinstance(got, tuple) and isinstance(want, tuple)
    np.testing.assert_allclose(nhwc(got[0]), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-6)
