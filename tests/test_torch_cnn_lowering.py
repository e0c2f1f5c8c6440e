"""The CNN slice of aimet_tpu_torch against aimet_tpu, on the same weights:
a small ResNet (one Bottleneck stage, 8 filters) and a narrow MobileNetV2
(width 0.25) on 32 x 32 inputs, flax-initialised with running statistics
drawn in numpy, carried across with ``convert.cnn_params_from_flax``. The
port runs NCHW, the JAX package NHWC; its lowering in Pallas interpret
mode.

Tolerances:
- float logits within 1e-5 of the max;
- op names and types, quantizer names and their per-channel-ness equal;
- parameter encodings bit for bit, activation encodings (each package
  calibrated by itself, min-max) within rtol 1e-5;
- with the JAX sim's encodings carried across: ``lowered_ops``,
  ``skipped_ops``, ``downgraded_ops``, ``op_modes``, the FLOP counts and
  ``int_flops_fraction`` equal in every mode; lowered logits within
  ``LOGIT_TOL`` (1e-5) of the max (see there).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aimet_tpu.models.mobilenet_v2 import MobileNetV2 as JaxMobileNetV2
from aimet_tpu.models.resnet import Bottleneck as JaxBottleneck
from aimet_tpu.models.resnet import ResNet as JaxResNet
from aimet_tpu.quantsim.config import QuantSimConfig as JaxConfig
from aimet_tpu.quantsim.lowering import lower_to_int as jax_lower
from aimet_tpu.quantsim.qsim import QuantizationSimModel as JaxSim
from aimet_tpu_torch import (QuantizationSimModel, QuantSimConfig, convert,
                             lower_to_int)
from aimet_tpu_torch.models.mobilenet_v2 import MobileNetV2
from aimet_tpu_torch.models.resnet import Bottleneck, ResNet
from torch_ptq_util import init_variables

FIELDS = ("min", "max", "delta", "offset")
MODES = [("w8", 8, False), ("w8a8", 8, False), ("w4", 4, False),
         ("w4a8", 4, False)]
# Lowered logits, max |port - JAX| / max |JAX|, in every mode (measured:
# at most 4.5e-7). The weight-only convs sum in another order; the integer
# convs give JAX's codes and sums bit for bit (tests/test_torch_int_conv.py),
# so their inputs' codes agree. The one quantizer fed by values that may
# round apart is w4a8's per-row quantizer on the pooled features (XLA's
# fused scale may be an ulp off the IEEE quotient, ROADMAP queue C, which
# moves x / scale by an ulp or two): on these inputs the closest of them
# lies 323 ulps of x / scale from a rounding boundary (measured, MobileNetV2;
# ResNet 6995), so no code flips and no looser limit is needed.
LOGIT_TOL = 1e-5


def _models():
    return {
        "resnet": (JaxResNet(stage_sizes=[1], block_cls=JaxBottleneck,
                             num_classes=10, num_filters=8),
                   lambda: ResNet([1], Bottleneck, num_classes=10,
                                  num_filters=8), 2),
        "mobilenet_v2": (JaxMobileNetV2(num_classes=10, width_mult=0.25),
                         lambda: MobileNetV2(num_classes=10,
                                             width_mult=0.25), 2),
    }


@functools.lru_cache(maxsize=None)
def _pair(name):
    """(jax apply fn, flax variables, torch model, x NHWC, batches NHWC):
    the weights drawn with numpy on the shapes of ``jax.eval_shape``
    (``torch_ptq_util.init_variables``: kernels N(0, 1 / fan_in), flax's
    LeCun normal untruncated; nothing compiled, where flax's eager ``init``
    took 8-16 s of this file's time), running means N(0, 0.1^2), variances
    in [0.5, 2)."""
    jm, make, batch = _models()[name]
    rs = np.random.RandomState(len(name))
    x = rs.randn(batch, 32, 32, 3).astype(np.float32)
    v = init_variables(jm, x, rs)
    v["batch_stats"] = _stats(v["batch_stats"], rs)
    tm = make()
    tm.load_state_dict(convert.cnn_params_from_flax(v))
    batches = [rs.randn(batch, 32, 32, 3).astype(np.float32)
               for _ in range(2)]
    jv = jax.tree_util.tree_map(jnp.asarray, v)
    return (lambda p, t: jm.apply(p, t)), jv, tm, x, batches


def _stats(tree, rs):
    """Running statistics drawn in numpy: every BatchNorm's ``mean`` from
    N(0, 0.1^2), its ``var`` from U[0.5, 2)."""
    if "var" in tree:
        c = tree["var"].shape
        return {"mean": (rs.randn(*c) * 0.1).astype(np.float32),
                "var": rs.uniform(0.5, 2.0, c).astype(np.float32)}
    return {k: _stats(s, rs) for k, s in tree.items()}


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@functools.lru_cache(maxsize=None)
def _sims(name, bw, per_channel=False):
    """JAX and port sims, each calibrated by itself (min-max)."""
    fn, v, tm, x, batches = _pair(name)
    js = JaxSim(fn, (v, jnp.asarray(x)), quant_scheme="minmax",
                default_param_bw=bw,
                config=JaxConfig.per_channel_default() if per_channel
                else None)
    js.compute_encodings(v, iter([jnp.asarray(b) for b in batches]))
    ts = QuantizationSimModel(
        tm, (_nchw(x),), quant_scheme="minmax", default_param_bw=bw,
        device="cpu",
        config=QuantSimConfig.per_channel_default() if per_channel else None)
    ts.compute_encodings(None, iter([_nchw(b) for b in batches]))
    return js, ts


@pytest.mark.parametrize("name", ["resnet", "mobilenet_v2"])
def test_cnn_graph_quantizers_and_encodings_match_jax(name):
    fn, v, tm, x, _ = _pair(name)
    want = np.asarray(fn(v, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(_nchw(x)).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    js, ts = _sims(name, 8)
    assert [(o.name, o.type) for o in ts.graph.ops] == \
        [(o.name, o.type) for o in js.graph.ops]
    assert {convert.port_param_name(k): s.channel_axis is None
            for k, s in js.quantizers.items()} == \
        {k: s.channel_axis is None for k, s in ts.quantizers.items()}
    for k, enc in js.encodings.items():
        tenc = ts.encodings[convert.port_param_name(k)]
        for f in FIELDS:
            want, got = np.asarray(getattr(enc, f)), getattr(tenc, f).numpy()
            if k.startswith("["):
                np.testing.assert_array_equal(got, want, err_msg=(k, f))
            else:
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7,
                                           err_msg=(k, f))


def _carried(name, bw, per_channel=False):
    """A port sim holding the JAX sim's encodings."""
    js, ts = _sims(name, bw, per_channel)
    for k, e in convert.encodings_from_jax(js.encodings,
                                           device="cpu").items():
        ts.set_encoding(k, e)
    return js, ts


@pytest.mark.parametrize("name,mode,bw,per_channel", [
    (name, *m) for name in ("resnet", "mobilenet_v2") for m in MODES] + [
    ("resnet", "w8a8", 8, True), ("resnet", "w4", 4, True)])
def test_cnn_lowering_matches_jax(name, mode, bw, per_channel):
    """Every mode with per-tensor weight grids (the default config), and
    on the ResNet w8a8 / w4 with per-channel ones (axis 3 of HWIO in the
    JAX package, axis 0 of OIHW here)."""
    fn, v, tm, x, _ = _pair(name)
    js, ts = _carried(name, bw, per_channel)
    if per_channel:
        assert all(s.channel_axis == 0 for k, s in ts.quantizers.items()
                   if k.endswith("kernel") and not k.startswith("Dense"))
    jl = jax_lower(js, v, mode=mode, use_pallas=True)
    tl = lower_to_int(ts, None, mode=mode)
    for f in ("lowered_ops", "skipped_ops", "downgraded_ops", "op_modes",
              "flops_lowered", "flops_total"):
        assert getattr(tl, f) == getattr(jl, f), f
    assert tl.int_flops_fraction == jl.int_flops_fraction
    assert tl.int_flops_fraction > 0.99 and not tl.skipped_ops
    want = np.asarray(jl(v, jnp.asarray(x)))
    got = tl(ts.params, _nchw(x)).numpy()
    assert np.isfinite(got).all() and got.shape == want.shape
    assert np.abs(got - want).max() <= LOGIT_TOL * np.abs(want).max()


class _ConvTranspose(torch.nn.Module):
    def __init__(self, kernel, groups, dilation):
        super().__init__()
        self.kernel = torch.nn.Parameter(kernel)
        self.groups, self.dilation = groups, dilation

    def forward(self, x):
        return torch.nn.functional.conv_transpose2d(
            x, self.kernel, None, 2, 1, 1, self.groups, self.dilation)


@pytest.mark.parametrize("groups,dilation,per_channel", [
    (1, 1, True), (2, 2, True), (2, 1, False)])
def test_conv_transpose_lowers_to_the_equivalent_conv(groups, dilation,
                                                      per_channel):
    """A transposed conv (stride 2, padding 1, output padding 1) lowers as
    the lhs-dilated conv with the flipped, per-group transposed kernel: in
    w8 it equals the float transposed conv of the fake-quantized weights,
    in w8a8 that of the fake-quantized input too (within 1e-5 of the max:
    the same grid values, summed in another order)."""
    rs = np.random.RandomState(groups)
    kernel = torch.from_numpy((rs.randn(4, 6 // groups, 3, 3) * 0.3)
                              .astype(np.float32))
    model = _ConvTranspose(kernel, groups, dilation)
    x = torch.from_numpy(rs.randn(2, 4, 7, 6).astype(np.float32))
    sim = QuantizationSimModel(
        model, (x,), quant_scheme="minmax", device="cpu",
        config=QuantSimConfig.per_channel_default() if per_channel else None)
    sim.compute_encodings(None, [x])
    (op,) = sim.graph.ops_of_type("conv_transpose")
    assert sim.quantizers["kernel"].channel_axis == (1 if per_channel
                                                     else None)
    w_fq = sim._qdq(kernel, "kernel", sim.encodings)
    x_fq = sim._qdq(x, "model_input_0", sim.encodings)
    for mode, xin in (("w8", x), ("w8a8", x_fq)):
        low = lower_to_int(sim, None, mode=mode)
        assert low.lowered_ops == [op.name] and not low.downgraded_ops
        got = low(sim.params, x)
        want = torch.nn.functional.conv_transpose2d(
            xin, w_fq, None, 2, 1, 1, groups, dilation)
        assert got.shape == want.shape
        assert (got - want).abs().max() <= 1e-5 * want.abs().max(), mode


def test_batchnorm_matches_flax_at_small_variances():
    """BatchNorm on its running statistics with flax's epsilon (1e-5): at
    variances near eps the epsilon decides the output, within 1e-6."""
    import flax.linen as fnn
    from aimet_tpu_torch.models.layers import BatchNorm
    rs = np.random.RandomState(7)
    x = rs.randn(2, 5, 5, 6).astype(np.float32) * 0.01
    stats = {"mean": (rs.randn(6) * 1e-3).astype(np.float32),
             "var": rs.uniform(1e-6, 1e-4, 6).astype(np.float32)}
    params = {"scale": rs.uniform(0.5, 1.5, 6).astype(np.float32),
              "bias": rs.randn(6).astype(np.float32)}
    want = fnn.BatchNorm(use_running_average=True).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))
    bn = BatchNorm(6)
    assert bn.eps == fnn.BatchNorm.epsilon == 1e-5
    bn.load_state_dict({k: torch.from_numpy(v) for k, v in
                        {**params, **stats}.items()})
    with torch.no_grad():
        got = bn(_nchw(x))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                               np.asarray(want), rtol=1e-6, atol=1e-6)


def test_odd_co_conv_lowers_like_jax_in_w4():
    """A conv with an odd number of output channels keeps its INT4 codes
    as int8 in w4 (no nibble pair to pack), as in the JAX package."""
    import flax.linen as fnn
    from aimet_tpu_torch.models.layers import Conv

    class JaxNet(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return fnn.relu(fnn.Conv(7, (3, 3), use_bias=False)(x))

    class TorchNet(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.Conv_0 = Conv(4, 7, (3, 3))

        def forward(self, x):
            return torch.relu(self.Conv_0(x))

    rs = np.random.RandomState(3)
    x = rs.randn(2, 9, 9, 4).astype(np.float32)
    jm = JaxNet()
    v = jax.tree_util.tree_map(np.asarray,
                               jm.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    tm = TorchNet()
    tm.load_state_dict(convert.cnn_params_from_flax(v))
    fn = lambda p, t: jm.apply(p, t)
    js = JaxSim(fn, (v, jnp.asarray(x)), quant_scheme="minmax",
                default_param_bw=4)
    js.compute_encodings(v, iter([jnp.asarray(x)]))
    ts = QuantizationSimModel(tm, (_nchw(x),), quant_scheme="minmax",
                              default_param_bw=4, device="cpu")
    for k, e in convert.encodings_from_jax(js.encodings,
                                           device="cpu").items():
        ts.set_encoding(k, e)
    jl = jax_lower(js, v, mode="w4", use_pallas=True)
    tl = lower_to_int(ts, None, mode="w4")
    assert tl.lowered_ops == jl.lowered_ops == ["conv_0"]
    want = np.asarray(jl(v, jnp.asarray(x)))
    got = tl(ts.params, _nchw(x)).numpy().transpose(0, 2, 3, 1)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("kind", ["conv1d", "negative padding"])
def test_convs_the_integer_path_cannot_take_stay_float(kind):
    """A conv whose weight is not 4-D, and a transposed conv whose
    equivalent padding would be negative, stay on the float path
    (``skipped_ops``), as the JAX package's layout and negative-padding
    checks leave them."""
    rs = np.random.RandomState(0)
    if kind == "conv1d":
        model = torch.nn.Conv1d(3, 4, 3, bias=False)
        x = torch.from_numpy(rs.randn(2, 3, 10).astype(np.float32))
    else:
        model = torch.nn.ConvTranspose2d(3, 4, 3, padding=3, bias=False)
        x = torch.from_numpy(rs.randn(2, 3, 10, 10).astype(np.float32))
    sim = QuantizationSimModel(model, (x,), quant_scheme="minmax",
                               device="cpu")
    sim.compute_encodings(None, [x])
    low = lower_to_int(sim, None, mode="w8")
    assert not low.lowered_ops and len(low.skipped_ops) == 1
    assert torch.allclose(low(sim.params, x), model(x), atol=1e-6)
