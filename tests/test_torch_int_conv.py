"""aimet_tpu_torch.ops.int_conv and ops.requant against aimet_tpu's, on
the same numpy inputs (CPU; the JAX package's Pallas matmuls in interpret
mode). The port is NCHW / OIHW, the JAX package NHWC / HWIO: inputs and
results are transposed between them.

Tolerances:
- weight codes, scales, packed INT4 conv bytes and int32 conv sums bit
  for bit;
- the static and dynamic INT8 convs bit for bit (the same integer sums,
  the same f32 epilogue in the same order);
- the weight-only convs within 1e-6 in f32 (float convolutions of the two
  libraries sum in different orders) and 1e-2 of the max in bf16;
- the im2col wrappers within the JAX tests' bounds: 2e-5 (w8), 2e-4 (w4),
  and 2e-5 for w8a8 (the same codes, sums and epilogue; f32 only);
- the requant helpers bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aimet_tpu.ops import int_conv as jic
from aimet_tpu.ops import requant as jrq
from aimet_tpu_torch.ops import int_conv as tic
from aimet_tpu_torch.ops import requant as trq


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x,
                                                              (0, 3, 1, 2))))


def _oihw(w):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(w,
                                                              (3, 2, 0, 1))))


def _nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


def _hwio(t):
    return np.transpose(t.numpy(), (2, 3, 1, 0))


@pytest.fixture
def data():
    rs = np.random.RandomState(0)
    x = rs.randn(2, 12, 12, 8).astype(np.float32)
    w = (rs.randn(3, 3, 8, 16) * 0.2).astype(np.float32)
    return x, w


def test_conv_weight_quantizers_bit_exact(data):
    _, w = data
    for jf, tf in ((jic.quantize_conv_weight_per_channel,
                    tic.quantize_conv_weight_per_channel),
                   (jic.quantize_conv_weight_int4,
                    tic.quantize_conv_weight_int4)):
        jq, js = jf(jnp.asarray(w))
        tq, ts = tf(_oihw(w))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("kind,tol", [("w8", 2e-5), ("w8a8", 2e-5),
                                      ("w4", 2e-4)])
@pytest.mark.parametrize("strides,padding,dil", [
    ((1, 1), "SAME", None), ((2, 2), "VALID", None),
    ((2, 1), ((1, 2), (0, 1)), (2, 1))])
def test_im2col_convs_match_jax(data, kind, tol, strides, padding, dil):
    x, w = data
    quant = (jic.quantize_conv_weight_int4 if kind == "w4"
             else jic.quantize_conv_weight_per_channel)
    wq, s = quant(jnp.asarray(w))
    jfn = getattr(jic, f"conv2d_{kind}")
    tfn = getattr(tic, f"conv2d_{kind}")
    want = np.asarray(jfn(jnp.asarray(x), wq, s, (3, 3), strides=strides,
                          padding=padding, rhs_dilation=dil))
    got = tfn(_nchw(x), torch.from_numpy(np.array(wq)),
              torch.from_numpy(np.array(s)), (3, 3), strides=strides,
              padding=padding, rhs_dilation=dil)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_nhwc(got), want, rtol=tol, atol=tol)


# strides, padding, groups, lhs_dilation (transposed), rhs_dilation, fill
CORE = [
    ((1, 1), ((1, 1), (1, 1)), 1, None, None, 0),
    ((2, 2), ((0, 1), (0, 1)), 1, None, None, -37),
    ((1, 2), ((2, 0), (1, 3)), 1, None, (2, 1), 5),
    ((1, 1), ((2, 2), (2, 2)), 1, (2, 2), None, -128),       # transposed
    ((2, 2), ((1, 1), (1, 1)), 8, None, None, -20),          # depthwise
    ((1, 1), ((1, 1), (0, 0)), 2, (2, 1), (1, 2), 3),        # grouped
]


def _int8(rs, shape):
    return rs.randint(-128, 128, shape).astype(np.int8)


@pytest.mark.parametrize("strides,padding,groups,lhs,rhs,fill", CORE)
def test_conv_int_core_sums_bit_exact(strides, padding, groups, lhs, rhs,
                                      fill):
    rs = np.random.RandomState(groups)
    xq = _int8(rs, (2, 9, 10, 8))
    wq = _int8(rs, (3, 3, 8 // groups, 8 if groups > 1 else 12))
    kw = dict(strides=strides, padding=padding, feature_group_count=groups,
              lhs_dilation=lhs, rhs_dilation=rhs, fill=fill)
    want = np.asarray(jic.conv_int_core(jnp.asarray(xq), jnp.asarray(wq),
                                        **kw))
    got = tic.conv_int_core(_nchw(xq), _oihw(wq), **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_nhwc(got), want)


def test_conv_int_core_stem_kmajor_bit_exact():
    """ResNet-50's stem (7 x 7 / 2, 3 -> 64: K = 147, not a multiple of
    16): the patch rows padded to 160 bytes and the K-major weight view
    give the JAX package's int32 sums bit for bit."""
    rs = np.random.RandomState(7)
    xq = _int8(rs, (2, 20, 20, 3))
    wq = _int8(rs, (7, 7, 3, 64))
    kw = dict(strides=(2, 2), padding=((3, 3), (3, 3)), fill=-3)
    want = np.asarray(jic.conv_int_core(jnp.asarray(xq), jnp.asarray(wq),
                                        **kw))
    got = tic.conv_int_core(_nchw(xq), _oihw(wq), **kw)
    np.testing.assert_array_equal(_nhwc(got), want)
    p, _ = tic._int_patches(_nchw(xq), (7, 7), (2, 2), None)
    assert p.shape[1] == 147 and p.stride(0) == 160
    wk = tic._weight_kmajor(_oihw(wq))
    assert wk.shape == (147, 64) and wk.stride() == (1, 160)


def test_conv_weight_kmajor_is_a_view_when_k_is_aligned():
    """At K % 16 == 0 the K-major weight is the OIHW tensor itself,
    transposed: no per-call copy."""
    w = torch.randint(-127, 128, (128, 128, 3, 3), dtype=torch.int8)
    wk = tic._weight_kmajor(w)
    assert wk.data_ptr() == w.data_ptr() and wk.stride() == (1, 1152)
    assert torch.equal(wk, tic._weight_2d(w))


def _static_args(rs, shape, groups, co):
    x = (rs.rand(*shape).astype(np.float32) * 4 - 1)
    wq = rs.randint(-127, 128, (3, 3, shape[-1] // groups, co)).astype(
        np.int8)
    ws = rs.uniform(0.001, 0.01, co).astype(np.float32)
    return x, wq, ws


@pytest.mark.parametrize("strides,padding,groups,lhs,rhs,_", CORE)
def test_static_and_dynamic_int8_convs_bit_exact(strides, padding, groups,
                                                 lhs, rhs, _):
    rs = np.random.RandomState(7 + groups)
    x, wq, ws = _static_args(rs, (2, 9, 10, 8), groups, 8)
    kw = dict(strides=strides, padding=padding, feature_group_count=groups,
              lhs_dilation=lhs, rhs_dilation=rhs)
    enc = (np.float32(5.0 / 255), np.float32(-51.0), 255.0)
    want = np.asarray(jic.conv2d_int8_static(
        jnp.asarray(x), jnp.asarray(wq), jnp.asarray(ws), *enc, **kw))
    got = tic.conv2d_int8_static(_nchw(x), _oihw(wq), torch.from_numpy(ws),
                                 *enc, **kw)
    np.testing.assert_array_equal(_nhwc(got), want)
    want = np.asarray(jic.conv2d_w8a8_dynamic(
        jnp.asarray(x), jnp.asarray(wq), jnp.asarray(ws), **kw))
    got = tic.conv2d_w8a8_dynamic(_nchw(x), _oihw(wq), torch.from_numpy(ws),
                                  **kw)
    np.testing.assert_array_equal(_nhwc(got), want)


# grouped convs whose per-group K (ci/g * kh * kw) is far above the
# 2^24 / (128 * 128) = 1024 that an f32 conv would hold exactly
@pytest.mark.parametrize("ci,groups,k", [(512, 2, 3), (96, 2, 5)])
def test_wide_grouped_int8_convs_bit_exact(ci, groups, k):
    rs = np.random.RandomState(ci + k)
    xq = _int8(rs, (1, 7, 6, ci))
    wq = rs.randint(-127, 128, (k, k, ci // groups, 32)).astype(np.int8)
    ws = rs.uniform(0.001, 0.01, 32).astype(np.float32)
    kw = dict(strides=(1, 1), padding=((1, 1), (2, 0)),
              feature_group_count=groups)
    want = np.asarray(jic.conv_int_core(jnp.asarray(xq), jnp.asarray(wq),
                                        fill=-3, **kw))
    got = tic.conv_int_core(_nchw(xq), _oihw(wq), fill=-3, **kw)
    np.testing.assert_array_equal(_nhwc(got), want)
    assert np.abs(want).max() >= 2 ** 17
    x = (rs.rand(1, 7, 6, ci).astype(np.float32) * 4 - 1)
    enc = (np.float32(5.0 / 255), np.float32(-51.0), 255.0)
    want = np.asarray(jic.conv2d_int8_static(
        jnp.asarray(x), jnp.asarray(wq), jnp.asarray(ws), *enc, **kw))
    got = tic.conv2d_int8_static(_nchw(x), _oihw(wq), torch.from_numpy(ws),
                                 *enc, **kw)
    np.testing.assert_array_equal(_nhwc(got), want)
    want = np.asarray(jic.conv2d_w8a8_dynamic(
        jnp.asarray(x), jnp.asarray(wq), jnp.asarray(ws), **kw))
    got = tic.conv2d_w8a8_dynamic(_nchw(x), _oihw(wq), torch.from_numpy(ws),
                                  **kw)
    np.testing.assert_array_equal(_nhwc(got), want)


@pytest.mark.parametrize("co", [16, 6])
def test_int4_conv_packing_bit_exact(co):
    q = np.random.RandomState(co).randint(-7, 8, (3, 3, 4, co)).astype(
        np.int8)
    jp = np.asarray(jic.pack_int4_conv_co(jnp.asarray(q)))
    tp = tic.pack_int4_conv_co(_oihw(q))
    np.testing.assert_array_equal(_hwio(tp), jp)
    np.testing.assert_array_equal(_hwio(tic.unpack_int4_conv_co(tp)), q)
    np.testing.assert_array_equal(
        np.asarray(jic.unpack_int4_conv_co(jnp.asarray(jp))), q)


@pytest.mark.parametrize("bits,co,dtype,core", [
    (8, 8, "float32", 2), (4, 8, "float32", 2), (8, 7, "float32", 2),
    (8, 8, "float32", 3), (4, 8, "float32", 3), (8, 7, "float32", 3),
    (8, 8, "float32", 4), (4, 8, "float32", 4), (4, 8, "bfloat16", 4),
    (4, 8, "bfloat16", 3)])      # co 7: the odd-co INT4 codes held as int8
def test_weight_only_conv_matches_jax(bits, co, dtype, core):
    strides, padding, groups, lhs, rhs, _ = CORE[core]
    rs = np.random.RandomState(bits + co)
    x, _, ws = _static_args(rs, (2, 9, 10, 8), groups, co)
    lim = 7 if bits == 4 or co % 2 else 127     # odd co: INT4 codes as int8
    wq = rs.randint(-lim, lim + 1, (3, 3, 8 // groups, co)).astype(np.int8)
    kw = dict(strides=strides, padding=padding, feature_group_count=groups,
              lhs_dilation=lhs, rhs_dilation=rhs)
    jw = jic.pack_int4_conv_co(jnp.asarray(wq)) if bits == 4 else \
        jnp.asarray(wq)
    tw = tic.pack_int4_conv_co(_oihw(wq)) if bits == 4 else _oihw(wq)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    want = np.asarray(jic.conv2d_weight_only(
        jx, jw, jnp.asarray(ws), bits=bits, out_dtype=jnp.float32, **kw))
    got = _nhwc(tic.conv2d_weight_only(
        _nchw(x).to(getattr(torch, dtype)), tw, torch.from_numpy(ws),
        bits=bits, out_dtype=torch.float32, **kw))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()


def test_requant_helpers_bit_exact():
    rs = np.random.RandomState(3)
    for x in (0.7, 1.5e-3, 3.0, 65535.9, 2.0 ** -130):
        assert trq.get_scale_factor(x) == jrq.get_scale_factor(x)
    bias = rs.randn(6).astype(np.float32)
    ws = rs.uniform(0.01, 0.1, 6).astype(np.float32)
    for wrap in (False, True):
        want = jrq.requant_scale_and_bias(jnp.asarray(bias), 0.05,
                                          jnp.asarray(ws), 0.2, 3.0, wrap)
        got = trq.requant_scale_and_bias(torch.from_numpy(bias), 0.05,
                                         torch.from_numpy(ws), 0.2, 3.0, wrap)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        for w_s in (ws, ws[:1]):
            for bw in (8, 16):
                args = (bias, w_s, 0.05, 0.2, 4.0, bw, wrap)
                for g, w in zip(trq.get_rescaled_output_and_bias(*args),
                                jrq.get_rescaled_output_and_bias(*args)):
                    np.testing.assert_array_equal(g, w)
    acc = rs.randint(-5000, 5000, (4, 6)).astype(np.int32)
    rq, bq = (rs.uniform(0.001, 0.01, 6).astype(np.float32),
              rs.randn(6).astype(np.float32))
    for signed in (False, True):
        want = jrq.requantize(jnp.asarray(acc), jnp.asarray(rq),
                              jnp.asarray(bq), 3.0, 8, signed)
        got = trq.requantize(torch.from_numpy(acc), torch.from_numpy(rq),
                             torch.from_numpy(bq), 3.0, 8, signed)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
