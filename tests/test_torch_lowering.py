"""aimet_tpu_torch.quantsim.lowering and the new integer matmuls against
aimet_tpu's, on the same weights, inputs and encodings (the JAX sim's,
carried across with ``convert.encodings_from_jax``), with ``device="cpu"``
(the kernels' plain versions) against JAX's ``lower_to_int(...,
use_pallas=True)`` in Pallas interpret mode.

Tolerances, as max |port - JAX| / max |JAX|:
- ``lowered_ops``, ``skipped_ops``, ``downgraded_ops`` and ``op_modes``
  equal in every mode;
- weight-only modes (w8, w4) and group-wise INT4 within 1e-5;
- static-INT8 activations (w8a8, auto at 8 bits, the grouped models'
  w8a8 lm_head) within 1e-5: the codes come from the same frozen
  encodings by the same FMA;
- per-row dynamic INT8 activations (w4a8, auto at 4 bits) within 5e-2 of
  the max and 5e-3 on average: the JAX kernel computes x / scale inside
  an XLA fusion on the CPU, which is not always an IEEE division (ROADMAP
  queue C), so a code now and then lands one level off, and 15 layers of
  attention spread it over later positions (measured: 2.1e-2 max, 1.4e-3
  mean);
- ``matmul_w8a8_staticq_torch`` codes and outputs bit for bit;
  ``quantize_weight_int4_grouped`` bit for bit; ``matmul_w4_grouped_torch``
  within 1e-5 of both JAX kernel bodies (scales on the weight tile, and on
  the accumulator at M <= 64).
"""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aimet_tpu.ops import int_matmul as jim
from aimet_tpu.quantsim.lowering import lower_to_int as jax_lower
from aimet_tpu.quantsim.qsim import QuantizationSimModel as JaxSim
from aimet_tpu_torch import QuantizationSimModel, lower_to_int
from aimet_tpu_torch.ops import int_matmul as tim
from torch_quantsim_util import (carry_encodings, jax_mlp, mlp_pair,
                                 tiny_pair, to_torch)

LISTS = ("lowered_ops", "skipped_ops", "downgraded_ops", "op_modes")


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _check(jl, tl, want, got, dynamic_a8=False):
    for f in LISTS:
        assert getattr(tl, f) == getattr(jl, f), f
    assert tl.flops_total == jl.flops_total
    assert tl.flops_lowered == jl.flops_lowered
    got = got.detach().numpy()
    assert np.isfinite(got).all() and got.shape == want.shape
    d = np.abs(got - want) / np.abs(want).max()
    if dynamic_a8:
        assert d.max() < 5e-2 and d.mean() < 5e-3
    else:
        assert d.max() < 1e-5


def _copy_sim(sim):
    out = copy.copy(sim)
    out.quantizers = dict(sim.quantizers)
    out._encodings = dict(sim._encodings)
    return out


@pytest.fixture(scope="module")
def tiny():
    """JAX and port sims on tiny at param bitwidths 8 and 4; the port's
    encodings are the JAX sim's (min-max calibration)."""
    fn, variables, tm, tok, batches = tiny_pair()
    sims = {}
    for bw in (8, 4):
        js = JaxSim(fn, (variables, jnp.asarray(tok)), quant_scheme="minmax",
                    default_param_bw=bw)
        js.compute_encodings(variables, iter([jnp.asarray(batches[0])]))
        ts = QuantizationSimModel(tm, (to_torch(tok),), default_param_bw=bw,
                                  device="cpu")
        carry_encodings(js, ts)
        sims[bw] = (js, ts)
    return sims, variables, tok


@pytest.mark.parametrize("mode,bw", [
    ("w8", 8), ("w8a8", 8), ("w4", 4), ("w4a8", 4), ("auto", 4),
    ("auto", 8), ("w4", 8),
])
def test_tiny_lowering_matches_jax(tiny, mode, bw):
    sims, variables, tok = tiny
    js, ts = sims[bw]
    jl = jax_lower(js, variables, mode=mode, use_pallas=True)
    tl = lower_to_int(ts, None, mode=mode)
    want = np.asarray(jl(variables, jnp.asarray(tok)))
    got = tl(ts.params, to_torch(tok))
    _check(jl, tl, want, got, dynamic_a8=mode == "w4a8" or (
        mode == "auto" and bw == 4))
    if mode == "w4" and bw == 8:        # 8-bit grids cannot pack to INT4
        assert not tl.lowered_ops and len(tl.skipped_ops) == 15
    else:
        assert len(tl.lowered_ops) == 15


@pytest.mark.parametrize("lpbq", [False, True], ids=["blockwise", "lpbq"])
def test_tiny_grouped_int4_lowering_matches_jax(tiny, lpbq):
    """Blockwise / LPBQ 4-bit layer linears (block 16) -> group-wise INT4;
    lm_head stays per tensor and lowers in w8a8."""
    sims, variables, tok = tiny
    js, ts = (_copy_sim(s) for s in sims[8])
    for op in ts.graph.ops_of_type("linear")[:-1]:
        name = op.param_products["kernel"].param_path
        ts.set_param_blockwise(None, name, 16, lpbq=lpbq)
        jname = "['params']" + "".join(f"['{p}']" for p in name.split("."))
        js.set_param_blockwise(variables, jname, 16, lpbq=lpbq)
    jl = jax_lower(js, variables, mode="w8a8", use_pallas=True)
    tl = lower_to_int(ts, None, mode="w8a8")
    assert list(tl.op_modes.values()).count("w4_grouped") == 14
    assert tl.op_modes["linear_14"] == "w8a8"
    want = np.asarray(jl(variables, jnp.asarray(tok)))
    _check(jl, tl, want, tl(ts.params, to_torch(tok)))


def test_tiny_grouped_int4_lowering_block_8_matches_jax(tiny):
    """Blockwise 4-bit layer linears with block 8, a group size that is
    not a multiple of 16 (the JAX package takes its XLA route; the port's
    KW4G takes every group size dividing K/2)."""
    sims, variables, tok = tiny
    js, ts = (_copy_sim(s) for s in sims[8])
    for op in ts.graph.ops_of_type("linear")[:-1]:
        name = op.param_products["kernel"].param_path
        ts.set_param_blockwise(None, name, 8)
        jname = "['params']" + "".join(f"['{p}']" for p in name.split("."))
        js.set_param_blockwise(variables, jname, 8)
    jl = jax_lower(js, variables, mode="w8a8", use_pallas=True)
    tl = lower_to_int(ts, None, mode="w8a8")
    assert list(tl.op_modes.values()).count("w4_grouped") == 14
    want = np.asarray(jl(variables, jnp.asarray(tok)))
    _check(jl, tl, want, tl(ts.params, to_torch(tok)))


@pytest.fixture(scope="module")
def mlp():
    """Both packages' sims of the MLP at param bitwidths 8 and 4, each
    calibrated by itself (min-max)."""
    params, tm, x, batches = mlp_pair()
    sims = {}
    for bw in (8, 4):
        js = JaxSim(jax_mlp, (params, jnp.asarray(x)), quant_scheme="minmax",
                    default_param_bw=bw)
        js.compute_encodings(params, iter([jnp.asarray(b) for b in batches]))
        ts = QuantizationSimModel(tm, (torch.from_numpy(x),),
                                  quant_scheme="minmax", default_param_bw=bw,
                                  device="cpu")
        ts.compute_encodings(None,
                             iter([torch.from_numpy(b) for b in batches]))
        sims[bw] = (js, ts)
    return sims, params, x


@pytest.mark.parametrize("mode,bw", [("w8", 8), ("w8a8", 8), ("w4", 4),
                                     ("w4a8", 4)])
def test_mlp_lowering_matches_jax(mlp, mode, bw):
    sims, params, x = mlp
    js, ts = sims[bw]
    jl = jax_lower(js, params, mode=mode, use_pallas=True)
    tl = lower_to_int(ts, None, mode=mode)
    assert tl.lowered_ops == ["linear_0", "linear_1"]
    want = np.asarray(jl(params, jnp.asarray(x)))
    _check(jl, tl, want, tl(ts.params, torch.from_numpy(x)),
           dynamic_a8=mode == "w4a8")


@pytest.mark.parametrize("m,k,n,x_dtype", [
    (37, 144, 130, np.float32), (64, 256, 256, np.float32),
    (5, 300, 77, np.float32), (40, 128, 200, "bfloat16"),
])
def test_staticq_plain_bit_for_bit_with_jax_kernel(m, k, n, x_dtype):
    rng = np.random.RandomState(m)
    x = (rng.randn(m, k) * 2).astype(np.float32)
    w = rng.randint(-127, 128, (k, n)).astype(np.int8)
    sv = (rng.rand(n) * 1e-3).astype(np.float32)
    cb = rng.randn(n).astype(np.float32)
    kw = dict(inv_delta=1 / 0.0317, offset=-131.0, num_steps=255.0)
    jx = jnp.asarray(x).astype(jnp.bfloat16 if x_dtype == "bfloat16"
                               else jnp.float32)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        torch.bfloat16 if x_dtype == "bfloat16" else torch.float32)
    want = jim.matmul_w8a8_staticq(jx, jnp.asarray(w), jnp.asarray(sv),
                                   jnp.asarray(cb), **kw)
    got, codes = tim.matmul_w8a8_staticq_torch(
        tx, torch.from_numpy(w), torch.from_numpy(sv), torch.from_numpy(cb),
        **kw, return_codes=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the codes: through an identity weight, unit scales and no bias
    eye = np.eye(k, dtype=np.int8)
    want_codes = jim.matmul_w8a8_staticq(
        jx, jnp.asarray(eye), jnp.ones(k, jnp.float32),
        jnp.zeros(k, jnp.float32), **kw)
    np.testing.assert_array_equal(codes.numpy().astype(np.float32),
                                  np.asarray(want_codes))
    # the lowering's public wrapper takes the plain version on the CPU
    same = tim.matmul_w8a8_staticq(tx, torch.from_numpy(w),
                                   torch.from_numpy(sv), torch.from_numpy(cb),
                                   **kw)
    assert torch.equal(same, got)


@pytest.mark.parametrize("m,k,n,group", [
    (16, 512, 256, 16), (96, 1024, 256, 64),
])
def test_grouped_int4_plain_matches_jax(m, k, n, group):
    rng = np.random.RandomState(k + m)
    w = (rng.randn(k, n) * 0.05).astype(np.float32)
    x = rng.randn(m, k).astype(np.float32)
    jp, js = jim.quantize_weight_int4_grouped(jnp.asarray(w), group)
    tp, ts = tim.quantize_weight_int4_grouped(torch.from_numpy(w), group)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    got = tim.matmul_w4_grouped(torch.from_numpy(x), tp, ts,
                                group_size=group).numpy()
    want_xla = jim.matmul_w4_grouped_xla(jnp.asarray(x), jp, js, group)
    np.testing.assert_allclose(got, np.asarray(want_xla), rtol=1e-5,
                               atol=1e-5)
    # both Pallas kernel bodies; the accumulator one needs >= 8 groups a
    # K block (here K/2 / group = 8 or 16), or it falls back to the other
    for acc_scales in (False, True):
        want = jim.matmul_w4_grouped(jnp.asarray(x), jp, js, group_size=group,
                                     acc_scales=acc_scales)
        assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("group", [8, 24])
def test_grouped_int4_small_groups_match_xla(group):
    """Group sizes that are not multiples of 16, against the JAX package's
    ``matmul_w4_grouped_xla``."""
    m, k, n = 16, 48 * 8, 96
    rng = np.random.RandomState(group)
    w = (rng.randn(k, n) * 0.05).astype(np.float32)
    x = rng.randn(m, k).astype(np.float32)
    jp, js = jim.quantize_weight_int4_grouped(jnp.asarray(w), group)
    tp, ts = tim.quantize_weight_int4_grouped(torch.from_numpy(w), group)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    got = tim.matmul_w4_grouped(torch.from_numpy(x), tp, ts,
                                group_size=group).numpy()
    want = jim.matmul_w4_grouped_xla(jnp.asarray(x), jp, js, group)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


def test_conv_lowering_is_not_ported_yet():
    model = torch.nn.Sequential(torch.nn.Conv2d(3, 8, 3), torch.nn.ReLU())
    x = torch.randn(2, 3, 8, 8)
    ts = QuantizationSimModel(model, (x,), quant_scheme="minmax",
                              device="cpu")
    assert [op.type for op in ts.graph.ops] == ["conv", "relu"]
    with pytest.raises(RuntimeError):
        lower_to_int(ts)                      # no encodings yet
    ts.compute_encodings(None, [x])
    # conv lowering is ported now (ops/int_conv; the name is kept): a
    # torch.nn.Conv2d with its bias lowers in every mode, within the
    # weight (and activation) quantization error of the float model
    want = model(x)
    for mode, tol in (("w8", 1e-3), ("w8a8", 1e-2)):
        tl = lower_to_int(ts, mode=mode)
        assert tl.lowered_ops == ["conv_0"] and tl.int_flops_fraction == 1
        got = tl(ts.params, x)
        assert ((got - want) ** 2).mean() / (want ** 2).mean() < tol, mode


def test_lowered_model_retraces_for_other_shapes(tiny):
    """A lowered model called on inputs of another shape traces the model
    again and applies the same replacements: the first 16 positions of
    row 0 agree with the traced-shape run (causal attention)."""
    sims, variables, tok = tiny
    ts = sims[8][1]
    tl = lower_to_int(ts, None, mode="w8")
    full = tl(ts.params, to_torch(tok))
    part = tl(ts.params, to_torch(tok[:1, :16]))
    assert part.shape == (1, 16, full.shape[-1])
    assert _rel(part[0].numpy(), full[0, :16].numpy()) < 1e-5
    assert len(tl._graphs) == 2


def test_decode_weight_only_at_decode_rows(tiny):
    """With decode_weight_only, w4a8 takes the weight-only INT4 kernel at
    M <= 32 rows (here 16): the same logits as w4; without it, per-row
    INT8 activations."""
    sims, variables, tok = tiny
    ts = sims[4][1]
    x = to_torch(tok[:1, :16])
    w4 = lower_to_int(ts, None, mode="w4")(ts.params, x)
    fast = lower_to_int(ts, None, mode="w4a8", decode_weight_only=True)
    faithful = lower_to_int(ts, None, mode="w4a8")
    assert torch.equal(fast(ts.params, x), w4)
    assert not torch.equal(faithful(ts.params, x), w4)
