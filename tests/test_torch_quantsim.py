"""aimet_tpu_torch.quantsim.qsim and graph.connected_graph against
aimet_tpu's on the same weights and inputs (numpy-made, flax weights
carried across), with ``device="cpu"``.

- Graph: on TransformerConfig.tiny() the port's ``linear_<n>`` ops carry
  the JAX names in the JAX order, on the same parameters (port names map
  to the JAX key strings) with the same channel axes. Other ops differ
  where the two traces differ: the JAX graph has the embedding's index
  wrap (``lt``, ``scale``, ``select_n`` on int32) and ``reduce_sum`` where
  the port has ``mean``; it traces jnp.where and jax.nn.silu once and
  shares their ops across layers, where the port has one a layer.
- Parameter encodings bit for bit; each linear's input-activation
  encoding within 1e-6 relative (the activations differ in the last bits
  between the two frameworks).
- The hooks the PTQ algorithms call, on tests/test_ptq.py's TinyCNN with
  the JAX sim's encodings carried across (tests/torch_ptq_util.py):
  ``collect_activations`` (float products within 1e-5 of their max;
  quantized ones within one grid step, equal at 99 % of the elements),
  ``quantized_fn_subset`` and ``quantized_fn_flagged`` (within 1e-5 of
  the JAX output's max; the flagged forward within 1e-6 of the port's
  own subsets), ``set_percentile_value`` (encodings within 1e-6 relative).
- ``quantized_fn``: the MLP of tests/test_lowering.py with every
  quantizer enabled within 1e-5 of the output's max; tiny with the
  masked-score and silu quantizers disabled in both packages (see
  torch_quantsim_util.masked_and_silu_quantizers): the logits agree
  within 1e-4 of their max at 85 % of the positions or more, and within
  6e-2 at the rest — there an activation a hair from a rounding boundary
  lands on the other code in one framework (3 of 48 positions here).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from aimet_tpu.quantsim.config import QuantSimConfig as JaxConfig
from aimet_tpu.quantsim.qsim import QuantizationSimModel as JaxSim
from aimet_tpu_torch import QuantizationSimModel, QuantSimConfig, convert
from torch_ptq_util import nchw, nhwc
from torch_ptq_util import pair as ptq_pair
from torch_quantsim_util import (jax_mlp, masked_and_silu_quantizers,
                                 mlp_pair, tiny_pair, to_torch)

FIELDS = ("min", "max", "delta", "offset")


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.fixture(scope="module")
def tiny_sims():
    """Both packages' sims on tiny, each calibrated on the same two
    batches (min-max)."""
    fn, variables, tm, tok, batches = tiny_pair()
    js = JaxSim(fn, (variables, jnp.asarray(tok)), quant_scheme="minmax")
    js.compute_encodings(variables, iter([jnp.asarray(b) for b in batches]))
    ts = QuantizationSimModel(tm, (to_torch(tok),), quant_scheme="minmax",
                              device="cpu")
    ts.compute_encodings(None, iter([to_torch(b) for b in batches]))
    return js, ts, variables, tok


@pytest.mark.parametrize("per_channel", [False, True])
def test_linear_ops_match_the_jax_graph(per_channel):
    fn, variables, tm, tok, _ = tiny_pair()
    jcfg = JaxConfig.per_channel_default() if per_channel else None
    tcfg = QuantSimConfig.per_channel_default() if per_channel else None
    js = JaxSim(fn, (variables, jnp.asarray(tok)), config=jcfg)
    ts = QuantizationSimModel(tm, (to_torch(tok),), config=tcfg,
                              device="cpu")
    jl, tl = js.graph.ops_of_type("linear"), ts.graph.ops_of_type("linear")
    assert [o.name for o in tl] == [o.name for o in jl]
    assert len(tl) == 15
    for j, t in zip(jl, tl):
        jk = j.param_products["kernel"].param_path
        tk = t.param_products["kernel"].param_path
        assert convert.jax_param_key(tk) == jk
        assert ts.quantizers[tk].channel_axis == js.quantizers[jk].channel_axis
    # every parameter quantizer, by name and axis
    jparams = {convert.port_param_name(k): s.channel_axis
               for k, s in js.quantizers.items() if s.kind == "param"}
    assert {k: s.channel_axis for k, s in ts.quantizers.items()
            if s.kind == "param"} == jparams
    # the other ops: per type, the counts that differ are the known ones
    def counts(g):
        out = {}
        for op in g.ops:
            out[op.type] = out.get(op.type, 0) + 1
        return out
    jc, tc = counts(js.graph), counts(ts.graph)
    differ = {k for k in set(jc) | set(tc) if jc.get(k) != tc.get(k)}
    assert differ == {"lt", "scale", "reduce_sum", "mean", "sigmoid", "mul"}


def test_param_and_input_encodings(tiny_sims):
    js, ts, _, _ = tiny_sims
    for k, enc in js.encodings.items():
        if not k.startswith("["):
            continue
        tenc = ts.encodings[convert.port_param_name(k)]
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(tenc, f).numpy(),
                                          np.asarray(getattr(enc, f)))
    for j, t in zip(js.graph.ops_of_type("linear"),
                    ts.graph.ops_of_type("linear")):
        je = js.encodings[j.inputs[0].producer.name]
        te = ts.encodings[t.inputs[0].producer.name]
        for f in FIELDS:
            np.testing.assert_allclose(getattr(te, f).numpy(),
                                       np.asarray(getattr(je, f)),
                                       rtol=1e-6, err_msg=(j.name, f))


def test_sqnr_input_encodings_match():
    fn, variables, tm, tok, batches = tiny_pair()
    js = JaxSim(fn, (variables, jnp.asarray(tok)))
    js.compute_encodings(variables, iter([jnp.asarray(batches[0])]))
    ts = QuantizationSimModel(tm, (to_torch(tok),), device="cpu")
    assert ts.quant_scheme == "sqnr"
    ts.compute_encodings(None, iter([to_torch(batches[0])]))
    for j, t in zip(js.graph.ops_of_type("linear"),
                    ts.graph.ops_of_type("linear")):
        je = js.encodings[j.inputs[0].producer.name]
        te = ts.encodings[t.inputs[0].producer.name]
        for f in FIELDS:
            np.testing.assert_allclose(getattr(te, f).numpy(),
                                       np.asarray(getattr(je, f)),
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=(j.name, f))


def test_mlp_quantizers_and_quantized_fn():
    params, tm, x, batches = mlp_pair()
    js = JaxSim(jax_mlp, (params, jnp.asarray(x)), quant_scheme="minmax")
    js.compute_encodings(params, iter([jnp.asarray(b) for b in batches]))
    ts = QuantizationSimModel(tm, (torch.from_numpy(x),),
                              quant_scheme="minmax", device="cpu")
    ts.compute_encodings(None, iter([torch.from_numpy(b) for b in batches]))
    assert {convert.port_param_name(k) for k in js.quantizers} == \
        set(ts.quantizers)
    assert all(s.enabled for s in ts.quantizers.values())
    want = np.asarray(js.quantized_fn(params, jnp.asarray(x)))
    got = ts.quantized_fn(None, torch.from_numpy(x)).numpy()
    assert _rel(got, want) < 1e-5
    np.testing.assert_allclose(ts.fp_fn(None, torch.from_numpy(x)).numpy(),
                               np.asarray(js.fp_fn(params, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)


def test_tiny_quantized_fn(tiny_sims):
    js, ts, variables, tok = tiny_sims
    for sim in (js, ts):
        for name in masked_and_silu_quantizers(sim):
            sim.set_quantizer_enabled(name, False)
    assert len(masked_and_silu_quantizers(ts)) == 6
    try:
        want = np.asarray(jax.jit(js.quantized_fn)(variables,
                                                   jnp.asarray(tok)))
        got = ts.quantized_fn(None, to_torch(tok)).numpy()
        float_logits = np.asarray(js.fp_fn(variables, jnp.asarray(tok)))
    finally:
        for sim in (js, ts):
            for name in masked_and_silu_quantizers(sim):
                sim.set_quantizer_enabled(name, True)
    assert np.isfinite(got).all() and got.shape == want.shape
    assert _rel(got, want) < 6e-2
    per_position = np.abs(got - want).max(-1) / np.abs(want).max()
    assert (per_position < 1e-4).mean() >= 0.85
    # the simulation is close to the float model once those are off
    assert _rel(got, float_logits) < 0.3


def test_quantizer_toggles_and_fp_fn(tiny_sims):
    _, ts, _, tok = tiny_sims
    out = ts.fp_fn(None, to_torch(tok))
    np.testing.assert_allclose(out.numpy(), ts.model(to_torch(tok)).detach(),
                               rtol=1e-5, atol=1e-5)
    name = "linear_0"
    enc = ts.encodings[name]
    ts.set_quantizer_enabled(name, False)
    assert name not in ts.encodings and not ts.quantizers[name].enabled
    ts.set_quantizer_enabled(name, True)
    assert ts.encodings[name] is enc


def test_blockwise_params(tiny_sims):
    _, ts, _, _ = tiny_sims
    fn, variables, tm, tok, batches = tiny_pair()
    js = JaxSim(fn, (variables, jnp.asarray(tok)))
    name = "layer_0.mlp.w_down.kernel"
    for lpbq in (False, True):
        js.set_param_blockwise(variables, convert.jax_param_key(name), 16,
                               lpbq=lpbq)
        want = js.encodings[convert.jax_param_key(name)]
        ts2 = QuantizationSimModel(tm, (to_torch(tok),), device="cpu")
        ts2.set_param_blockwise(None, name, 16, lpbq=lpbq)
        got = ts2.encodings[name]
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)))
        assert ts2.quantizers[name].block_size == 16


def test_entry_points_default_to_cuda_and_unported_raise(tiny_sims):
    _, ts, _, tok = tiny_sims
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            QuantizationSimModel(ts.model, (to_torch(tok),))
    # still unported: the StableHLO export; quantization-aware training,
    # the quantizer data type and every calibration scheme are ported
    with pytest.raises(NotImplementedError):
        ts.export_stablehlo()
    for name in ("set_quantizer_data_type", "qat_fn", "static_grid_qat_fn",
                 "update_encodings_from_qat"):
        assert callable(getattr(ts, name))
    _, mlp, x, _ = mlp_pair()
    sim = QuantizationSimModel(mlp, (torch.from_numpy(x),),
                               quant_scheme="entropy", device="cpu")
    assert sim.compute_encodings(None, [torch.from_numpy(x)])


def test_masked_score_quantizer_flattens_attention():
    """The placement rule, copied from the JAX package, quantizes the
    masked scores (range [-1e30, 0]): with sqnr calibration on tiny the
    fake-quant logits are a whole max away from the float model's, and
    close without that quantizer."""
    fn, variables, tm, tok, batches = tiny_pair()
    ts = QuantizationSimModel(tm, (to_torch(tok),), device="cpu")
    ts.compute_encodings(None, [to_torch(b) for b in batches])
    float_logits = ts.fp_fn(None, to_torch(tok)).numpy()
    with_it = ts.quantized_fn(None, to_torch(tok)).numpy()
    for name in masked_and_silu_quantizers(ts):
        if ts.graph.get_op(name).type == "select_n":
            ts.set_quantizer_enabled(name, False)
    without = ts.quantized_fn(None, to_torch(tok)).numpy()
    assert _rel(with_it, float_logits) > 0.5
    assert _rel(without, float_logits) < 0.3


def test_convert_names_and_encodings_round_trip(tiny_sims):
    """Parameter names both ways, and a JAX sim's encodings carried across
    field for field."""
    js, ts, _, _ = tiny_sims
    for name in ts.params:
        key = convert.jax_param_key(name)
        assert key in js.quantizers or not name.endswith(("kernel", "scale",
                                                          "embedding"))
        assert convert.port_param_name(key) == name
    assert convert.port_param_name("['w1']") == "w1"
    assert convert.port_param_name("linear_3") == "linear_3"
    carried = convert.encodings_from_jax(js.encodings, device="cpu")
    for key, enc in js.encodings.items():
        got = carried[convert.port_param_name(key)]
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(enc, f)))
        assert (got.bitwidth, got.symmetric) == (enc.bitwidth, enc.symmetric)


# ---------------------------------------------------------------------------
# The hooks the PTQ algorithms call
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cnn_sims():
    """TinyCNN in both packages (min-max, 4-bit weights), the port sim
    holding the JAX sim's encodings."""
    fn, v, tm, x, rs = ptq_pair("tiny_cnn")
    batches = [rs.randn(*x.shape).astype(np.float32) for _ in range(2)]
    jv = jax.tree_util.tree_map(jnp.asarray, v)
    js = JaxSim(fn, (jv, jnp.asarray(x)), quant_scheme="minmax",
                default_param_bw=4)
    js.compute_encodings(jv, iter([jnp.asarray(b) for b in batches]))
    ts = QuantizationSimModel(tm, (nchw(x),), quant_scheme="minmax",
                              default_param_bw=4, device="cpu")
    ts.compute_encodings(None, [nchw(b) for b in batches])
    for k, e in convert.encodings_from_jax(js.encodings,
                                           device="cpu").items():
        ts.set_encoding(k, e)
    return js, ts, jv, batches[0]


@pytest.mark.parametrize("mode", ["fp", "quantized"])
def test_collect_activations_match_jax(cnn_sims, mode):
    js, ts, jv, xb = cnn_sims
    names = [p.name for p in ts.graph.products.values()
             if p.kind != "param"]
    assert len(names) == len(ts.graph.ops) + 1
    want = js.collect_activations(jv, (jnp.asarray(xb),), names, mode=mode)
    got = ts.collect_activations(None, (nchw(xb),), names, mode=mode)
    assert sorted(got) == sorted(want) == sorted(names)
    for name in names:
        w, g = np.asarray(want[name]), nhwc(got[name])
        assert g.shape == w.shape, name
        scale = np.abs(w).max()
        if mode == "fp":
            assert np.abs(g - w).max() <= 1e-5 * scale, name
            continue
        enc = ts.encodings.get(name.removesuffix(".out"))
        step = float(enc.delta) if enc is not None else 0.0
        assert np.abs(g - w).max() <= step * 1.001 + 1e-5 * scale, name
        assert (np.abs(g - w) <= 1e-5 * scale).mean() >= 0.99, name


def test_quantized_fn_subset_matches_jax(cnn_sims):
    js, ts, jv, xb = cnn_sims
    params = [k for k, s in ts.quantizers.items() if s.kind == "param"]
    acts = [k for k, s in ts.quantizers.items() if s.kind != "param"]
    for enabled, disabled in ((params, None), (None, acts[:2]),
                              (acts, params[:1])):
        want = np.asarray(js.quantized_fn_subset(
            jv, jnp.asarray(xb),
            enabled=None if enabled is None else
            [convert.jax_param_key(k) if k in params else k
             for k in enabled],
            disabled=None if disabled is None else
            [convert.jax_param_key(k) if k in params else k
             for k in disabled]))
        got = ts.quantized_fn_subset(None, nchw(xb), enabled=enabled,
                                     disabled=disabled).numpy()
        assert _rel(got, want) < 1e-5


def test_quantized_fn_flagged_matches_jax(cnn_sims):
    js, ts, jv, xb = cnn_sims
    apply_fn, names = ts.quantized_fn_flagged()
    japply, jnames = js.quantized_fn_flagged()
    assert {convert.port_param_name(n) for n in jnames} == set(names)
    x = nchw(xb)
    # within 1e-6 of the max, not bit for bit: the flag's select may hand
    # a conv another memory layout (one input channel), and so another
    # algorithm
    on = torch.ones(len(names), dtype=torch.bool)
    assert _rel(apply_fn(None, on, x).numpy(),
                ts.quantized_fn(None, x).numpy()) < 1e-6
    assert _rel(apply_fn(None, ~on, x).numpy(),
                ts.fp_fn(None, x).numpy()) < 1e-6
    for i in (0, len(names) - 1):
        flags = torch.zeros(len(names), dtype=torch.bool)
        flags[i] = True
        got = apply_fn(None, flags, x).numpy()
        assert _rel(got, ts.quantized_fn_subset(
            None, x, enabled=[names[i]]).numpy()) < 1e-6
        jflags = jnp.asarray([convert.port_param_name(n) == names[i]
                              for n in jnames])
        assert _rel(got, np.asarray(japply(jv, jflags,
                                           jnp.asarray(xb)))) < 1e-5


def test_set_percentile_value_matches_jax():
    fn, v, tm, x, rs = ptq_pair("tiny_cnn")
    batches = [rs.randn(*x.shape).astype(np.float32) for _ in range(2)]
    jv = jax.tree_util.tree_map(jnp.asarray, v)
    js = JaxSim(fn, (jv, jnp.asarray(x)), quant_scheme="percentile",
                percentile=99.9)
    js.compute_encodings(jv, iter([jnp.asarray(b) for b in batches]))
    ts = QuantizationSimModel(tm, (nchw(x),), quant_scheme="percentile",
                              percentile=99.9, device="cpu")
    ts.compute_encodings(None, [nchw(b) for b in batches])
    name = "relu_0"
    before = ts.encodings[name]
    for sim in (js, ts):
        sim.set_percentile_value(name, 95.0)
    assert ts.quantizers[name].percentile == 95.0
    got, want = ts.encodings[name], js.encodings[name]
    assert float(got.max) < float(before.max)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-6,
                                   atol=1e-7, err_msg=f)
    with pytest.raises(ValueError):
        ts.set_percentile_value(name, 40.0)
    mm = QuantizationSimModel(tm, (nchw(x),), quant_scheme="minmax",
                              device="cpu")
    with pytest.raises(ValueError):
        mm.set_percentile_value(name, 99.0)
