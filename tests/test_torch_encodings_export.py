"""Encodings export and load, ``recompute_encoding`` / ``set_bitwidth``
and the whole PTQ flow of examples/ptq_quickstart.py in the port, against
the JAX package's (tests/torch_ptq_util.py's models, weights carried
across).

- ``export_encodings`` ('0.6.1') and ``export_encodings_v1`` ('1.0.0') of
  a port sim holding the JAX sim's encodings equal the JAX package's
  dicts field for field once the parameter keys are mapped
  (``convert.port_param_name``; the activation quantizers of these models
  have the same op names in both packages): ``is_symmetric`` a string,
  ``offset`` an int.
- ``export`` then ``load_encodings`` into a fresh sim gives every
  encoding back bit for bit, float (FP16 / FP8) entries included, and a
  file the JAX package wrote loads into the port bit for bit.
- ``export_safetensors``: the same tensors as the JAX package's file
  (conv kernels OIHW against HWIO), codes and scales equal.
- ``recompute_encoding`` / ``set_bitwidth``: parameter encodings bit for
  bit; activation encodings (each package's own observer state) within
  1e-6 relative.
- The quickstart flow (BN fold + CLE + high-bias fold, sqnr calibration,
  AdaRound, the quantized forward, export) on tests/test_ptq.py's
  ConvBnConv in both packages: equalized params within rtol 1e-4, atol
  1e-5; encodings within 1e-5 relative; AdaRounded weights equal within
  1e-6 of their max but for elements one grid step apart where the
  packages' α sit within FLIP_ALPHA of 0; quantized outputs within 1e-4
  of their max.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aimet_tpu.algorithms.adaround as jada
import aimet_tpu_torch.algorithms.adaround as tada
from aimet_tpu.algorithms.cle import equalize_model as jax_equalize
from aimet_tpu.graph.connected_graph import ConnectedGraph as JaxGraph
from aimet_tpu.quantsim.config import QuantSimConfig as JaxConfig
from aimet_tpu.quantsim.qsim import QuantizationSimModel as JaxSim
from aimet_tpu_torch import QuantizationSimModel, QuantSimConfig, convert
from aimet_tpu_torch.algorithms import (AdaroundParameters, apply_adaround,
                                        equalize_model)
from aimet_tpu_torch.graph.connected_graph import ConnectedGraph
from torch_ptq_util import (assert_tree_close, from_flax, nchw, nhwc,
                            one_thread, pair, to_flax)

FIELDS = ("min", "max", "delta", "offset")
FLIP_ALPHA = 1e-3


def _port_sim(name, per_channel=False, scheme="sqnr", bw=8):
    """(jax fn, variables, port model, calibrated port sim, x, batches)."""
    fn, v, tm, x, rs = pair(name)
    batches = [rs.randn(*x.shape).astype(np.float32) for _ in range(2)]
    ts = QuantizationSimModel(
        tm, (nchw(x),), quant_scheme=scheme, default_param_bw=bw,
        device="cpu",
        config=QuantSimConfig.per_channel_default() if per_channel else None)
    ts.compute_encodings(None, [nchw(b) for b in batches])
    return fn, v, tm, ts, x, batches


def _sims(name, per_channel=False, scheme="sqnr", bw=8):
    """``_port_sim``'s and the JAX package's sim on the same weights and
    batches."""
    fn, v, tm, ts, x, batches = _port_sim(name, per_channel, scheme, bw)
    jv = jax.tree_util.tree_map(jnp.asarray, v)
    js = JaxSim(fn, (jv, jnp.asarray(x)), quant_scheme=scheme,
                default_param_bw=bw,
                config=JaxConfig.per_channel_default() if per_channel
                else None)
    js.compute_encodings(jv, iter([jnp.asarray(b) for b in batches]))
    return v, jv, js, tm, ts, x, batches


def _carry(js, ts):
    for k, e in convert.encodings_from_jax(js.encodings,
                                           device="cpu").items():
        ts.set_encoding(k, e)


def _mapped(exported):
    """A JAX export with its parameter keys (and v1 names) as the port's."""
    out = dict(exported)
    for sect in ("activation_encodings", "param_encodings"):
        if isinstance(exported[sect], dict):
            out[sect] = {convert.port_param_name(k): v
                         for k, v in exported[sect].items()}
        else:
            out[sect] = [dict(e, name=convert.port_param_name(e["name"]))
                         for e in exported[sect]]
    return out


def _same_encodings(a, b):
    assert set(a) == set(b)
    for k in a:
        for f in FIELDS:
            assert torch.equal(getattr(a[k], f), getattr(b[k], f)), (k, f)
        assert (a[k].bitwidth, a[k].symmetric) == (b[k].bitwidth,
                                                   b[k].symmetric)


@pytest.mark.parametrize("name,per_channel,bw", [
    ("conv_bn_conv", False, 8), ("tiny_cnn", True, 4)])
def test_export_matches_jax_field_for_field(name, per_channel, bw):
    v, jv, js, tm, ts, x, _ = _sims(name, per_channel, bw=bw)
    _carry(js, ts)
    got, want = ts.export_encodings(), _mapped(js.export_encodings())
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    entry = next(iter(got["param_encodings"].values()))[0]
    assert isinstance(entry["is_symmetric"], str)
    assert isinstance(entry["offset"], int)
    assert ts.export_encodings_v1() == _mapped(js.export_encodings_v1())


def test_export_then_load_is_bit_for_bit(tmp_path):
    fn, v, tm, ts, x, batches = _port_sim("tiny_cnn", per_channel=True)
    # one FP16 and one FP8 quantizer besides the integer ones, made float
    # by loading float entries
    own = ts.export_encodings()
    act = own["activation_encodings"]
    act["relu_0"] = [{"bitwidth": 16, "dtype": "float"}]
    act["relu_1"] = [{"bitwidth": 8, "dtype": "float", "min": e["min"],
                      "max": e["max"]} for e in act["relu_1"]]
    ts.load_encodings(own)
    path = ts.export(str(tmp_path), "tiny")
    fresh = QuantizationSimModel(tm, (nchw(x),), device="cpu",
                                 config=QuantSimConfig.per_channel_default())
    with open(path) as f:
        fresh.load_encodings(json.load(f))
    int_names = [k for k in ts.encodings if k not in ("relu_0", "relu_1")]
    _same_encodings({k: ts.encodings[k] for k in int_names},
                    {k: fresh.encodings[k] for k in int_names})
    assert (fresh.quantizers["relu_0"].data_type,
            fresh.quantizers["relu_0"].bitwidth) == ("float", 16)
    assert (fresh.quantizers["relu_1"].data_type,
            fresh.quantizers["relu_1"].bitwidth) == ("float", 8)
    assert fresh.export_encodings() == ts.export_encodings()
    xb = nchw(batches[0])
    np.testing.assert_array_equal(fresh.quantized_fn(None, xb).numpy(),
                                  ts.quantized_fn(None, xb).numpy())


def test_load_a_jax_file_and_float_entries_match_jax(tmp_path):
    v, jv, js, tm, ts, x, batches = _sims("conv_bn_conv")
    js.set_quantizer_data_type("relu_0", "float", 16)
    js.set_quantizer_data_type("conv_1", "float", 8)
    js.export(str(tmp_path), "jax")
    with open(tmp_path / "jax.encodings") as f:
        raw = json.load(f)
    fresh = QuantizationSimModel(tm, (nchw(x),), device="cpu")
    fresh.load_encodings(_mapped(raw))
    # an FP8 entry's grid is recomputed from its min / max on load, in
    # both packages: the re-exports agree
    jfresh = JaxSim(js.fn, (jv, jnp.asarray(x)))
    jfresh.load_encodings(raw)
    assert fresh.export_encodings() == _mapped(jfresh.export_encodings())
    assert fresh.export_encodings()["activation_encodings"]["relu_0"] == \
        [{"bitwidth": 16, "dtype": "float"}]
    carried = convert.encodings_from_jax(js.encodings, device="cpu")
    ints = [k for k in carried if k not in ("relu_0", "conv_1")]
    _same_encodings({k: carried[k] for k in ints},
                    {k: fresh.encodings[k] for k in ints})
    want = np.asarray(js.quantized_fn(jv, jnp.asarray(batches[0])))
    got = nhwc(fresh.quantized_fn(None, nchw(batches[0])))
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_export_safetensors_matches_jax(tmp_path):
    from safetensors.numpy import load_file
    v, jv, js, tm, ts, x, _ = _sims("tiny_cnn", per_channel=True, bw=4)
    _carry(js, ts)
    want = load_file(js.export_safetensors(str(tmp_path), "jax", jv,
                                           quantized=True))
    got = load_file(ts.export_safetensors(str(tmp_path), "port",
                                          quantized=True))
    mapped = {}
    for k, a in want.items():
        base, dot, suffix = k.rpartition("']")
        mapped[convert.port_param_name(base + dot) + suffix] = a
    assert set(got) == set(mapped)
    assert any(k.endswith(".int") for k in got)
    for k, a in got.items():
        if a.ndim == 4:
            a = a.transpose(2, 3, 1, 0)
        assert a.dtype == mapped[k].dtype, k
        np.testing.assert_array_equal(a, mapped[k], err_msg=k)


def test_recompute_encoding_and_set_bitwidth_match_jax():
    v, jv, js, tm, ts, x, _ = _sims("conv_bn_conv", scheme="sqnr")
    for name in ("Conv_1.kernel", "relu_0"):
        key = convert.jax_param_key(name) if name.endswith("kernel") \
            else name
        want, got = js.recompute_encoding(key, 4), ts.recompute_encoding(
            name, 4)
        for f in FIELDS:
            np.testing.assert_allclose(getattr(got, f).numpy(),
                                       np.asarray(getattr(want, f)),
                                       rtol=1e-6, atol=1e-8, err_msg=f)
        js.set_bitwidth(key, 4)
        ts.set_bitwidth(name, 4)
        assert ts.quantizers[name].bitwidth == 4
        for f in FIELDS:
            assert torch.equal(getattr(ts.encodings[name], f),
                               getattr(got, f))
    # the parameter's encoding comes from the weights alone: bit for bit
    np.testing.assert_array_equal(
        ts.encodings["Conv_1.kernel"].delta.numpy(),
        np.asarray(js.encodings[convert.jax_param_key("Conv_1.kernel")]
                   .delta))


def test_ptq_quickstart_flow_matches_jax(monkeypatch, tmp_path):
    """examples/ptq_quickstart.py's flow: equalize, sqnr calibration,
    AdaRound (2 batches, 20 iterations), the quantized forward, export."""
    fn, v, tm, x, rs = pair("conv_bn_conv")
    batches = [rs.rand(*x.shape).astype(np.float32) for _ in range(4)]
    jv = jax.tree_util.tree_map(jnp.asarray, v)
    jbatches = [jnp.asarray(b) for b in batches]
    tbatches = [nchw(b) for b in batches]

    jeq = jax_equalize(JaxGraph(fn, (jv, jnp.asarray(x))), jv)
    teq = equalize_model(ConnectedGraph(tm, (nchw(x),)),
                         {k: p.detach() for k, p in tm.named_parameters()})
    assert_tree_close(to_flax(teq, v), jeq, 1e-4, 1e-5)

    js = JaxSim(fn, (jeq, jnp.asarray(x)), quant_scheme="sqnr")
    js.compute_encodings(jeq, iter(jbatches))
    ts = QuantizationSimModel(tm, (nchw(x),), quant_scheme="sqnr",
                              device="cpu")
    ts.compute_encodings(teq, tbatches)
    for k, e in js.encodings.items():
        te = ts.encodings[convert.port_param_name(k)]
        for f in FIELDS:
            np.testing.assert_allclose(getattr(te, f).numpy(),
                                       np.asarray(getattr(e, f)), rtol=1e-5,
                                       atol=1e-7, err_msg=(k, f))

    jal, tal = [], []
    soft_quant, hard = jada._soft_quant, tada._RoundingOptimizer.hard_weight

    def record(w, d, o, ns, alpha, soft=True):
        if not soft:
            jal.append(np.asarray(alpha))
        return soft_quant(w, d, o, ns, alpha, soft)

    def record_port(self):
        tal.append(self.alpha.detach().numpy().copy())
        return hard(self)

    monkeypatch.setattr(jada, "_soft_quant", record)
    monkeypatch.setattr(tada._RoundingOptimizer, "hard_weight", record_port)
    jnew = jada.apply_adaround(js, jeq, jbatches, jada.AdaroundParameters(
        num_batches=2, num_iterations=20))
    tnew = apply_adaround(ts, teq, tbatches, AdaroundParameters(
        num_batches=2, num_iterations=20))
    want = from_flax(jnew)
    for (k, op), a, b in zip(
            [(op.param_products["kernel"].param_path, op)
             for op in ts.graph.ops if op.type == "conv"], jal, tal):
        w, g = want[k].numpy(), tnew[k].numpy()
        step = float(ts.encodings[k].delta)
        apart = np.abs(g - w) > 1e-6 * np.abs(w).max()
        assert (np.abs(g - w)[apart] <= step * 1.001).all(), k
        near = np.abs(b) < FLIP_ALPHA
        assert (near[apart]).all(), k
        assert apart.mean() < 0.01, k

    want_out = np.asarray(js.quantized_fn(jnew, jbatches[0]))
    got_out = nhwc(ts.quantized_fn(tnew, tbatches[0]))
    assert np.abs(got_out - want_out).max() <= 1e-4 * np.abs(want_out).max()

    got_file = json.loads(open(ts.export(str(tmp_path), "port")).read())
    js.export(str(tmp_path), "jax")
    want_file = _mapped(json.loads(open(tmp_path / "jax.encodings").read()))
    assert set(got_file["param_encodings"]) == \
        set(want_file["param_encodings"])
    assert set(got_file["activation_encodings"]) == \
        set(want_file["activation_encodings"])
    for sect in ("param_encodings", "activation_encodings"):
        for k, entries in want_file[sect].items():
            for e, g in zip(entries, got_file[sect][k]):
                assert e["offset"] == g["offset"] and \
                    e["is_symmetric"] == g["is_symmetric"], k
                np.testing.assert_allclose(
                    [g[f] for f in ("min", "max", "scale")],
                    [e[f] for f in ("min", "max", "scale")], rtol=1e-5,
                    atol=1e-7, err_msg=k)
