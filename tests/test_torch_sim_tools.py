"""The tools that sit on the quantsim — ``quantsim/backend_aware``,
``quantsim/legacy``, ``utils/weight_padding``, ``utils/layer_output``,
``utils/visualization`` — and ``utils/cache``, in aimet_tpu_torch against
the JAX package on the same numpy-made weights and inputs (TinyMLP of
tests/torch_ptq_util.py; ``device="cpu"``), mirroring the backend-aware,
legacy and weight-padding cases of tests/test_misc_parity.py and the
cache, layer-output and visualization cases of tests/test_utils_aux.py.

- Op-def parsing (QNN master + supplemental XML, the single-file XML,
  JSON) is plain Python on the same files: the parsed kernels and
  constraints are equal. ``apply_backend_constraints`` (snapping and
  strict), ``validate_supported_kernels`` (every action) and
  ``check_rank_constraints`` give the JAX package's messages (parameter
  names mapped) and leave the same quantizer bitwidths / data types.
- ``MainQuantizer``: the encodings' fields within 1e-6 relative (the
  calibrations of the two frameworks' forwards; min / max of f32 values
  and the grids derived from them) and the forward within 1e-5 of its max.
- ``weight_pad``: padded weights and the target-grid encodings bit for
  bit against the JAX package's given the same 8-bit encodings (carried
  across), the low bits of the codes zero.
- ``LayerOutputUtil``: the same manifest (the port graph's product names
  are the JAX graph's on this model) and every dumped array within 1e-5
  of its max (one quantization step where a value sits on a rounding
  boundary).
- Visualization: the HTML of the AMP pareto front and the compression
  curves character for character; the weight / encoding range plots with
  the same bars (the SVG geometry is equal to 0.1 px once the names are
  mapped); the calibration histograms' polylines likewise.
- ``Cache``: a hit returns what the miss returned, bf16 included, on the
  cache's device, without calling the function again.
"""
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aimet_tpu.algorithms.amp import AmpResult as JaxAmpResult
from aimet_tpu.algorithms.amp import Candidate as JaxCandidate
from aimet_tpu.quantsim import backend_aware as jba
from aimet_tpu.quantsim.legacy import MainQuantizer as JaxMainQuantizer
from aimet_tpu.quantsim.qsim import QuantizationSimModel as JaxSim
from aimet_tpu.utils import visualization as jvis
from aimet_tpu.utils.layer_output import LayerOutputUtil as JaxLayerOutput
from aimet_tpu.utils.weight_padding import WeightPaddingParams as JaxWPP
from aimet_tpu.utils.weight_padding import weight_pad as jax_weight_pad
from aimet_tpu_torch import QuantizationSimModel, convert
from aimet_tpu_torch.algorithms.amp import AmpResult, Candidate
from aimet_tpu_torch.quantsim import backend_aware as tba
from aimet_tpu_torch.quantsim.legacy import MainQuantizer
from aimet_tpu_torch.utils import visualization as tvis
from aimet_tpu_torch.utils.cache import Cache
from aimet_tpu_torch.utils.layer_output import LayerOutputUtil
from aimet_tpu_torch.utils.weight_padding import (WeightPaddingParams,
                                                  weight_pad)
from test_misc_parity import MASTER_XML, SUPPLEMENTAL_XML
from torch_ptq_util import nchw, one_thread, pair  # noqa: F401

ENC_RTOL = 1e-6
OUT_TOL = 1e-5


@pytest.fixture(scope="module")
def mlp():
    fn, v, tm, x, rs = pair("tiny_mlp")
    jv = jax.tree_util.tree_map(jnp.asarray, v)
    batches = [rs.randn(*x.shape).astype(np.float32) for _ in range(2)]
    return fn, jv, tm, x, batches


def _sims(mlp, **kw):
    fn, jv, tm, x, _ = mlp
    js = JaxSim(fn, (jv, jnp.asarray(x)), quant_scheme="minmax", **kw)
    ts = QuantizationSimModel(tm, (nchw(x),), quant_scheme="minmax",
                              device="cpu", **kw)
    return js, ts


def _port_msg(m):
    """A JAX message with its parameter names in the port's form."""
    return re.sub(r"(\['params'\](?:\['[^']*'\])+)",
                  lambda g: convert.port_param_name(g.group(1)), m)


def _specs(sim, jax_side):
    return {(convert.port_param_name(n) if jax_side else n):
            (s.bitwidth, s.data_type) for n, s in sim.quantizers.items()}


# ---------------------------------------------------------------------------
# backend-aware quantsim
# ---------------------------------------------------------------------------

def _parsers(tmp_path, kind):
    if kind == "qnn":
        m, b = tmp_path / "master.xml", tmp_path / "backend.xml"
        m.write_text(MASTER_XML)
        b.write_text(SUPPLEMENTAL_XML)
        return (jba.ModelOpDefParser.from_qnn_xml(str(m), str(b)),
                tba.ModelOpDefParser.from_qnn_xml(str(m), str(b)))
    if kind == "xml":
        p = tmp_path / "ops.xml"
        p.write_text("""<OpDefs><OpDef><Name>Gemm</Name>
        <SupportedKernel><Activation bitwidth="8"/><Param bitwidth="4"/>
        </SupportedKernel></OpDef><OpDef><Name>Relu</Name>
        <SupportedKernel><Activation bitwidth="16" dtype="float"/>
        </SupportedKernel></OpDef></OpDefs>""")
        return (jba.ModelOpDefParser.from_xml(str(p)),
                tba.ModelOpDefParser.from_xml(str(p)))
    p = tmp_path / "ops.json"
    p.write_text(json.dumps(
        {"Gemm": [{"activation": {"bitwidth": 8}, "param": {"bitwidth": 8}},
                  {"activation": {"bitwidth": 16, "dtype": "float"},
                   "param": {"bitwidth": 4}}],
         "Relu": [{"activation": {"bitwidth": 8}}]}))
    return (jba.ModelOpDefParser.from_json(str(p)),
            tba.ModelOpDefParser.from_json(str(p)))


@pytest.mark.parametrize("kind", ["qnn", "xml", "json"])
def test_op_def_parsers_match_jax(tmp_path, kind):
    jp, tp = _parsers(tmp_path, kind)
    assert tp.op_list == jp.op_list
    assert sorted(tp.op_defs) == sorted(jp.op_defs)
    for t in jp.op_defs:
        assert [tuple(vars(k).values()) for k in tp.supported_kernels_for(t)] \
            == [tuple(vars(k).values()) for k in jp.supported_kernels_for(t)]
    for t, c in jp.constraints.items():
        tc = tp.constraints[t]
        assert tp.get_size(t) == jp.get_size(t)
        assert tc.filter_index == c.filter_index
        for a, b in zip(tc.inputs + tc.outputs + list(tc.parameters.values()),
                        c.inputs + c.outputs + list(c.parameters.values())):
            assert vars(a) == vars(b)


@pytest.mark.parametrize("kind,strict,bw", [
    ("json", False, 16), ("json", True, 16), ("qnn", False, 16),
    ("xml", False, 8)])
def test_backend_constraints_match_jax(mlp, tmp_path, kind, strict, bw):
    jp, tp = _parsers(tmp_path, kind)
    js, ts = _sims(mlp, default_output_bw=bw, default_param_bw=bw)
    for action in ("allow", "warn"):
        want = jba.validate_supported_kernels(js, jp, action=action)
        assert tba.validate_supported_kernels(ts, tp, action=action) == \
            [_port_msg(m) for m in want]
    want = jba.apply_backend_constraints(js, jp, strict=strict)
    got = tba.apply_backend_constraints(ts, tp, strict=strict)
    assert want and got == [_port_msg(m) for m in want]
    assert _specs(ts, False) == _specs(js, True)
    want = jba.validate_supported_kernels(js, jp, action="warn")
    assert tba.validate_supported_kernels(ts, tp, action="warn") == \
        [_port_msg(m) for m in want]
    if want:
        with pytest.raises(RuntimeError):
            tba.validate_supported_kernels(ts, tp, action="assert")
    assert tba.check_rank_constraints(ts, tp) == \
        jba.check_rank_constraints(js, jp)
    with pytest.raises(ValueError):
        tba.validate_supported_kernels(ts, tp, action="bogus")


def test_rank_constraints_flag_what_jax_flags(mlp, tmp_path):
    jp, tp = _parsers(tmp_path, "qnn")
    fn, v, tm, x, rs = pair("tiny_cnn")
    jv = jax.tree_util.tree_map(jnp.asarray, v)
    js = JaxSim(fn, (jv, jnp.asarray(x)), quant_scheme="minmax")
    ts = QuantizationSimModel(tm, (nchw(x),), quant_scheme="minmax",
                              device="cpu")
    # Conv2d declares 4-D input / output, Gemm 2-D: the dense layer reads
    # the pooled 4-D map (its flatten is a view) and is flagged in both
    got = tba.check_rank_constraints(ts, tp)
    assert got == jba.check_rank_constraints(js, jp) == \
        ["RANK linear_0: input rank 4 != backend rank 2"]
    # a 3-D rank on Conv2d's output flags both convs too
    for p in (jp, tp):
        p.constraints["conv"].outputs[0].rank = 3
    got = tba.check_rank_constraints(ts, tp)
    assert got == jba.check_rank_constraints(js, jp) and len(got) == 3


# ---------------------------------------------------------------------------
# legacy facade
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["tf"])
def test_main_quantizer_matches_jax(mlp, mode):
    fn, jv, tm, x, batches = mlp
    jq = JaxMainQuantizer(fn, (jv, jnp.asarray(x)), quant_mode=mode)
    want = jq.quantize_net(jv, iter([jnp.asarray(b) for b in batches]),
                           bw=8)
    tq = MainQuantizer(tm, (nchw(x),), quant_mode=mode, device="cpu")
    got = tq.quantize_net(None, [nchw(b) for b in batches], bw=8)
    assert sorted(got) == sorted(convert.port_param_name(k) for k in want)
    for k, e in want.items():
        g = got[convert.port_param_name(k)]
        assert g.keys() == e.keys()
        assert g["bitwidth"] == e["bitwidth"]
        for f in ("min", "max", "delta", "offset"):
            assert abs(g[f] - e[f]) <= ENC_RTOL * max(abs(e[f]), 1e-30), \
                (k, f)
    out = tq.forward(None, nchw(batches[0])).numpy()
    ref = np.asarray(jq.forward(jv, jnp.asarray(batches[0])))
    assert np.abs(out - ref).max() <= OUT_TOL * np.abs(ref).max()
    assert tq.sim.quant_scheme == tq.sim.param_quant_scheme == "minmax"
    # the QuantizationMode names map as the JAX package maps them
    for m in ("tf_enhanced", "percentile", "mse", "entropy"):
        assert MainQuantizer(tm, (nchw(x),), quant_mode=m,
                             device="cpu")._scheme == \
            JaxMainQuantizer(fn, (jv, jnp.asarray(x)), quant_mode=m)._scheme
    with pytest.raises(ValueError):
        MainQuantizer(tm, (nchw(x),), quant_mode="bogus", device="cpu")


# ---------------------------------------------------------------------------
# weight padding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("per_channel", [False, True])
def test_weight_pad_matches_jax(mlp, per_channel):
    from aimet_tpu.quantsim.config import QuantSimConfig as JaxConfig
    from aimet_tpu_torch import QuantSimConfig
    fn, jv, tm, x, _ = mlp
    js = JaxSim(fn, (jv, jnp.asarray(x)), quant_scheme="minmax",
                config=JaxConfig(per_channel=per_channel))
    ts = QuantizationSimModel(tm, (nchw(x),), quant_scheme="minmax",
                              config=QuantSimConfig(per_channel=per_channel),
                              device="cpu")
    js.compute_param_encodings(jv)
    for k, e in convert.encodings_from_jax(js.encodings,
                                           device="cpu").items():
        ts.set_encoding(k, e)
    layers = {"Dense_0.kernel": (4, 8), "Dense_1.kernel": (2, 8),
              "Dense_2.kernel": (8, 8)}
    jpad = jax_weight_pad(js, jv, {convert.jax_param_key(k): JaxWPP(*b)
                                   for k, b in layers.items()})
    tpad = weight_pad(ts, None, {k: WeightPaddingParams(*b)
                                 for k, b in layers.items()})
    jflat = {convert.port_param_name(jax.tree_util.keystr(p)): np.asarray(v)
             for p, v in jax.tree_util.tree_leaves_with_path(jpad)}
    for k in tpad:
        np.testing.assert_array_equal(tpad[k].numpy(), jflat[k], err_msg=k)
    for k, (s, t) in layers.items():
        je = js.encodings[convert.jax_param_key(k)]
        te = ts.encodings[k]
        for f in ("min", "max", "delta", "offset"):
            np.testing.assert_array_equal(getattr(te, f).numpy(),
                                          np.asarray(getattr(je, f)))
        assert ts.quantizers[k].bitwidth == \
            js.quantizers[convert.jax_param_key(k)].bitwidth
        assert (k in ts._frozen) == (t > s)
        if t > s:
            # codes on the target grid with 2^(t - s) zero low bits
            ax = ts.quantizers[k].channel_axis
            d = te.delta if ax is None else te.delta.reshape(1, -1)
            codes = tpad[k] / d
            step = 2 ** (t - s)
            assert torch.allclose(codes / step, torch.round(codes / step),
                                  atol=1e-3)


# ---------------------------------------------------------------------------
# layer outputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["quantized", "fp"])
def test_layer_outputs_match_jax(mlp, tmp_path, mode):
    fn, jv, tm, x, batches = mlp
    js, ts = _sims(mlp)
    js.compute_encodings(jv, iter([jnp.asarray(batches[0])]))
    ts.compute_encodings(None, [nchw(batches[0])])
    for k, e in convert.encodings_from_jax(js.encodings,
                                           device="cpu").items():
        ts.set_encoding(k, e)
    jm = JaxLayerOutput(js, str(tmp_path / "j"), mode=mode) \
        .generate_layer_outputs(jv, jnp.asarray(batches[1]), 3)
    tm_ = LayerOutputUtil(ts, str(tmp_path / "t"), mode=mode) \
        .generate_layer_outputs(None, nchw(batches[1]), 3)
    assert tm_ == jm and "linear_2.out" in tm_
    saved = json.loads((tmp_path / "t" / "batch_3" / "manifest.json")
                       .read_text())
    assert saved == tm_
    for name, f in tm_.items():
        a = np.load(tmp_path / "t" / "batch_3" / f)
        b = np.load(tmp_path / "j" / "batch_3" / jm[name])
        assert a.shape == b.shape and a.dtype == b.dtype
        enc = ts.encodings.get(name.removesuffix(".out"))
        step = float(enc.delta) if enc is not None and mode == "quantized" \
            else 0.0
        scale = np.abs(b).max()
        assert np.abs(a - b).max() <= step * 1.001 + OUT_TOL * scale, name


# ---------------------------------------------------------------------------
# visualization
# ---------------------------------------------------------------------------

def _geometry(html):
    """The SVG numbers of a plot (bars, lines, points), to 0.1 px."""
    return [round(float(v), 1) for v in re.findall(
        r'(?:x|y|width|height|x1|y1|x2|y2|cx|cy)="(-?[0-9.]+)"', html)] + \
        [round(float(v), 1) for v in re.findall(
            r"(-?\d+\.\d+)", " ".join(re.findall(r'points="([^"]*)"',
                                                 html)))]


def test_visualizations_match_jax(mlp, tmp_path):
    fn, jv, tm, x, batches = mlp
    js = JaxSim(fn, (jv, jnp.asarray(x)), quant_scheme="sqnr")
    js.compute_encodings(jv, iter([jnp.asarray(batches[0])]))
    ts = QuantizationSimModel(tm, (nchw(x),), quant_scheme="sqnr",
                              device="cpu")
    ts.compute_encodings(None, [nchw(batches[0])])
    for what, jcall, tcall in (
            ("w", lambda p: jvis.visualize_weight_ranges(jv, p),
             lambda p: tvis.visualize_weight_ranges(ts.params, p)),
            ("e", lambda p: jvis.visualize_encoding_ranges(js, p),
             lambda p: tvis.visualize_encoding_ranges(ts, p)),
            ("h", lambda p: jvis.visualize_calibration_histograms(js, p),
             lambda p: tvis.visualize_calibration_histograms(ts, p))):
        jcall(str(tmp_path / f"j{what}.html"))
        tcall(str(tmp_path / f"t{what}.html"))
        a = (tmp_path / f"t{what}.html").read_text()
        b = (tmp_path / f"j{what}.html").read_text()
        assert "svg" in a
        if what == "h":     # one block a quantizer, in each sim's order
            a, b = ("".join(sorted(t.split("<div>"))) for t in (a, b))
        ga, gb = _geometry(a), _geometry(b)
        assert len(ga) == len(gb) and ga, what
        assert np.abs(np.asarray(ga) - np.asarray(gb)).max() <= 0.11, what
    assert "polyline" in (tmp_path / "th.html").read_text()
    ts_copy = QuantizationSimModel(tm, (nchw(x),), device="cpu")
    with pytest.raises(RuntimeError):
        tvis.visualize_calibration_histograms(ts_copy, str(tmp_path / "x"))


def test_amp_and_compression_plots_match_jax(tmp_path):
    kw = dict(pareto_front=[(1.0, 0.91), (0.8, 0.905), (0.6, 0.88)],
              baseline_accuracy=0.91, final_accuracy=0.905)
    jres = JaxAmpResult(
        group_bitwidths={"conv_0": JaxCandidate(8, 8)},
        phase1_scores={("conv_0", JaxCandidate(8, 4)): 0.90,
                       ("linear_0", JaxCandidate(8, 4)): 0.83}, **kw)
    tres = AmpResult(
        group_bitwidths={"conv_0": Candidate(8, 8)},
        phase1_scores={("conv_0", Candidate(8, 4)): 0.90,
                       ("linear_0", Candidate(8, 4)): 0.83}, **kw)
    a = tvis.visualize_amp_pareto(tres, str(tmp_path / "t.html"))
    b = jvis.visualize_amp_pareto(jres, str(tmp_path / "j.html"))
    assert open(a).read() == open(b).read()
    assert "Pareto front" in open(a).read()
    curves = {"conv_0": {0.25: 0.5, 0.5: 0.8, 0.75: 0.9},
              "conv_1": {0.25: 0.7, 0.5: 0.85, 0.75: 0.95}}
    a = tvis.visualize_compression_curves(curves, str(tmp_path / "tc.html"))
    b = jvis.visualize_compression_curves(curves, str(tmp_path / "jc.html"))
    assert open(a).read() == open(b).read()
    assert open(a).read().count("<svg") == 2


# ---------------------------------------------------------------------------
# stage cache
# ---------------------------------------------------------------------------

def test_cache_memoizes_and_round_trips_bf16(tmp_path):
    cache = Cache(device="cpu")
    calls = []

    @cache.mark("expensive")
    def expensive(x):
        calls.append(x)
        return {"v": torch.tensor([x * 2.0]),
                "bf": (torch.arange(4, dtype=torch.float32) / 3).bfloat16(),
                "meta": [x, "s"]}

    with cache.enable(str(tmp_path), "k1"):
        r1 = expensive(3)
        r2 = expensive(3)
    assert len(calls) == 1
    assert torch.equal(r1["v"], r2["v"]) and r2["meta"] == [3, "s"]
    assert r2["bf"].dtype == torch.bfloat16 and torch.equal(r1["bf"],
                                                            r2["bf"])
    # a fresh run resumes from disk: the argument is not part of the key
    with cache.enable(str(tmp_path), "k1"):
        r3 = expensive(99)
    assert len(calls) == 1 and float(r3["v"][0]) == 6.0
    assert (tmp_path / "k1.expensive.pkl").exists()
    # disabled outside the context
    assert float(expensive(5)["v"][0]) == 10.0 and len(calls) == 2
    # another key misses
    with cache.enable(str(tmp_path), "k2"):
        expensive(7)
    assert len(calls) == 3


def test_cache_loads_onto_its_device(tmp_path):
    with Cache(device="cpu").enable(str(tmp_path), "k") as c:
        c.mark("s")(lambda: torch.ones(2))()
    with Cache().enable(str(tmp_path), "k") as c:     # default: cuda
        hit = c.mark("s")(lambda: torch.zeros(2))
        if torch.cuda.is_available():
            assert hit().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError):
                hit()
