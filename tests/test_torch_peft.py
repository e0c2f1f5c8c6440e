"""PEFT / LoRA in aimet_tpu_torch against the JAX package, on the same
numpy-made weights, inputs and adapters (the JAX adapters carried across
with ``convert.adapters_from_jax``; ``device="cpu"``).

- The unmerged forward (separate adapter matmuls, ``lora_unmerged_fn``)
  equals the merged one (``lora_apply_fn``) within 1e-5 of the output's
  max (the adapter path is summed in another order), and both equal the
  JAX package's within 1e-5, on TinyMLP and on TransformerConfig.tiny()
  (every attention and MLP kernel adapted, rank 4); zeroed adapters give
  the base model's output.
- The adapter sim (``PeftQuantUtils.build_adapter_sim``) has the JAX
  sim's quantizers, by name up to the parameter-name map, and the same
  graph (op names, types, parameters); ``set_bitwidth_for_lora_adapters``
  and ``freeze_base_model`` move and freeze the same quantizers; after
  min-max calibration on the same batch ``export_adapter_encodings`` has
  the JAX export's names and fields, values within 1e-6 relative; the
  quantized forwards agree within 1e-5 of the max;
  ``disable_adapter_activation_quantizers`` turns off the adapter-path
  activation quantizers the JAX sim selects.
- The adapter weight export (safetensors) round-trips bit for bit.
- ``quantized_lora_fn`` on a base sim with the JAX sim's encodings within
  1e-5 of JAX's; ``init_lora_params`` is the JAX layout (A (in, r) from
  the generator, B (r, out) zeros); ``adapters_from_jax`` of a kernel the
  port holds transposed gives the transposed update.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aimet_tpu.algorithms import peft as jpeft
from aimet_tpu.quantsim.qsim import QuantizationSimModel as JaxSim
from aimet_tpu_torch import QuantizationSimModel, convert
from aimet_tpu_torch.algorithms import peft as tpeft
from torch_ptq_util import one_thread, pair  # noqa: F401
from torch_quantsim_util import tiny_numpy_pair, to_torch

TOL = 1e-5          # forwards: / max |output|
ENC_RTOL = 1e-6     # exported encodings: relative


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _adapters(jv, cfg, scale=0.05, seed=1):
    """Adapters on the keys ``jpeft.init_lora_params`` picks, drawn with
    numpy (B non-zero, so the adapter path counts), for JAX and carried
    to the port."""
    rs = np.random.RandomState(seed)
    keys = jax.eval_shape(
        lambda: jpeft.init_lora_params(jax.random.PRNGKey(0), jv, cfg))
    npad = {k: {r: (rs.randn(*s.shape) * scale).astype(np.float32)
                for r, s in ab.items()} for k, ab in keys.items()}
    ad = jax.tree_util.tree_map(jnp.asarray, npad)
    return ad, convert.adapters_from_jax(npad, device="cpu")


def jax_name(name):
    """Port name in the adapter sim -> the JAX sim's name."""
    if name.startswith("base."):
        return "['base']" + convert.jax_param_key(name[len("base."):])
    if name.startswith("adapters."):
        kname, role = name[len("adapters."):].rsplit(".", 1)
        return f"['adapters'][\"{convert.jax_param_key(kname)}\"]['{role}']"
    return name


@pytest.fixture(scope="module")
def mlp():
    fn, v, tm, x, rs = pair("tiny_mlp")
    jv = jax.tree_util.tree_map(jnp.asarray, v)
    jcfg, tcfg = jpeft.LoraConfig(rank=4), tpeft.LoraConfig(rank=4)
    ad, tad = _adapters(jv, jcfg)
    params = {k: p.detach() for k, p in tm.named_parameters()}
    xs = rs.randn(8, 16).astype(np.float32)
    return fn, jv, tm, x, xs, params, jcfg, tcfg, ad, tad


def _functional(model):
    return lambda p, *a: torch.func.functional_call(model, p, a)


def test_unmerged_equals_merged_and_jax_on_the_mlp(mlp):
    fn, jv, tm, x, xs, params, jcfg, tcfg, ad, tad = mlp
    want = np.asarray(jax.jit(jpeft.lora_unmerged_fn(
        fn, (jnp.asarray(x),), jv, jcfg))({"base": jv, "adapters": ad},
                                           jnp.asarray(xs)))
    unmerged = tpeft.lora_unmerged_fn(tm, (torch.from_numpy(x),), params,
                                      tcfg)
    with torch.no_grad():
        got_u = unmerged({"base": params, "adapters": tad},
                         torch.from_numpy(xs)).numpy()
        got_m = tpeft.lora_apply_fn(_functional(tm), params, tad, tcfg)(
            tad, torch.from_numpy(xs)).numpy()
        base = tm(torch.from_numpy(xs)).numpy()
        off = unmerged({"base": params, "adapters":
                        tpeft.PeftQuantUtils.disable_lora_adapters(tad)},
                       torch.from_numpy(xs)).numpy()
    assert _rel(got_u, got_m) < TOL
    assert _rel(got_u, want) < TOL and _rel(got_m, want) < TOL
    assert _rel(got_u, base) > 1e-2            # the adapters count
    np.testing.assert_array_equal(off, base)


def test_unmerged_equals_merged_and_jax_on_the_transformer():
    fn, jv, tm, tok, _ = tiny_numpy_pair()
    jcfg = jpeft.LoraConfig(rank=4, target_patterns=("attn", "mlp"))
    tcfg = tpeft.LoraConfig(rank=4, target_patterns=("attn", "mlp"))
    ad, tad = _adapters(jv, jcfg, scale=0.02)
    assert len(tad) == 14                  # 7 kernels a layer
    params = {k: p.detach() for k, p in tm.named_parameters()}
    want = np.asarray(jax.jit(jpeft.lora_apply_fn(fn, jv, ad, jcfg))(
        ad, jnp.asarray(tok)))
    with torch.no_grad():
        got_u = tpeft.lora_unmerged_fn(tm, (to_torch(tok),), params, tcfg)(
            {"base": params, "adapters": tad}, to_torch(tok)).numpy()
        got_m = tpeft.lora_apply_fn(_functional(tm), params, tad, tcfg)(
            tad, to_torch(tok)).numpy()
    assert _rel(got_u, got_m) < TOL
    assert _rel(got_m, want) < TOL and _rel(got_u, want) < TOL


def test_adapter_sim_matches_jax(mlp):
    fn, jv, tm, x, xs, params, jcfg, tcfg, ad, tad = mlp
    js, jc = jpeft.PeftQuantUtils.build_adapter_sim(
        fn, (jnp.asarray(x),), jv, ad, jcfg, quant_scheme="minmax")
    ts, tc = tpeft.PeftQuantUtils.build_adapter_sim(
        tm, (torch.from_numpy(x),), params, tad, tcfg,
        quant_scheme="minmax", device="cpu")
    assert sorted(jax_name(n) for n in ts.quantizers) == sorted(js.quantizers)
    assert [(o.name, o.type, sorted(jax_name(p.param_path)
                                    for p in o.param_products.values()))
            for o in ts.graph.ops] == \
        [(o.name, o.type, sorted(p.param_path
                                 for p in o.param_products.values()))
         for o in js.graph.ops]
    ad_params = [n for n, s in ts.quantizers.items() if s.kind == "param"
                 and n.startswith(tpeft.PeftQuantUtils.ADAPTER_KEY)]
    assert len(ad_params) == 6            # 3 kernels x (A, B)

    js.compute_encodings(jc, [jnp.asarray(xs)])
    ts.compute_encodings(tc, [torch.from_numpy(xs)])
    assert _rel(ts.quantized_fn(tc, torch.from_numpy(xs)).numpy(),
                np.asarray(jax.jit(js.quantized_fn)(
                    jc, jnp.asarray(xs)))) < TOL

    for mod, sim in ((jpeft, js), (tpeft, ts)):
        mod.PeftQuantUtils.set_bitwidth_for_lora_adapters(sim, 16, 16)
        mod.PeftQuantUtils.freeze_base_model(sim)
    assert {jax_name(n): s.bitwidth for n, s in ts.quantizers.items()} == \
        {n: s.bitwidth for n, s in js.quantizers.items()}
    assert sorted(jax_name(n) for n in ts._frozen) == sorted(js._frozen)
    assert all(ts.quantizers[n].bitwidth == 16 for n in ad_params)
    assert not set(ad_params) & ts._frozen

    jenc = jpeft.PeftQuantUtils.export_adapter_encodings(js)
    tenc = tpeft.PeftQuantUtils.export_adapter_encodings(ts)
    assert tenc["version"] == jenc["version"]
    for kind in ("activation_encodings", "param_encodings"):
        got = {jax_name(n): e for n, e in tenc[kind].items()}
        assert sorted(got) == sorted(jenc[kind]), kind
        for n, entries in got.items():
            want = jenc[kind][n]
            assert len(entries) == len(want)
            for e, w in zip(entries, want):
                assert e.keys() == w.keys()
                for f in e:
                    if isinstance(e[f], float):
                        assert abs(e[f] - w[f]) <= ENC_RTOL * max(
                            abs(w[f]), 1e-30), (n, f)
                    else:
                        assert e[f] == w[f], (n, f)

    # adapters that train from B = 0: the port's step turns off the
    # activation quantizers the JAX sim selects as the adapter path's
    off = tpeft.PeftQuantUtils.disable_adapter_activation_quantizers(ts)
    want = sorted(n for n, s in js.quantizers.items() if s.kind != "param"
                  and jpeft.PeftQuantUtils._is_adapter_quantizer(js, n, s))
    assert want and sorted(jax_name(n) for n in off) == want
    for n in want:
        js.set_quantizer_enabled(n, False)
    assert {jax_name(n): s.enabled for n, s in ts.quantizers.items()} == \
        {n: s.enabled for n, s in js.quantizers.items()}


def test_adapter_weight_export_round_trips(mlp, tmp_path):
    pytest.importorskip("safetensors")
    *_, tad = mlp
    tad = {k: {r: t.to(torch.bfloat16) if k.startswith("Dense_1") else t
               for r, t in ab.items()} for k, ab in tad.items()}
    path = tpeft.PeftQuantUtils.export_adapter_weights(tad, str(tmp_path),
                                                       "t")
    loaded = tpeft.PeftQuantUtils.enable_adapter_and_load_weights(
        path, device="cpu")
    assert loaded.keys() == tad.keys()
    for k in tad:
        for role in ("A", "B"):
            assert loaded[k][role].dtype == tad[k][role].dtype
            assert torch.equal(loaded[k][role], tad[k][role]), (k, role)


def test_quantized_lora_fn_matches_jax(mlp):
    fn, jv, tm, x, xs, params, jcfg, tcfg, ad, tad = mlp
    js = JaxSim(fn, (jv, jnp.asarray(x)), quant_scheme="minmax")
    js.compute_encodings(jv, [jnp.asarray(xs)])
    ts = QuantizationSimModel(tm, (torch.from_numpy(x),),
                              quant_scheme="minmax", device="cpu")
    ts.compute_encodings(None, [torch.from_numpy(xs)])
    for k, e in convert.encodings_from_jax(js.encodings,
                                           device="cpu").items():
        ts.set_encoding(k, e)
    jpeft.PeftQuantUtils.freeze_base_model(js)
    tpeft.PeftQuantUtils.freeze_base_model(ts)
    want = np.asarray(jax.jit(jpeft.PeftQuantUtils.quantized_lora_fn(
        js, jv, ad, jcfg))(ad, jnp.asarray(xs)))
    got = tpeft.PeftQuantUtils.quantized_lora_fn(ts, params, tad, tcfg)(
        tad, torch.from_numpy(xs)).numpy()
    assert _rel(got, want) < TOL


def test_init_and_carried_adapters_keep_the_kernel_layout(mlp):
    fn, jv, tm, x, xs, params, jcfg, tcfg, ad, tad = mlp
    g = torch.Generator().manual_seed(0)
    a1 = tpeft.init_lora_params(g, params, tcfg)
    a2 = tpeft.init_lora_params(torch.Generator().manual_seed(0), params,
                                tcfg)
    assert list(a1) == [convert.port_param_name(k) for k in ad]
    for k, ab in a1.items():
        k_in, k_out = params[k].shape
        assert ab["A"].shape == (k_in, 4) and ab["B"].shape == (4, k_out)
        assert not ab["B"].any() and torch.equal(ab["A"], a2[k]["A"])
        assert 0.005 < float(ab["A"].std()) < 0.02
    # a kernel held (out, in): the carried pair gives the transposed update
    npad = jax.tree_util.tree_map(np.asarray, ad)
    key = next(iter(npad))
    name = convert.port_param_name(key)
    flipped = convert.adapters_from_jax(npad, transposed={name},
                                        device="cpu")[name]
    np.testing.assert_allclose(
        (flipped["A"] @ flipped["B"]).numpy(),
        (npad[key]["A"] @ npad[key]["B"]).T, rtol=1e-6, atol=1e-7)
