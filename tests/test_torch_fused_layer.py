"""aimet_tpu_torch.ops.fused_layer (the plain versions the CPU takes)
against aimet_tpu.ops.fused_layer (Pallas, interpret mode) on the same
numpy inputs, through the JAX signature: gate and up as separate arrays
and concatenated as serving stores them (``up_block_offset``).

``fused_wo_mlp`` tolerances, as tests/test_fused_layer.py: f32 at rtol =
atol = 2e-5 (the same rounding points; the TPU kernel's biased-nibble
sums differ in the last bits); bf16 within 5e-2 of the max.

``fused_decode_layer`` at the shapes of tests/test_fused_layer.py:97-118
(b 8, s 32, h 8, kh 2, d 128, position 11): cache bytes bit for bit,
outputs within that test's 2e-2 of the max (bf16 activations rounded at
the same points, f32 sums in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aimet_tpu.models.transformer import TransformerConfig, rope_freqs
from aimet_tpu.ops.fused_layer import fused_decode_layer as j_layer
from aimet_tpu.ops.fused_layer import fused_wo_mlp as j_fused
from aimet_tpu.ops.int_matmul import quantize_weight_int4
from aimet_tpu.ops.kv_cache import (flatten_kv_caches,
                                    init_quantized_kv_cache, prefill_kv)
from aimet_tpu_torch.ops.fused_layer import (fused_decode_layer,
                                             fused_wo_mlp, fused_wo_mlp_torch,
                                             rms_norm)
from aimet_tpu_torch.ops.int_matmul import matmul_w4a8_torch

BLOCKS = dict(block_a=128, block_g=128, block_d=128)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a, dtype=np.float32 if dtype else None))
    return t.to(dtype) if dtype else t


def _case(m, A, D, F, nq, seed, dtype=jnp.float32):
    rs = np.random.RandomState(seed)

    def q4(k, n):
        return tuple(np.array(a) for a in quantize_weight_int4(jnp.asarray(
            rs.randn(k, n).astype(np.float32) * (1.5 / np.sqrt(k)))))

    wo, wg, wu, wd = q4(A, D), q4(D, F), q4(D, F), q4(F, D)
    wgu = (np.concatenate([wg[0], wu[0]], 1), np.concatenate([wg[1], wu[1]]))
    return dict(
        ao=jnp.asarray(rs.randn(m, A).astype(np.float32) * 0.5).astype(dtype),
        resid=jnp.asarray(rs.randn(m, D).astype(np.float32) * 0.5
                          ).astype(dtype),
        gamma=jnp.asarray(rs.rand(D).astype(np.float32) + 0.5),
        agamma=jnp.asarray(rs.rand(D).astype(np.float32) + 0.5),
        wo=wo, wg=wg, wu=wu, wgu=wgu, wd=wd, wq=q4(D, nq) if nq else None)


def _pair(p):
    return torch.from_numpy(p[0]), torch.from_numpy(p[1])


def _gate_up(c, concatenated, F):
    """The port's gate and up arguments in either JAX form."""
    if not concatenated:
        return (_pair(c["wg"]), _pair(c["wu"])), {}
    w, s = _pair(c["wgu"])
    return (((w, s[:F]), (w, s[F:])),
            dict(up_block_offset=F // BLOCKS["block_g"], n_f=F))


def _port(c, dtype, next_qkv, concatenated=True):
    F = c["wg"][0].shape[1]
    (gate, up), kw = _gate_up(c, concatenated, F)
    nxt = ((_pair(c["wq"]), _t(c["agamma"])) if next_qkv else None)
    return fused_wo_mlp(_t(c["ao"], dtype), _t(c["resid"], dtype),
                        _pair(c["wo"]), gate, up, _pair(c["wd"]),
                        _t(c["gamma"]), eps=1e-5, next_qkv=nxt, **BLOCKS,
                        **kw)


@pytest.mark.parametrize("m", [1, 8, 16, 33])
def test_fused_wo_mlp_f32_concatenated_gate_up(m):
    A, D, F = 256, 256, 512
    c = _case(m, A, D, F, 0, m)
    wgu = tuple(jnp.asarray(a) for a in c["wgu"])
    want = j_fused(c["ao"], c["resid"], c["wo"], (wgu[0], wgu[1][:F]),
                   (wgu[0], wgu[1][F:]), c["wd"], c["gamma"], eps=1e-5,
                   up_block_offset=F // 128, n_f=F, **BLOCKS)
    got = _port(c, None, False)
    assert got.dtype == torch.float32 and got.shape == (m, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_fused_wo_mlp_f32_next_qkv_separate_gate_up():
    m, A, D, F, nq = 16, 256, 256, 512, 384
    c = _case(m, A, D, F, nq, 7)
    out, qkv = j_fused(c["ao"], c["resid"], c["wo"], c["wg"], c["wu"],
                       c["wd"], c["gamma"], eps=1e-5, block_q=128,
                       next_qkv=(c["wq"], c["agamma"]), **BLOCKS)
    got_out, got_qkv = _port(c, None, True, concatenated=False)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(out), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(got_qkv.numpy(), np.asarray(qkv), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("next_qkv", [False, True])
def test_fused_wo_mlp_bf16_rect(next_qkv):
    m, A, D, F, nq = 16, 384, 256, 640, 256
    c = _case(m, A, D, F, nq, 11, dtype=jnp.bfloat16)
    kw = dict(eps=1e-5, **BLOCKS)
    if next_qkv:
        kw.update(block_q=128, next_qkv=(c["wq"], c["agamma"]))
    want = j_fused(c["ao"], c["resid"], c["wo"], c["wg"], c["wu"], c["wd"],
                   c["gamma"], **kw)
    got = _port(c, torch.bfloat16, next_qkv, concatenated=False)
    want, got = (want, got) if next_qkv else ((want,), (got,))
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        w = np.asarray(w.astype(jnp.float32))
        err = np.abs(g.float().numpy() - w).max() / np.abs(w).max()
        assert err < 5e-2, err


def test_fused_wo_mlp_int8_dots_is_the_w4a8_composition():
    """int8_dots: every projection quantizes its input per row and runs the
    exact W4A8 matmul (the whole-layer kernel's phases in w4a8 mode)."""
    m, A, D, F = 4, 128, 128, 256
    c = _case(m, A, D, F, 0, 3)
    ao, resid, gamma = _t(c["ao"]), _t(c["resid"]), _t(c["gamma"])
    mm = lambda x, p: matmul_w4a8_torch(x, *_pair(p), torch.float32)
    y = mm(ao, c["wo"]) + resid
    gu = mm(rms_norm(y, gamma, 1e-5), c["wgu"])
    h = gu[:, :F] * torch.sigmoid(gu[:, :F]) * gu[:, F:]
    want = mm(h, c["wd"]) + y
    (gate, up), kw = _gate_up(c, True, F)
    got = fused_wo_mlp_torch(ao, resid, _pair(c["wo"]), gate, up,
                             _pair(c["wd"]), gamma, int8_dots=True,
                             block_g=128, **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# fused_decode_layer: the whole decode layer
# ---------------------------------------------------------------------------

LAYER_BLOCKS = dict(block_a=512, block_g=512, block_d=512)
B, S, H, KH, HD, POS = 8, 32, 8, 2, 128, 11
DM, FF = H * HD, 2 * H * HD


def _layer_case(seed, n_layers=1):
    """Inputs of tests/test_fused_layer.py:97-118: prefilled caches, this
    layer's qkv, the residual, rope rows and per-layer INT4 weights (each
    layer but the last with the next layer's QKV weight)."""
    rs = np.random.RandomState(seed)
    cfg = TransformerConfig(vocab_size=64, d_model=DM, n_layers=n_layers,
                            n_heads=H, n_kv_heads=KH, d_ff=FF)
    nq = (H + 2 * KH) * HD

    def rq(k, n):
        return quantize_weight_int4(
            jnp.asarray(rs.randn(k, n) * 0.05, jnp.float32))

    caches, layers = [], []
    for _ in range(n_layers):
        caches.append(prefill_kv(
            init_quantized_kv_cache(B, S, KH, HD),
            jnp.asarray(rs.randn(B, POS, KH, HD), jnp.float32),
            jnp.asarray(rs.randn(B, POS, KH, HD), jnp.float32), 0))
        wg, wu = rq(DM, FF), rq(DM, FF)
        layers.append(dict(
            wo=rq(H * HD, DM), wg=wg, wu=wu,
            wgu=(jnp.concatenate([wg[0], wu[0]], 1),
                 jnp.concatenate([wg[1], wu[1]])),
            wd=rq(FF, DM), wq=rq(DM, nq),
            gamma=jnp.asarray(rs.rand(DM) + 0.5, jnp.float32),
            agamma=jnp.asarray(rs.rand(DM) + 0.5, jnp.float32)))
    cos, sin = rope_freqs(cfg, jnp.asarray([POS]))
    return dict(
        caches=caches, layers=layers, cos=cos, sin=sin,
        qkv=jnp.asarray(rs.randn(B, nq), jnp.float32).astype(jnp.bfloat16),
        resid=jnp.asarray(rs.randn(B, DM) * 0.1, jnp.float32
                          ).astype(jnp.bfloat16))


def _tt(a):
    """numpy/JAX array -> torch tensor (bf16 kept as bf16)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _weights(layer, concatenated, to):
    """gate, up and the keyword arguments of the JAX signature, with the
    arrays converted by ``to``."""
    if concatenated:
        w, s = to(layer["wgu"][0]), to(layer["wgu"][1])
        return ((w, s[:FF]), (w, s[FF:]),
                dict(up_block_offset=FF // LAYER_BLOCKS["block_g"], n_f=FF))
    return ((to(layer["wg"][0]), to(layer["wg"][1])),
            (to(layer["wu"][0]), to(layer["wu"][1])), {})


def _run_layer(fn, to, c, layer, cache, qkv, resid, has_next, concatenated,
               flat, pos=POS):
    """One call of ``fn`` (JAX's or the port's fused_decode_layer) on the
    case's arrays converted by ``to``."""
    pair = lambda p: (to(p[0]), to(p[1]))
    gate, up, kw = _weights(layer, concatenated, to)
    if has_next:
        kw["next_qkv"] = (pair(c["wq_next"]), to(c["agamma_next"]))
    k, v = cache
    return fn(qkv, resid, k, v, to(c["ks"]), to(c["vs"]), pos, to(c["cos"]),
              to(c["sin"]), pair(layer["wo"]), gate, up, pair(layer["wd"]),
              to(layer["gamma"]), n_heads=H, n_kv_heads=KH, **LAYER_BLOCKS,
              **kw)


def _layer_args(case, i, flat):
    """Layer i's cache arrays (flat or 4-D) and scales, and the next
    layer's QKV weight and norm."""
    cache = case["caches"][i]
    if flat:
        cache = flatten_kv_caches([cache])[0]
    nxt = case["layers"][min(i + 1, len(case["layers"]) - 1)]
    return (np.asarray(cache.k), np.asarray(cache.v)), dict(
        case, ks=cache.k_scale, vs=cache.v_scale,
        wq_next=case["layers"][i]["wq"] if i + 1 == len(case["layers"])
        else nxt["wq"], agamma_next=nxt["agamma"])


def _relmax(got, want):
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    return np.abs(g - w).max() / max(np.abs(w).max(), 1e-9)


@pytest.mark.parametrize("flat", [False, True], ids=["4d", "flat"])
@pytest.mark.parametrize("concatenated", [False, True],
                         ids=["separate", "concatenated"])
@pytest.mark.parametrize("has_next", [True, False], ids=["next_qkv", "last"])
def test_fused_decode_layer_matches_jax(has_next, concatenated, flat):
    c = _layer_case(seed=0)
    (k, v), a = _layer_args(c, 0, flat)
    want = _run_layer(j_layer, jnp.asarray, a, c["layers"][0],
                      (jnp.asarray(k), jnp.asarray(v)), c["qkv"], c["resid"],
                      has_next, concatenated, flat, pos=jnp.int32(POS))
    kc, vc = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    got = _run_layer(fused_decode_layer, _tt, a, c["layers"][0], (kc, vc),
                     _tt(c["qkv"]), _tt(c["resid"]), has_next, concatenated,
                     flat)
    assert len(got) == len(want) == (4 if has_next else 3)
    assert got[-2] is kc and got[-1] is vc            # in place, same layout
    assert kc.dim() == (3 if flat else 4)
    np.testing.assert_array_equal(kc.numpy(), np.asarray(want[-2]))
    np.testing.assert_array_equal(vc.numpy(), np.asarray(want[-1]))
    assert not np.array_equal(kc.numpy(), k)          # the row was appended
    for g, w in zip(got[:-2], want[:-2]):
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == w.shape
        assert _relmax(g, w) < 2e-2, _relmax(g, w)


def test_fused_decode_layer_takes_one_position():
    """A scalar position, as in JAX; a vector of positions raises."""
    c = _layer_case(seed=1)
    (k, v), a = _layer_args(c, 0, False)
    kc, vc = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    args = (a, c["layers"][0], (kc, vc), _tt(c["qkv"]), _tt(c["resid"]),
            False, True, False)
    with pytest.raises(ValueError, match="one position"):
        _run_layer(fused_decode_layer, _tt, *args,
                   pos=torch.full((B,), POS, dtype=torch.int32))
    assert np.array_equal(kc.numpy(), k)              # nothing was written
    out0, _, _ = _run_layer(fused_decode_layer, _tt, *args,
                            pos=torch.tensor(POS))
    kc.copy_(torch.from_numpy(k.copy()))
    vc.copy_(torch.from_numpy(v.copy()))
    out1, _, _ = _run_layer(fused_decode_layer, _tt, *args, pos=POS)
    assert torch.equal(out0, out1)


def test_fused_decode_layer_two_layer_chain():
    """Layer 0's next QKV feeds layer 1 (the last), flat caches and
    concatenated gate/up as the decode step stores them, against the same
    chain of the JAX function.

    Layer 0's cache bytes match bit for bit. Layer 1 appends a row made
    from layer 0's computed qkv, which the two sides sum in another order:
    its codes may move by what that difference moves them, at most
    2 max|dk| / k_scale + 1 levels for K (rope mixes two values) and
    max|dv| / v_scale + 1 for V; every other byte matches."""
    c = _layer_case(seed=2, n_layers=2)
    outs = {}
    for side, fn, to in (("jax", j_layer, jnp.asarray),
                         ("port", fused_decode_layer, _tt)):
        qkv, x, caches, qkvs = to(c["qkv"]), to(c["resid"]), [], []
        for i in range(2):
            (k, v), a = _layer_args(c, i, True)
            cache = (to(k.copy()), to(v.copy()))
            res = _run_layer(fn, to, a, c["layers"][i], cache, qkv, x,
                             i == 0, True, True,
                             pos=jnp.int32(POS) if side == "jax" else POS)
            x, qkv = res[0], (res[1] if i == 0 else None)
            caches.append(res[-2:])
            qkvs.append(qkv)
        outs[side] = (x, caches, qkvs[0])
    (jx, jcaches, jq), (px, pcaches, pq) = outs["jax"], outs["port"]
    for name, j, p in (("k", jcaches[0][0], pcaches[0][0]),
                       ("v", jcaches[0][1], pcaches[0][1])):
        np.testing.assert_array_equal(p.numpy(), np.asarray(j), name)
    dq = np.abs(pq.float().numpy() - np.asarray(jq, np.float32))
    nk = slice(H * HD, (H + KH) * HD)
    a1 = _layer_args(c, 1, True)[1]
    for j, p, d, scale, mix in (
            (jcaches[1][0], pcaches[1][0], dq[:, nk], a1["ks"], 2),
            (jcaches[1][1], pcaches[1][1], dq[:, (H + KH) * HD:], a1["vs"],
             1)):
        j = np.asarray(j, np.int32).reshape(B, S, KH, HD)
        p = p.numpy().astype(np.int32).reshape(B, S, KH, HD)
        others = np.arange(S) != POS
        np.testing.assert_array_equal(p[:, others], j[:, others])
        bound = mix * d.reshape(B, KH, HD).max(-1) / np.asarray(scale) + 1
        assert (np.abs(p[:, POS] - j[:, POS]).max(-1) <= bound).all()
    assert _relmax(px, jx) < 2e-2, _relmax(px, jx)


@pytest.mark.parametrize("m", [1, 16, 33, 64])
def test_whole_layer_workspace_sizes(m):
    """The wrapper's workspaces for one launch at Llama-3-8B widths on 132
    blocks: partial sums for the largest GEMM phase's slots (slice + block
    of every piece, M x 256 values each), row partials for the epilogue
    items of a row (1024 columns each)."""
    from aimet_tpu_torch.ops import fused_layer as flay
    from aimet_tpu_torch.ops.int_matmul import decode_plan
    A, D, F, nq = 4096, 4096, 14336, 6144
    part, rowpart = flay.layer_workspace(m, A, D, F, nq, 132)
    need = 0
    for n, rows, halves in ((D, A // 2, 1), (F, D // 2, 2), (D, F // 2, 1),
                            (nq, D // 2, 1)):
        plan = decode_plan(m, n, rows, 132, halves)
        total = plan.slices * plan.steps
        # the highest slot: block b's last unit lies in slice j, slot j + b
        top = max(b + ((b + 1) * total // plan.blocks - 1) // plan.steps
                  for b in range(plan.blocks))
        assert (top + 1) * m * 256 == plan.ws_values
        need = max(need, plan.ws_values)
    assert part == need
    assert rowpart == m * (D // 1024)
    # without the next QKV the largest phase is the same (gate|up)
    assert flay.layer_workspace(m, A, D, F, 0, 132) == (part, rowpart)


@pytest.mark.parametrize("a,d,f,nq,ok", [
    (4096, 4096, 14336, 6144, True),
    (4096, 4096, 14336, 0, True),          # last layer: no next QKV
    (1024, 1024, 1040, 1536, False),       # d_ff not a multiple of 32
    (1040, 1024, 1024, 1552, False),
    (1024, 1024, 1024, 1544, False),       # Nq not a multiple of 16
])
def test_layer_shapes_ok(a, d, f, nq, ok):
    from aimet_tpu_torch.ops import fused_layer as flay
    assert flay.layer_shapes_ok(a, d, f, nq) is ok


@pytest.mark.parametrize("d_ff,fused", [(1024, True), (1040, False)])
def test_serving_takes_the_whole_layer_kernels_only_at_their_widths(
        d_ff, fused):
    """A w4 decode step takes the whole-layer kernels only at widths the
    kernels take; at d_ff = 1040 it runs per op instead of raising."""
    from aimet_tpu_torch.models.transformer import TransformerConfig
    from aimet_tpu_torch.serving import quantized_llm as qllm
    cfg = TransformerConfig(vocab_size=256, d_model=1024, n_layers=1,
                            n_heads=8, n_kv_heads=2, d_ff=d_ff)
    assert qllm._fused_decode_ok(cfg, 16, "w4") is fused
    assert qllm._fused_decode_ok(cfg, 16, "w4a8") is fused
