"""Recurrent quantsim and DeepSpeech2 of aimet_tpu_torch against the JAX
package (the intent of tests/test_recurrent_bnre.py's recurrent tests and
packed sequence lengths, and of tests/test_model_zoo_extra.py's
DeepSpeech2 tests).

The same numpy-made weights and inputs go through both packages (the port
on the CPU). ``RecurrentQuantizer`` encodings and outputs are held at the
tolerances of tests/test_torch_quantsim.py (rtol 1e-5, atol 1e-6 for
f32), gradients at rtol 1e-4 / atol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aimet_tpu.models.deepspeech import deepspeech2_apply as jax_ds2_apply
from aimet_tpu.models.deepspeech import quantize_deepspeech2 as jax_qds2
from aimet_tpu.quantsim.recurrent import RecurrentQuantizer as JaxRQ
from aimet_tpu.quantsim.recurrent import RecurrentQuantSpec as JaxSpec
from aimet_tpu_torch import convert
from aimet_tpu_torch.models.deepspeech import (DeepSpeech2, init_deepspeech2,
                                               quantize_deepspeech2)
from aimet_tpu_torch.quantsim.recurrent import (RecurrentQuantizer,
                                                RecurrentQuantSpec,
                                                init_gru_params,
                                                init_lstm_params)

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def _cell(rng, cell_type, input_dim, hidden, recurrent_bias=False):
    g = 4 if cell_type == "lstm" else 3
    p = {"kernel": rng.randn(input_dim, g * hidden).astype(np.float32) * 0.3,
         "recurrent_kernel":
             rng.randn(hidden, g * hidden).astype(np.float32) * 0.3,
         "bias": rng.randn(g * hidden).astype(np.float32) * 0.1}
    if recurrent_bias:
        p["recurrent_bias"] = rng.randn(g * hidden).astype(np.float32) * 0.1
    return p


def _pair(cell_type, params, batches, bits=8):
    """Both quantizers calibrated on the same batches."""
    jq = JaxRQ(cell_type, JaxSpec(bitwidth_act=bits, bitwidth_param=bits))
    jq.compute_encodings({k: jnp.asarray(v) for k, v in params.items()},
                         [jnp.asarray(b) for b in batches])
    pq = RecurrentQuantizer(cell_type, RecurrentQuantSpec(
        bitwidth_act=bits, bitwidth_param=bits))
    pq.compute_encodings({k: _t(v) for k, v in params.items()},
                         [_t(b) for b in batches])
    return jq, pq


def _assert_encodings(jenc, penc):
    assert sorted(jenc) == sorted(penc)
    for k, e in jenc.items():
        for f in ("min", "max", "delta", "offset"):
            np.testing.assert_allclose(
                getattr(penc[k], f).numpy(), np.asarray(getattr(e, f)),
                rtol=RTOL, atol=ATOL, err_msg=(k, f))


@pytest.mark.parametrize("cell_type,bits", [("lstm", 8), ("lstm", 4),
                                            ("gru", 8)])
def test_recurrent_quantizer_matches_jax(cell_type, bits):
    rng = np.random.RandomState(0)
    params = _cell(rng, cell_type, 8, 16, recurrent_bias=cell_type == "gru")
    batches = [rng.randn(4, 12, 8).astype(np.float32) for _ in range(2)]
    x = rng.randn(4, 12, 8).astype(np.float32)
    jq, pq = _pair(cell_type, params, batches, bits)
    want_names = {"input", "hidden", "cell"} if cell_type == "lstm" \
        else {"input", "hidden"}
    assert set(pq.encodings) == want_names
    _assert_encodings(jq.encodings, pq.encodings)
    _assert_encodings(jq.param_encodings, pq.param_encodings)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: _t(v) for k, v in params.items()}
    out_q, (h, c) = pq.quantized_forward(tp, _t(x))
    j_out, (jh, jc) = jax.jit(jq.quantized_forward)(jp, jnp.asarray(x))
    assert out_q.shape == (4, 12, 16)
    _close(out_q, j_out)
    _close(h, jh)
    fp, _ = pq.fp_forward(tp, _t(x))
    _close(fp, jax.jit(jq.fp_forward)(jp, jnp.asarray(x))[0], atol=1e-5)
    err = float((out_q - fp).abs().mean() / fp.abs().mean())
    assert 0 < err < (0.3 if bits == 8 else 1.0)


def test_lstm_int4_worse_than_int8():
    rng = np.random.RandomState(1)
    params = {k: _t(v) for k, v in _cell(rng, "lstm", 8, 16).items()}
    x = _t(rng.randn(4, 12, 8))
    errs = {}
    for bw in (8, 4):
        rq = RecurrentQuantizer("lstm", RecurrentQuantSpec(
            bitwidth_act=bw, bitwidth_param=bw))
        rq.compute_encodings(params, [x])
        out_q, _ = rq.quantized_forward(params, x)
        out_fp, _ = rq.fp_forward(params, x)
        errs[bw] = float((out_q - out_fp).abs().mean())
    assert errs[8] < errs[4]


def test_quantized_forward_grads_match_jax():
    """Straight-through gradients through every step's fake-quant."""
    rng = np.random.RandomState(2)
    params = _cell(rng, "lstm", 4, 8)
    x = rng.randn(2, 6, 4).astype(np.float32)
    jq, pq = _pair("lstm", params, [x])

    def jloss(p):
        return jnp.sum(jq.quantized_forward(p, jnp.asarray(x))[0] ** 2)

    jg = jax.jit(jax.grad(jloss))(
        {k: jnp.asarray(v) for k, v in params.items()})
    tp = {k: _t(v).requires_grad_() for k, v in params.items()}
    (pq.quantized_forward(tp, _t(x))[0] ** 2).sum().backward()
    for k in params:
        _close(tp[k].grad, jg[k], rtol=1e-4, atol=1e-5)
    assert all(float(tp[k].grad.abs().sum()) > 0 for k in params)


def test_packed_sequence_lengths_match_jax():
    """Carries freeze at each sequence's end; outputs past it are zero."""
    rng = np.random.RandomState(3)
    params = _cell(rng, "lstm", 6, 10)
    jq, pq = _pair("lstm", params, [rng.randn(3, 7, 6).astype(np.float32)])
    x = rng.randn(3, 7, 6).astype(np.float32)
    lengths = np.array([7, 4, 2])
    tp = {k: _t(v) for k, v in params.items()}
    out, (h, c) = pq.quantized_forward(tp, _t(x),
                                       seq_lengths=torch.from_numpy(lengths))
    out_full, _ = pq.quantized_forward(tp, _t(x))
    assert float(out[1, 4:].abs().max()) == 0.0
    assert float(out[2, 2:].abs().max()) == 0.0
    _close(out[1, :4], out_full[1, :4])
    _close(h[2], out_full[2, 1])
    _close(h[0], out_full[0, -1])
    j_out, (jh, jc) = jax.jit(jq.quantized_forward)(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
        seq_lengths=jnp.asarray(lengths))
    _close(out, j_out)
    _close(h, jh)
    _close(c, jc)


def test_recurrent_qat_improves_quantized_lstm():
    """BASELINE row 6 in miniature: INT8 recurrent QAT through the
    per-step fake-quant recovers a teacher LSTM's outputs (Adam, 60
    steps, as tests/test_recurrent_bnre.py)."""
    rng = np.random.RandomState(4)
    gen = torch.Generator().manual_seed(0)
    params = init_lstm_params(gen, 4, 8, device="cpu")
    teacher = init_lstm_params(torch.Generator().manual_seed(7), 4, 8,
                               device="cpu")
    x = _t(rng.randn(16, 10, 4))
    target, _ = RecurrentQuantizer("lstm").fp_forward(teacher, x)
    rq = RecurrentQuantizer("lstm")
    rq.compute_encodings(params, [x])
    p = {k: v.clone().requires_grad_() for k, v in params.items()}
    opt = torch.optim.Adam(p.values(), lr=5e-3)
    l0 = None
    for _ in range(60):
        opt.zero_grad()
        loss = ((rq.quantized_forward(p, x)[0] - target) ** 2).mean()
        loss.backward()
        opt.step()
        l0 = float(loss.detach()) if l0 is None else l0
    assert float(loss.detach()) < l0 * 0.7


def test_init_params_shapes_and_generator():
    g = torch.Generator().manual_seed(0)
    lstm = init_lstm_params(g, 5, 7, device="cpu")
    gru = init_gru_params(torch.Generator().manual_seed(0), 5, 7,
                          device="cpu")
    assert lstm["kernel"].shape == (5, 28) and gru["kernel"].shape == (5, 21)
    assert lstm["recurrent_kernel"].shape == (7, 28)
    assert float(lstm["bias"].abs().sum()) == 0.0
    again = init_lstm_params(torch.Generator().manual_seed(0), 5, 7,
                             device="cpu")
    assert torch.equal(again["kernel"], lstm["kernel"])


# ---------------------------------------------------------------------------
# DeepSpeech2 (tests/test_model_zoo_extra.py)
# ---------------------------------------------------------------------------
def ds2_params(rng, n_mels, conv_channels, hidden, num_layers, vocab):
    """The JAX package's DeepSpeech2 tree (its shapes and scales, small
    random biases) drawn with numpy."""
    freq = -(-(-(-n_mels // 2)) // 2)

    def normal(scale, *shape):
        return (rng.randn(*shape) * scale).astype(np.float32)

    def lstm(in_dim):
        return {"kernel": normal(0.1, in_dim, 4 * hidden),
                "recurrent_kernel": normal(0.1, hidden, 4 * hidden),
                "bias": normal(0.05, 4 * hidden)}

    c = conv_channels
    params = {"conv1": {"kernel": normal(0.05, 11, 11, 1, c),
                        "bias": normal(0.05, c)},
              "conv2": {"kernel": normal(0.05, 11, 11, c, c),
                        "bias": normal(0.05, c)},
              "lstm": [], "head": {"kernel": normal(0.05, 2 * hidden, vocab),
                                   "bias": normal(0.05, vocab)}}
    in_dim = c * freq
    for _ in range(num_layers):
        params["lstm"].append({"fwd": lstm(in_dim), "bwd": lstm(in_dim)})
        in_dim = 2 * hidden
    return params


@pytest.fixture(scope="module")
def ds2_pair():
    rng = np.random.RandomState(0)
    params = jax.tree_util.tree_map(jnp.asarray, ds2_params(
        rng, n_mels=16, conv_channels=4, hidden=16, num_layers=2, vocab=12))
    xs = [rng.randn(2, 20, 16).astype(np.float32) * 0.5 for _ in range(3)]
    model = DeepSpeech2(16, 4, 16, 2, 12)
    model.load_state_dict(convert.deepspeech_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return params, model, xs


def test_deepspeech2_forward_matches_jax(ds2_pair):
    params, model, xs = ds2_pair
    with torch.no_grad():
        out = model(_t(xs[0]))
    assert out.shape == (2, 10, 12)
    _close(out.exp().sum(-1), np.ones((2, 10)), rtol=1e-4)
    _close(out, jax.jit(jax_ds2_apply)(params, jnp.asarray(xs[0])),
           atol=1e-5)
    names = [convert.jax_param_key(n, root=None)
             for n, _ in model.named_parameters()]
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    assert sorted(names) == sorted(jax.tree_util.keystr(p)
                                   for p, _ in leaves)


def test_deepspeech2_recurrent_quantsim_matches_jax(ds2_pair):
    params, model, xs = ds2_pair
    jq_apply, jquantizers = jax_qds2(params, [jnp.asarray(b)
                                              for b in xs[:2]])
    qapply, quantizers = quantize_deepspeech2(model, [_t(b) for b in xs[:2]])
    assert len(quantizers) == len(jquantizers) == 2
    for (rq_f, rq_b), (jf, jb) in zip(quantizers, jquantizers):
        assert {"input", "hidden", "cell"} <= set(rq_f.encodings)
        _assert_encodings(jf.encodings, rq_f.encodings)
        _assert_encodings(jb.encodings, rq_b.encodings)
    with torch.no_grad():
        ref = model(_t(xs[2]))
        q = qapply(model, _t(xs[2]))
    want = jax.jit(jq_apply)(params, jnp.asarray(xs[2]))
    assert q.shape == ref.shape
    _close(q, want)
    sqnr = 10 * np.log10(float((ref ** 2).sum() / ((ref - q) ** 2).sum()))
    assert sqnr > 15.0


def test_deepspeech_odd_mels():
    """n_mels not divisible by 4: ceil(ceil(F/2)/2) bins feed the LSTM."""
    model = init_deepspeech2(torch.Generator().manual_seed(1), n_mels=30,
                             conv_channels=4, hidden=8, num_layers=1,
                             vocab=5, device="cpu")
    x = _t(np.random.RandomState(0).randn(1, 12, 30))
    with torch.no_grad():
        assert model(x).shape == (1, 6, 5)
