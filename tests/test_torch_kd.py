"""QAT + knowledge distillation in aimet_tpu_torch against the JAX package
(``aimet_tpu.algorithms.kd``), on the same numpy-made inputs
(``device="cpu"``).

- ``kd_loss`` (several temperatures / mixes, a masked position) and its
  gradient to the student's logits, ``shift_labels`` bit for bit.
- Three ``make_qat_kd_step`` steps on TransformerConfig.tiny() (weights
  drawn with numpy; parameter quantizers alone, the JAX sim's encodings
  carried across) against JAX's with ``optax.adamw``: b1, b2, eps and
  weight decay set to the same values on both sides (their defaults
  differ: weight decay 1e-4 in optax, 1e-2 in torch.optim.AdamW; eps 1e-3,
  see ``EPS``). The losses, the weights and the learned (min, max) after
  each step (each weight tensor, all the (min) encodings as one vector,
  the (max) as another) are held to JAX's with the port's own f32 error as
  the yardstick, as in tests/test_torch_qat.py: within 4 x max|x32 - x64|
  (+ one ulp, 2u max|x|, for the result's own rounding) of JAX's, x64 the
  port's value from an f64 twin of the model, its inputs, encodings and
  optimizer; the loss, a scalar, also within V u of itself (the worst
  error of its softmax sums over the vocabulary of V).
- ``remat=True`` (``torch.utils.checkpoint``) gives the plain step's loss,
  weights and encodings bit for bit; the step writes into no tensor of the
  state it is given.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from aimet_tpu.algorithms import kd as jkd
from aimet_tpu.quantsim.qsim import QuantizationSimModel as JaxSim
from aimet_tpu_torch import QuantizationSimModel, convert
from aimet_tpu_torch.algorithms import (KDConfig, init_kd_state, kd_loss,
                                        make_qat_kd_step, shift_labels)
from aimet_tpu_torch.models import transformer as transformer_module
from aimet_tpu_torch.models.transformer import Transformer, TransformerConfig
from torch_ptq_util import one_thread
from torch_quantsim_util import tiny_numpy_pair, to_torch

U = 2.0 ** -24
# eps 1e-3: Adam's step g / (|g| + eps) is then a smooth function of the
# gradient; at eps 1e-8 an entry whose gradient is near 0 takes a step set
# by the gradient's f32 rounding, which differs between any two f32 runs
LR, B1, B2, EPS, WD = 3e-3, 0.9, 0.999, 1e-3, 1e-4
ENC_LR = 1e-3


def _within(got32, got64, want, what):
    got32, got64, want = (np.asarray(a, np.float64) for a in
                          (got32, got64, want))
    tol = 4 * np.abs(got32 - got64).max() + 2 * U * np.abs(got64).max()
    err = np.abs(got32 - want).max()
    assert err <= tol, (what, err, tol)


@pytest.mark.parametrize("temperature,alpha", [(2.0, 0.5), (1.0, 0.0),
                                               (3.0, 1.0)])
def test_kd_loss_matches_jax(temperature, alpha):
    rs = np.random.RandomState(int(temperature * 10 + alpha * 3))
    s = (rs.randn(2, 5, 11) * 2).astype(np.float32)
    t = (rs.randn(2, 5, 11) * 2).astype(np.float32)
    labels = rs.randint(0, 11, (2, 5)).astype(np.int32)
    labels[0, 3] = -100
    jcfg = jkd.KDConfig(temperature=temperature, alpha=alpha)
    cfg = KDConfig(temperature=temperature, alpha=alpha)
    jl, jg = jax.value_and_grad(lambda a: jkd.kd_loss(
        a, jnp.asarray(t), jnp.asarray(labels), jcfg))(jnp.asarray(s))
    out = []
    for dt in (torch.float32, torch.float64):
        S = torch.tensor(s, dtype=dt, requires_grad=True)
        loss = kd_loss(S, torch.tensor(t, dtype=dt),
                       torch.from_numpy(labels).long(), cfg)
        loss.backward()
        out.append((loss.detach().numpy(), S.grad.numpy()))
    _within(out[0][0], out[1][0], jl, "loss")
    _within(out[0][1], out[1][1], jg, "grad")
    # the masked position's logits do not move the loss
    assert not out[0][1][0, 3].any()


def test_shift_labels_matches_jax():
    tokens = np.array([[5, 6, 7, 0], [1, 0, 2, 3]], np.int32)
    for pad in (None, 0):
        want = np.asarray(jkd.shift_labels(jnp.asarray(tokens), pad_id=pad))
        got = shift_labels(torch.from_numpy(tokens).long(), pad_id=pad)
        np.testing.assert_array_equal(got.numpy(), want)


class _F64Torch:
    """``torch`` with ``float32`` read as ``float64``."""
    def __getattr__(self, name):
        return torch.float64 if name == "float32" else getattr(torch, name)


@pytest.fixture(scope="module")
def kd_setup():
    """The JAX and port sims of tiny with only their parameter encodings
    (the activation quantizers have none and stay off; the JAX encodings
    carried across), the port's f64 twin, the teachers and a fixed
    batch."""
    fn, variables, tm, tok, batches = tiny_numpy_pair()
    js = JaxSim(fn, (variables, jnp.asarray(tok)), quant_scheme="minmax")
    js.compute_param_encodings(variables)
    ts = QuantizationSimModel(tm, (to_torch(tok),), quant_scheme="minmax",
                              device="cpu")
    for k, v in convert.encodings_from_jax(js.encodings,
                                           device="cpu").items():
        ts.set_encoding(k, v)
    cfg64 = dataclasses.replace(TransformerConfig.tiny(), dtype=torch.float64)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(transformer_module, "torch", _F64Torch())
        tm64 = Transformer(cfg64).double()
        tm64.load_state_dict({k: v.double()
                              for k, v in tm.state_dict().items()})
        ts64 = QuantizationSimModel(tm64, (to_torch(tok),),
                                    quant_scheme="minmax", device="cpu")
    for k, e in ts.encodings.items():
        ts64.set_encoding(k, dataclasses.replace(
            e, min=e.min.double(), max=e.max.double(),
            delta=e.delta.double(), offset=e.offset.double()))
    return fn, variables, js, tm, ts, tm64, ts64, tok


def _teacher(model):
    return lambda p, t: torch.func.functional_call(model, p, (t,))


def _port_steps(sim, model, tok, labels, n, cfg):
    opt = functools.partial(torch.optim.AdamW, lr=LR, betas=(B1, B2),
                            eps=EPS, weight_decay=WD)
    params = {k: v.detach() for k, v in model.named_parameters()}
    state0, step = make_qat_kd_step(sim, _teacher(model), opt, cfg)
    state = init_kd_state(state0, params, opt)
    out = []
    for _ in range(n):
        state, loss = step(state, params, tok, labels)
        out.append((loss.item(), state))
    return out


def test_qat_kd_steps_match_jax(kd_setup):
    fn, variables, js, tm, ts, tm64, ts64, tok = kd_setup
    rs = np.random.RandomState(1)
    toks = rs.randint(0, 256, tok.shape).astype(np.int32)
    jopt = optax.adamw(LR, b1=B1, b2=B2, eps=EPS, weight_decay=WD)
    jcfg = jkd.KDConfig(temperature=2.0, alpha=0.5, enc_lr=ENC_LR)
    state0, jstep = jkd.make_qat_kd_step(js, fn, jopt, jcfg)
    jstate = jkd.init_kd_state(state0, variables, jopt)
    jstep = jax.jit(jstep)
    jt = jnp.asarray(toks)
    jlabels = jkd.shift_labels(jt)
    want = []
    for _ in range(3):
        jstate, jl = jstep(jstate, variables, jt, jlabels)
        want.append((float(jl), jstate))

    cfg = KDConfig(temperature=2.0, alpha=0.5, enc_lr=ENC_LR)
    t = to_torch(toks)
    labels = shift_labels(t)
    got = _port_steps(ts, tm, t, labels, 3, cfg)
    got64 = _port_steps(ts64, tm64, t, labels, 3, cfg)
    losses = [g[0] for g in got]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    vocab = TransformerConfig.tiny().vocab_size
    for (l32, s32), (l64, s64), (jl, js_) in zip(got, got64, want):
        # the loss: a scalar whose own gap can be near 0 by chance; its
        # worst f32 step is the softmax sums over the vocabulary, which err
        # by up to V u relative (XLA's jitted exp / log round apart)
        assert abs(l32 - jl) <= 4 * abs(l32 - l64) + (vocab + 2) * U * abs(
            l64), (l32, l64, jl)
        jp = {convert.port_param_name(jax.tree_util.keystr(p)): v for p, v in
              jax.tree_util.tree_leaves_with_path(js_.params)}
        assert sorted(s32.params) == sorted(jp)
        for k in s32.params:
            _within(s32.params[k], s64.params[k], jp[k], k)
        # all the (min) encodings as one vector, the (max) as another
        names = sorted(s32.enc)
        jenc = {convert.port_param_name(k): v for k, v in js_.enc.items()}
        assert names == sorted(jenc)
        for i in (0, 1):
            cat = lambda d: np.concatenate(
                [np.asarray(d[n][i], np.float64).reshape(-1) for n in names])
            _within(cat(s32.enc), cat(s64.enc), cat(jenc), ("enc", i))
    moved = max((s32.enc[n][1] - ts.encodings[n].max).abs().max().item()
                for n in s32.enc)
    assert moved > 0


def test_remat_step_matches_plain_and_keeps_state(kd_setup):
    _, _, _, tm, ts, _, _, tok = kd_setup
    t = to_torch(tok)
    labels = shift_labels(t)
    opt = functools.partial(torch.optim.AdamW, lr=LR)
    params = {k: v.detach() for k, v in tm.named_parameters()}
    snapshot = {k: v.clone() for k, v in params.items()}
    results = []
    for remat in (False, True):
        state0, step = make_qat_kd_step(ts, _teacher(tm), opt,
                                        KDConfig(remat=remat))
        state = init_kd_state(state0, params, opt)
        before = {k: v.clone() for k, v in state.params.items()}
        enc_before = {k: (a.clone(), b.clone())
                      for k, (a, b) in state.enc.items()}
        new, loss = step(state, params, t, labels)
        # the step wrote into no tensor of the state it was given
        assert all(torch.equal(state.params[k], before[k]) for k in before)
        assert all(torch.equal(state.enc[k][0], enc_before[k][0])
                   and torch.equal(state.enc[k][1], enc_before[k][1])
                   for k in enc_before)
        results.append((loss, new))
    (l0, s0), (l1, s1) = results
    assert torch.equal(l0, l1)
    assert all(torch.equal(s0.params[k], s1.params[k]) for k in s0.params)
    assert all(torch.equal(s0.enc[k][i], s1.enc[k][i])
               for k in s0.enc for i in (0, 1))
    assert all(torch.equal(params[k], snapshot[k]) for k in params)
