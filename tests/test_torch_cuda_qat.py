"""Quantization-aware training and GPTQ on the card against the CPU. Every
test here needs a CUDA device and skips without one; the file imports no
JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_qat.py

- ``quantize_dequantize``'s Function on the card: the forward and the
  straight-through gradient equal the CPU's bit for bit; the range-learning
  gradients in f32 within the f32 bound of a sum of n terms, (n + 8) u
  sum m_i, of the same Function in f64 (m_i each term's magnitude before
  its own cancellation);
- a QAT + KD step at TransformerConfig.tiny() on the card against the same
  step on the CPU: loss, weights and learned (min, max) within 4 x the
  CPU's own f32-vs-f64 gap (+ one ulp; the loss also V u of itself), the
  yardstick of tests/test_torch_kd.py, taken here from the CPU step in
  f64;
- GPTQ on tests/test_gptq.py's TinyMLP on the card against the CPU: every
  code equal.
"""
import dataclasses
import functools

import pytest
import torch

from aimet_tpu_torch import QuantizationSimModel
from aimet_tpu_torch.algorithms import (KDConfig, apply_gptq, init_kd_state,
                                        make_qat_kd_step, shift_labels)
from aimet_tpu_torch.models import transformer as transformer_module
from aimet_tpu_torch.models.layers import Dense
from aimet_tpu_torch.models.transformer import Transformer, TransformerConfig
from aimet_tpu_torch.quantization.grads import quantize_dequantize

pytestmark = pytest.mark.cuda
U = 2.0 ** -24


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels)")
    return torch.Generator().manual_seed(0)


def _terms(x, mn, mx, up):
    """The symmetric reference terms and magnitudes in f64."""
    delta = mx / 127.0
    xr = torch.round(x / delta) + 128.0
    xq = torch.clamp(xr, 0.0, 255.0)
    mask = ((xr >= 0) & (xr <= 255)).double()
    g = ((xq - 128.0) * up - mask * (x / delta) * up) / 127.0
    m = ((xq - 128.0).abs() + mask * (x / delta).abs()) * up.abs() / 127.0
    return g, m


@pytest.mark.parametrize("shape,eshape", [((4096,), ()),
                                          ((64, 512), (64, 1))])
def test_function_on_the_card_matches_the_cpu(gen, shape, eshape):
    x = torch.randn(shape, generator=gen) * 1.3
    up = torch.randn(shape, generator=gen)
    mn = -(torch.rand(eshape, generator=gen) + 0.5)
    mx = torch.rand(eshape, generator=gen) + 0.5
    out = {}
    for dev, dt in (("cpu", torch.float32), ("cuda", torch.float32),
                    ("cuda", torch.float64)):
        X, A, B = (t.to(dev, dt).clone().requires_grad_(True)
                   for t in (x, mn, mx))
        y = quantize_dequantize(X, A, B, bitwidth=8, symmetric=True,
                                learn_range=True)
        torch.autograd.backward(y, up.to(dev, dt))
        out[(dev, dt)] = [t.detach().cpu() for t in (y, X.grad, A.grad,
                                                     B.grad)]
    cpu, card, card64 = (out[("cpu", torch.float32)],
                         out[("cuda", torch.float32)],
                         out[("cuda", torch.float64)])
    assert torch.equal(cpu[0], card[0]) and torch.equal(cpu[1], card[1])
    g, m = _terms(x.double(), mn.double().reshape(eshape),
                  mx.double().reshape(eshape), up.double())
    n = x.numel() // max(mn.numel(), 1)
    dims = tuple(range(x.dim())) if not eshape else (1,)
    ref = g.sum(dim=dims).reshape(eshape)
    tol = (n + 8) * U * m.sum(dim=dims).reshape(eshape)
    assert ((card64[3] - ref).abs() <= 1e-9 * tol.clamp(min=1)).all()
    for got in (card[3], cpu[3]):
        assert ((got.double() - ref).abs() <= tol).all()
    assert torch.equal(card[2], -card[3])


class _F64Torch:
    """``torch`` with ``float32`` read as ``float64``."""
    def __getattr__(self, name):
        return torch.float64 if name == "float32" else getattr(torch, name)


def _tiny(dtype):
    cfg = dataclasses.replace(TransformerConfig.tiny(), dtype=dtype)
    torch.manual_seed(0)
    return Transformer(cfg).to(dtype)


def _kd_step(model, tok, device):
    model = model.to(device)
    tok = tok.to(device)
    sim = QuantizationSimModel(model, (tok,), quant_scheme="minmax",
                               device=device)
    sim.compute_encodings(None, [tok])
    for n, spec in list(sim.quantizers.items()):
        if spec.kind != "param":
            sim.set_quantizer_enabled(n, False)
    # eps 1e-3: a smooth Adam step (tests/test_torch_kd.py's EPS)
    opt = functools.partial(torch.optim.AdamW, lr=3e-3, eps=1e-3,
                            weight_decay=1e-4)
    params = {k: v.detach() for k, v in model.named_parameters()}
    state0, step = make_qat_kd_step(
        sim, lambda p, t: torch.func.functional_call(model, p, (t,)), opt,
        KDConfig(enc_lr=1e-3))
    state = init_kd_state(state0, params, opt)
    new, loss = step(state, params, tok, shift_labels(tok))
    return loss.cpu(), {k: v.cpu() for k, v in new.params.items()}, \
        {k: (a.cpu(), b.cpu()) for k, (a, b) in new.enc.items()}


def _within(a32, a64, b, what):
    a32, a64, b = (t.double() for t in (a32, a64, b))
    tol = 4 * (a32 - a64).abs().max() + 2 * U * a64.abs().max()
    assert (a32 - b).abs().max() <= tol, what


def test_qat_kd_step_on_the_card_matches_the_cpu(gen):
    tok = torch.randint(0, 256, (2, 24), generator=gen)
    base = _tiny(torch.float32)
    card = _kd_step(_tiny(torch.float32), tok, "cuda")
    # the CPU step in f64 as the yardstick: the same weights, built and
    # traced with the model's ``torch.float32`` (its scores, norms, rope and
    # lm_head) read as f64
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(transformer_module, "torch", _F64Torch())
        m64 = _tiny(torch.float64)
        m64.load_state_dict({k: v.double()
                             for k, v in base.state_dict().items()})
        ref64 = _kd_step(m64, tok, "cpu")
    cpu = _kd_step(base, tok, "cpu")
    vocab = TransformerConfig.tiny().vocab_size
    assert (cpu[0] - card[0]).abs() <= 4 * (cpu[0] - ref64[0]).abs() + (
        vocab + 2) * U * ref64[0].abs(), "loss"
    for k in cpu[1]:
        _within(cpu[1][k], ref64[1][k], card[1][k], k)
    names = sorted(cpu[2])             # (min)s as one vector, (max)s too
    for i in (0, 1):
        cat = lambda d: torch.cat([d[n][i].reshape(-1).double()
                                   for n in names])
        _within(cat(cpu[2]), cat(ref64[2]), cat(card[2]), ("enc", i))


class _MLP(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.Dense_0 = Dense(16, 32)
        self.Dense_1 = Dense(32, 32)
        self.Dense_2 = Dense(32, 10)

    def forward(self, x):
        x = torch.relu(self.Dense_0(x))
        return self.Dense_2(torch.relu(self.Dense_1(x)))


def test_gptq_on_the_card_matches_the_cpu(gen):
    net = _MLP()
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.3)
    batches = [torch.randn(16, 16, generator=gen) for _ in range(4)]
    out = {}
    for dev in ("cpu", "cuda"):
        m = _MLP()
        m.load_state_dict(net.state_dict())
        m = m.to(dev)
        xs = [b.to(dev) for b in batches]
        sim = QuantizationSimModel(m, (xs[0],), quant_scheme="minmax",
                                   default_param_bw=4, device=dev)
        sim.compute_encodings(None, xs)
        new = apply_gptq(sim, None, xs, block_size=16)
        out[dev] = {k: (new[k].cpu(), sim.encodings[k].delta.cpu())
                    for k in sorted(sim._frozen)}
    assert list(out["cpu"]) == list(out["cuda"]) and out["cpu"]
    for k, (w, d) in out["cpu"].items():
        wc, dc = out["cuda"][k]
        assert torch.equal(d, dc), k
        assert torch.equal(torch.round(w / d), torch.round(wc / dc)), k
