"""The PTQ path on the card. Every test here needs a CUDA device and skips
without one; the file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_ptq.py

- AdaRound's captured loop (CUDA graphs of a chunk of Adam steps, the
  iteration read from a step counter on the device) equals the eager loop
  bit for bit — alpha, both moments, the counter — on a stride-2 3 x 3
  conv with flax "SAME" padding (the pad replayed with the op), with a
  chunk that leaves a remainder to run eagerly;
- the percentile, mse and entropy analyzers give on the card the
  encodings they give on the CPU for the same tensor (entropy within 1e-6
  relative: the histogram's rescale is a matmul);
- a sim on the card calibrates, exports and loads its encodings back bit
  for bit, and SeqMSE freezes an encoding a layer.
"""
import json

import pytest
import torch

from aimet_tpu_torch import QuantizationSimModel, QuantSimConfig
from aimet_tpu_torch.algorithms import (AdaroundParameters, apply_seq_mse,
                                        equalize_model)
from aimet_tpu_torch.algorithms import adaround as ada
from aimet_tpu_torch.graph.connected_graph import ConnectedGraph
from aimet_tpu_torch.graph.interpreter import OpReplay
from aimet_tpu_torch.models.layers import BatchNorm, Conv, Dense
from aimet_tpu_torch.quantization.encoding_analyzer import EncodingAnalyzer

pytestmark = pytest.mark.cuda


class _Net(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.Conv_0 = Conv(3, 16, (3, 3), use_bias=True)
        self.BatchNorm_0 = BatchNorm(16)
        self.Conv_1 = Conv(16, 32, (3, 3), (2, 2), use_bias=True)
        self.Dense_0 = Dense(32, 10)

    def forward(self, x):
        x = torch.relu(self.BatchNorm_0(self.Conv_0(x)))
        return self.Dense_0(torch.relu(self.Conv_1(x)).mean(dim=(2, 3)))


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels)")
    return torch.Generator(device="cuda").manual_seed(0)


def _net(gen):
    with torch.device("cuda"):
        net = _Net()
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.randn(p.shape, generator=gen, device="cuda") * 0.3)
        net.BatchNorm_0.var.abs_().add_(0.5)
    xs = [torch.randn((4, 3, 16, 16), generator=gen, device="cuda")
          for _ in range(2)]
    return net, xs


@pytest.mark.parametrize("steps,chunk", [(200, 100), (130, 40)])
def test_adaround_captured_loop_equals_eager(gen, steps, chunk):
    net, xs = _net(gen)
    sim = QuantizationSimModel(net, (xs[0],), quant_scheme="minmax",
                               default_param_bw=4)
    sim.compute_encodings(None, xs)
    op = sim.graph.get_op("conv_1")
    assert any(n.target == torch.ops.aten.constant_pad_nd.default
               for n in OpReplay(sim.graph, op).nodes)
    params = sim.params
    kpath = op.param_products["kernel"].param_path
    xb, yb = ada.layer_batches(sim, op, params, params, xs)

    def make():
        return ada._rounding_optimizer(
            OpReplay(sim.graph, op), params[kpath],
            params[op.param_products["bias"].param_path],
            sim.encodings[kpath], None, xb, yb,
            AdaroundParameters(num_iterations=steps), 1, params)

    eager, graph = make(), make()
    eager.run(0)
    graph.run(chunk)
    for a, b in zip(eager.state(), graph.state()):
        assert torch.equal(a, b)
    assert int(graph.it) == steps


@pytest.mark.parametrize("scheme", ["percentile", "mse", "entropy"])
def test_analyzers_on_the_card_match_the_cpu(gen, scheme):
    xs = [torch.randn((64, 300), generator=gen, device="cuda") * s
          for s in (1.0, 3.0)]
    out = {}
    for dev in ("cuda", "cpu"):
        an = EncodingAnalyzer(scheme, percentile=99.0)
        st = an.init_state(device=dev)
        for x in xs:
            st = an.update(st, x.to(dev))
        out[dev] = an.compute(st, 8, False)
    for f in ("min", "max", "delta", "offset"):
        a, b = getattr(out["cuda"], f).cpu(), getattr(out["cpu"], f)
        if scheme == "entropy":
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
        else:
            assert torch.equal(a, b), f


def test_sim_on_the_card_exports_loads_and_seq_mse(gen, tmp_path):
    net, xs = _net(gen)
    eq = equalize_model(ConnectedGraph(net, (xs[0],)), {
        k: p.detach() for k, p in net.named_parameters()})
    sim = QuantizationSimModel(net, (xs[0],), quant_scheme="sqnr",
                               config=QuantSimConfig.per_channel_default())
    sim.compute_encodings(eq, xs)
    path = sim.export(str(tmp_path), "net")
    fresh = QuantizationSimModel(net, (xs[0],),
                                 config=QuantSimConfig.per_channel_default())
    with open(path) as f:
        fresh.load_encodings(json.load(f))
    for k, e in sim.encodings.items():
        for f in ("min", "max", "delta", "offset"):
            assert torch.equal(getattr(e, f), getattr(fresh.encodings[k], f))
    assert apply_seq_mse(sim, eq, xs, num_candidates=10) == \
        ["conv_0", "conv_1", "linear_0"]
    assert torch.isfinite(sim.quantized_fn(eq, xs[0])).all()
