"""AdaRound, adaptive rounding of the weights — counterpart of
``aimet_tpu/algorithms/adaround.py`` (reference: aimet_torch/v1/adaround/).
Per layer, in graph order, a rounding direction for every weight is
learned by reconstructing the layer's float outputs from its
quantized-so-far inputs.

The math is the JAX package's:
  - soft quant: W_soft = (clamp(floor(W/delta) + h(alpha) - offset, 0, ns)
    + offset) * delta, with h(a) = clamp(sigmoid(a)(zeta-gamma)+gamma, 0, 1),
    zeta = 1.1, gamma = -0.1 (adaround_wrapper.py:124-149);
  - alpha init: -log((zeta-gamma)/(W/delta - floor(W/delta) - gamma) - 1)
    (adaround_wrapper.py:213-224);
  - loss: the channel-summed reconstruction MSE + reg * sum(1 - |2h-1|^beta),
    beta cosine-annealed from 20 to 2 after a warm start of 0.2
    (adaround_loss.py:71-135);
  - Adam as optax has it: bias-corrected m / (sqrt(v) + eps), eps outside
    the root.

The JAX package compiles the whole Adam loop into one ``fori_loop``. Here
a step is a few dozen kernels dispatched from the host, so on the card a
chunk of steps (``_graph_chunk``: a twentieth of the iterations, at most
100, so that a capture never costs more than the replays it saves) is
captured as one CUDA graph and the graph is replayed; everything that
depends on the iteration (the beta schedule, the warm-start switch, the
batch pick ``it % n_batches``) reads a step counter on the device, so a
replay computes what the eager loop computes, bit for bit (cuDNN runs its
deterministic algorithms, in f32, in both). On the CPU the loop runs
eagerly.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import math
import os
from typing import Optional, Sequence

import numpy as np
import torch

from ..graph.connected_graph import Op
from ..graph.interpreter import OpReplay
from ..quantsim.qsim import QuantizationSimModel, _broadcast_encoding
from ..utils.pytree import set_leaves
from .bn_fold import _conv_axes

ZETA = 1.1    # aimet_common/defs.py:305
GAMMA = -0.1  # aimet_common/defs.py:306
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8   # optax.adam's defaults


@dataclasses.dataclass
class AdaroundParameters:
    """aimet_torch/v1/adaround/adaround_weight.py:78-104."""
    num_batches: int = 4
    num_iterations: int = 10000
    reg_param: float = 0.01
    beta_range: tuple = (20, 2)
    warm_start: float = 0.2
    learning_rate: float = 1e-3


def _graph_chunk(num_iterations: int) -> int:
    """The Adam steps captured in one CUDA graph on the card."""
    return min(100, max(1, num_iterations // 20))


def _h_alpha(alpha):
    return torch.clamp(torch.sigmoid(alpha) * (ZETA - GAMMA) + GAMMA,
                       0.0, 1.0)


def _alpha_init(w, delta):
    rest = w / delta - torch.floor(w / delta)
    rest = torch.clamp(rest, 1e-4, 1 - 1e-4)  # guard the logit
    return -torch.log((ZETA - GAMMA) / (rest - GAMMA) - 1)


def _beta(num_iter, cur_iter, beta_range, warm_start):
    start_beta, end_beta = beta_range
    warm_end = warm_start * num_iter
    rel = (cur_iter - warm_end) / (num_iter - warm_end)
    return end_beta + 0.5 * (start_beta - end_beta) * (
        1 + torch.cos(rel * math.pi))


def _layer_apply(replay: OpReplay, x, w, bias, params=None):
    """The op's output on ``x`` with the kernel ``w`` and the bias
    ``bias`` (any other parameter it reads from ``params``)."""
    roles = replay.op.param_products
    over = {roles["kernel"].param_path: w}
    if bias is not None:
        over[roles["bias"].param_path] = bias
    return replay(x, collections.ChainMap(over, params or {}))


def _soft_quant(w, delta_b, offset_b, ns, alpha, soft=True):
    t = torch.floor(w / delta_b)
    h = _h_alpha(alpha) if soft else (alpha >= 0).to(w.dtype)
    q = torch.clamp(t + h - offset_b, 0.0, ns)
    return (q + offset_b) * delta_b


class _RoundingOptimizer:
    """The Adam loop over alpha for one layer; its state (alpha, the two
    moments and the iteration) lives in tensors updated in place, so a
    captured graph of ``step`` replays on them."""

    def __init__(self, replay, w, bias, delta_b, offset_b, ns, xs, ys,
                 cfg: AdaroundParameters, out_channel_axis, params=None):
        self.replay, self.w, self.bias = replay, w, bias
        self.delta_b, self.offset_b, self.ns = delta_b, offset_b, ns
        self.xs, self.ys, self.cfg = xs, ys, cfg
        self.out_axis, self.params = out_channel_axis, params
        self.niter = cfg.num_iterations
        self.warm_iters = int(cfg.warm_start * self.niter)
        self.alpha = _alpha_init(w, delta_b).detach().requires_grad_(True)
        self.m = torch.zeros_like(self.alpha, requires_grad=False)
        self.v = torch.zeros_like(self.m)
        self.it = torch.zeros((), dtype=torch.int64, device=w.device)

    def state(self):
        return (self.alpha, self.m, self.v, self.it)

    def loss(self, alpha, x, y, itf):
        w_soft = _soft_quant(self.w, self.delta_b, self.offset_b, self.ns,
                             alpha, soft=True)
        out = _layer_apply(self.replay, x, w_soft, self.bias, self.params)
        recon = ((out - y) ** 2).sum(dim=self.out_axis).mean()
        h = _h_alpha(alpha)
        beta = _beta(self.niter, itf, self.cfg.beta_range,
                     self.cfg.warm_start)
        reg = (1 - (2 * h - 1).abs() ** beta).sum()
        round_loss = torch.where(itf < self.warm_iters,
                                 torch.zeros_like(reg),
                                 self.cfg.reg_param * reg)
        return recon + round_loss

    def step(self):
        k = torch.remainder(self.it, self.xs.shape[0]).reshape(1)
        x = self.xs.index_select(0, k)[0]
        y = self.ys.index_select(0, k)[0]
        itf = self.it.to(torch.float32)
        with torch.enable_grad():
            (g,) = torch.autograd.grad(self.loss(self.alpha, x, y, itf),
                                       self.alpha)
        with torch.no_grad():
            self.it.add_(1)
            count = self.it.to(torch.float32)
            self.m.copy_((1 - ADAM_B1) * g + ADAM_B1 * self.m)
            self.v.copy_((1 - ADAM_B2) * (g * g) + ADAM_B2 * self.v)
            m_hat = self.m / (1 - torch.pow(ADAM_B1, count))
            v_hat = self.v / (1 - torch.pow(ADAM_B2, count))
            upd = m_hat / (torch.sqrt(v_hat) + ADAM_EPS)
            self.alpha.add_(upd * -self.cfg.learning_rate)

    def run_eager(self, steps: int):
        for _ in range(steps):
            self.step()

    def capture(self, steps: int) -> "torch.cuda.CUDAGraph":
        """A CUDA graph of ``steps`` steps on this state. Three warm-up
        steps run first on a side stream (library handles, the wrappers'
        workspaces), then the state is put back as it was."""
        saved = [t.detach().clone() for t in self.state()]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self.run_eager(3)
        torch.cuda.current_stream().wait_stream(side)
        with torch.no_grad():
            for t, s in zip(self.state(), saved):
                t.copy_(s)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.run_eager(steps)
        return graph

    def run(self, chunk: Optional[int] = None):
        """All ``num_iterations`` steps: replays of a captured chunk of
        ``chunk`` steps (default ``_graph_chunk(num_iterations)``) on the
        card, the remainder eagerly; ``chunk=0`` or the CPU: eagerly."""
        if chunk is None:
            chunk = _graph_chunk(self.niter)
        with torch.backends.cudnn.flags(enabled=True, deterministic=True,
                                        allow_tf32=False):
            if not (self.w.is_cuda and chunk):
                self.run_eager(self.niter)
                return
            n_graph, rest = divmod(self.niter, chunk)
            if n_graph:
                graph = self.capture(chunk)
                for _ in range(n_graph):
                    graph.replay()
                del graph
            self.run_eager(rest)

    def hard_weight(self):
        with torch.no_grad():
            return _soft_quant(self.w, self.delta_b, self.offset_b, self.ns,
                               self.alpha, soft=False)


def _rounding_optimizer(replay, w, bias, encoding, channel_axis, x_batches,
                        y_batches, params_cfg, out_channel_axis, params=None):
    ns = float(encoding.num_steps)
    delta_b = _broadcast_encoding(encoding.delta, w.dim(), channel_axis)
    offset_b = _broadcast_encoding(encoding.offset, w.dim(), channel_axis)
    return _RoundingOptimizer(
        replay, w.detach(), None if bias is None else bias.detach(), delta_b,
        offset_b, ns, torch.stack(x_batches), torch.stack(y_batches),
        params_cfg, out_channel_axis, params)


def optimize_layer_rounding(replay: OpReplay, w, bias, encoding,
                            channel_axis, x_batches, y_batches,
                            params_cfg: AdaroundParameters, out_channel_axis,
                            params=None):
    """Adam over alpha for one layer (``replay``: the layer's op); returns
    the hard-rounded weight."""
    opt = _rounding_optimizer(replay, w, bias, encoding, channel_axis,
                              x_batches, y_batches, params_cfg,
                              out_channel_axis, params)
    opt.run()
    return opt.hard_weight()


def adaround_layers(sim: QuantizationSimModel):
    """The conv and linear ops with a quantized kernel, in graph order."""
    return [op for op in sim.graph.ops
            if op.type in ("conv", "depthwise_conv", "linear")
            and "kernel" in op.param_products
            and op.param_products["kernel"].param_path in sim.quantizers]


def _args(batch):
    return tuple(batch) if isinstance(batch, (tuple, list)) else (batch,)


def layer_batches(sim: QuantizationSimModel, op: Op, new_params, params,
                  data_batches):
    """(inputs, targets) of one layer: its input in the quantized-so-far
    model (``new_params``), its output in the float model (``params``),
    per batch (activation_sampler.py:175)."""
    in_name, out_name = op.inputs[0].name, op.output.name
    xs, ys = [], []
    for batch in data_batches:
        xs.append(sim.collect_activations(new_params, _args(batch),
                                          [in_name], mode="quantized")
                  [in_name])
        ys.append(sim.collect_activations(params, _args(batch), [out_name],
                                          mode="fp")[out_name])
    return xs, ys


def apply_adaround(sim: QuantizationSimModel, params, data_batches: Sequence,
                   ada_params: Optional[AdaroundParameters] = None,
                   cache_dir: Optional[str] = None,
                   cache_key: str = "adaround"):
    """AdaRound every conv / linear layer (Adaround.apply_adaround,
    adaround_weight.py:114). Returns params with the rounded (dequantized)
    weights; their encodings are set and frozen on ``sim``, so a later
    ``compute_encodings`` keeps them. ``params`` None: the model's own.

    ``cache_dir``: each rounded weight is saved there with a fingerprint
    of the weight it came from (adaround_weight.py:596), and a later run on
    the same weights loads it instead of optimizing the layer again."""
    ada_params = ada_params or AdaroundParameters()
    params = sim.params if params is None else params
    data_batches = list(data_batches)[:ada_params.num_batches]
    # parameter encodings must exist before the first layer
    sim.compute_param_encodings(params)

    new_params = params
    for op in adaround_layers(sim):
        kpath = op.param_products["kernel"].param_path
        spec = sim.quantizers[kpath]
        w = new_params[kpath]
        bias = None
        if "bias" in op.param_products:
            bias = new_params[op.param_products["bias"].param_path]
        # this layer's encoding from the current (possibly equalized) w
        sim.compute_param_encodings(new_params, only=[kpath])
        encoding = sim.encodings[kpath]

        cpath = None
        if cache_dir is not None:
            os.makedirs(cache_dir, exist_ok=True)
            cpath = os.path.join(cache_dir, f"{cache_key}.{op.name}.npz")
            w_np = w.detach().cpu().numpy()
            w_fp = hashlib.sha1(w_np.tobytes()).hexdigest()[:16]
            if os.path.exists(cpath):
                cached = np.load(cpath)
                if tuple(cached["w"].shape) == tuple(w.shape) \
                        and "w_fp" in cached and str(cached["w_fp"]) == w_fp:
                    new_params = set_leaves(new_params, {
                        kpath: torch.from_numpy(cached["w"]).to(w.device)})
                    sim.set_encoding(kpath, encoding, freeze=True)
                    continue

        x_batches, y_batches = layer_batches(sim, op, new_params, params,
                                             data_batches)
        w_ada = optimize_layer_rounding(
            OpReplay(sim.graph, op), w, bias, encoding, spec.channel_axis,
            x_batches, y_batches, ada_params, _conv_axes(op)[2], new_params)
        new_params = set_leaves(new_params, {kpath: w_ada})
        sim.set_encoding(kpath, encoding, freeze=True)
        if cpath is not None:
            np.savez(cpath, w=w_ada.cpu().numpy(), w_fp=np.asarray(w_fp))
    return new_params
