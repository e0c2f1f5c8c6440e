"""QAT with knowledge distillation (LLM QAT + KD) — counterpart of
``aimet_tpu/algorithms/kd.py`` (reference workflow:
Examples/torch/quantization/llm_qat_kd/finetune_llm_qat_kd.py:207-382).

A frozen float teacher distills into a fake-quantized student trained
with range-learning QAT (``QuantizationSimModel.qat_fn``):

    L = (1 - alpha) * CE(student_logits, labels)
      + alpha * T^2 * KL(softmax(teacher / T) || softmax(student / T))

with next-token labels and a label mask for padding. The student's
weights take a ``torch.optim`` optimizer; the encodings' (min, max) take a
separate plain SGD step of ``enc_lr``, as the JAX package does.

The step is functional, as the JAX package's: it takes a
:class:`KDTrainState` and returns a new one, and writes into no tensor of
the state it was given (nor the teacher's). Each step therefore holds two
copies of the weights and the optimizer's state while it runs.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint


@dataclasses.dataclass(frozen=True)
class KDConfig:
    """Hyper-parameters for QAT + distillation: ``temperature`` / ``alpha``
    mix the CE and KL terms; ``enc_lr`` is the SGD rate of the learned
    encodings' (min, max); ``remat`` recomputes the student's forward in
    the backward (``torch.utils.checkpoint``) to save activation memory."""
    temperature: float = 2.0
    alpha: float = 0.5
    enc_lr: float = 1e-5
    ignore_index: int = -100
    remat: bool = False


def kd_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
            labels: torch.Tensor, cfg: KDConfig = KDConfig()) -> torch.Tensor:
    """CE + distillation loss for next-token training. Logits (B, T, V),
    labels (B, T) (already shifted: :func:`shift_labels`); positions whose
    label is ``cfg.ignore_index`` are left out of both terms. The teacher
    gets no gradient."""
    mask = labels != cfg.ignore_index
    safe_labels = torch.where(mask, labels, torch.zeros_like(labels))
    denom = torch.clamp(mask.sum(), min=1)

    # optax.softmax_cross_entropy_with_integer_labels
    ce = -torch.gather(F.log_softmax(student_logits, dim=-1), -1,
                       safe_labels.long()[..., None])[..., 0]
    ce = (ce * mask).sum() / denom

    t = cfg.temperature
    s_logp = F.log_softmax(student_logits / t, dim=-1)
    t_prob = F.softmax(teacher_logits.detach() / t, dim=-1)
    # KL(p_t || p_s) per position (the teacher's entropy term is constant
    # for the student but keeps the reported loss a divergence)
    kl = (t_prob * (torch.log(torch.clamp(t_prob, min=1e-20))
                    - s_logp)).sum(-1)
    kl = (kl * mask).sum() / denom
    return (1.0 - cfg.alpha) * ce + cfg.alpha * (t * t) * kl


def shift_labels(tokens: torch.Tensor, pad_id: Optional[int] = None,
                 ignore_index: int = -100) -> torch.Tensor:
    """Next-token labels: labels[t] = tokens[t + 1], the last position
    ignored (and ``pad_id`` positions, if given)."""
    labels = torch.cat([tokens[:, 1:],
                        torch.full_like(tokens[:, :1], ignore_index)], dim=1)
    if pad_id is not None:
        labels = torch.where(labels == pad_id,
                             torch.full_like(labels, ignore_index), labels)
    return labels


class KDTrainState(NamedTuple):
    params: Any          # student weights, name -> tensor
    enc: Any             # learned-grid encodings, name -> (min, max)
    opt_state: Any       # the optimizer's ``state_dict()``


def _leaf(t: torch.Tensor) -> torch.Tensor:
    """A new leaf that shares t's storage and records a gradient."""
    return t.detach().requires_grad_(True)


def make_qat_kd_step(sim, teacher_apply: Callable,
                     optimizer: Callable[..., torch.optim.Optimizer],
                     cfg: KDConfig = KDConfig()
                     ) -> Tuple[KDTrainState, Callable]:
    """A QAT + KD train step.

    ``sim`` is a calibrated ``QuantizationSimModel`` of the student;
    ``teacher_apply(teacher_params, tokens) -> logits`` the frozen float
    teacher; ``optimizer(params) -> torch.optim.Optimizer`` builds the
    student's optimizer over a list of tensors (for example
    ``functools.partial(torch.optim.AdamW, lr=1e-4)``).

    Returns ``(state0, step)``: ``step(state, teacher_params, tokens,
    labels) -> (state, loss)``. ``state0`` holds the sim's encodings; fill
    in the weights and the optimizer state with :func:`init_kd_state`.
    """
    qat_apply, enc0 = sim.qat_fn()
    state0 = KDTrainState(params=None, enc=enc0, opt_state=None)

    def student(params, enc, tokens):
        if cfg.remat:
            return checkpoint(qat_apply, params, enc, tokens,
                              use_reentrant=False)
        return qat_apply(params, enc, tokens)

    def step(state: KDTrainState, teacher_params, tokens, labels):
        names = list(state.params)
        params = {n: _leaf(state.params[n]) for n in names}
        enc = {n: (_leaf(mn), _leaf(mx)) for n, (mn, mx) in state.enc.items()}
        with torch.no_grad():
            t_logits = teacher_apply(teacher_params, tokens)
        with torch.enable_grad():
            loss = kd_loss(student(params, enc, tokens), t_logits, labels,
                           cfg)
            enc_leaves = [t for pair in enc.values() for t in pair]
            grads = torch.autograd.grad(
                loss, [params[n] for n in names] + enc_leaves,
                allow_unused=True)
        g_params, g_enc = grads[:len(names)], grads[len(names):]

        new_params = [state.params[n].detach().clone() for n in names]
        opt = optimizer(new_params)
        opt.load_state_dict(copy.deepcopy(state.opt_state))
        for p, g in zip(new_params, g_params):
            p.grad = g
        opt.step()
        for p in new_params:
            p.grad = None
        # range learning: SGD on (min, max), like the reference's separate
        # encoding-parameter group (v1/qc_quantize_op.py:947 LearnedGrid)
        it = iter(g_enc)
        new_enc = {}
        for n, (mn, mx) in state.enc.items():
            gmn, gmx = next(it), next(it)
            new_enc[n] = (mn.detach() if gmn is None
                          else mn.detach() - cfg.enc_lr * gmn,
                          mx.detach() if gmx is None
                          else mx.detach() - cfg.enc_lr * gmx)
        return (KDTrainState(dict(zip(names, new_params)), new_enc,
                             opt.state_dict()), loss.detach())

    return state0, step


def init_kd_state(state0: KDTrainState, student_params,
                  optimizer: Callable[..., torch.optim.Optimizer]
                  ) -> KDTrainState:
    """Fill in the student's weights (copies: the step never writes the
    caller's tensors) and a fresh optimizer state."""
    params = {n: p.detach().clone() for n, p in student_params.items()}
    opt = optimizer(list(params.values()))
    return KDTrainState(params=params, enc=state0.enc,
                        opt_state=opt.state_dict())
