"""PEFT / LoRA quantization utilities — counterpart of
``aimet_tpu/algorithms/peft.py`` (reference: aimet_torch/peft.py:61-400,
LoraLayer + PeftQuantUtils): quantize and freeze a base model while
keeping low-rank adapters trainable and swappable.

Adapters are a dict ``{kernel name: {"A": (in, r), "B": (r, out)}}`` keyed
by the port's parameter names; A and B take the layout of the kernel they
adapt, so ``A @ B`` has the kernel's shape. Two forwards:

  - :func:`lora_apply_fn` merges ``W + (alpha / r) * A @ B`` into the
    params dict and runs the base forward on it (the deployment form, and
    the one integer serving quantizes);
  - :func:`lora_unmerged_fn` runs the base graph with every adapted layer
    computing ``base_op(x) + (alpha / r) * (x @ A) @ B`` as separate
    matmuls (LoraLayer.forward, peft.py:101-117). :class:`LoraModel`
    wraps it as an ``nn.Module`` whose parameters are ``base.<name>`` and
    ``adapters.<kernel name>.A`` / ``.B``, so a ``QuantizationSimModel``
    traced over it sees the adapter matmuls as ops of their own, with
    their own quantizers.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

import torch
from torch import nn

from ..graph.connected_graph import ConnectedGraph
from ..graph.interpreter import OpReplay, evaluate_with_replacements
from .adaround import _layer_apply

Adapters = Dict[str, Dict[str, torch.Tensor]]


@dataclasses.dataclass
class LoraConfig:
    rank: int = 8
    alpha: float = 16.0
    target_patterns: Tuple[str, ...] = ("kernel",)


def init_lora_params(generator: torch.Generator, params, config: LoraConfig
                     ) -> Adapters:
    """One (A, B) pair per 2-D parameter whose name matches one of
    ``target_patterns``: A drawn N(0, 0.01^2) from ``generator`` (on the
    parameter's device), B zeros."""
    adapters = {}
    for name, leaf in params.items():
        if leaf.dim() != 2:
            continue
        if not any(p in name for p in config.target_patterns):
            continue
        k_in, k_out = leaf.shape
        a = torch.randn((k_in, config.rank), generator=generator,
                        device=leaf.device, dtype=torch.float32)
        adapters[name] = {
            "A": (a * 0.01).to(leaf.dtype),
            "B": torch.zeros((config.rank, k_out), dtype=leaf.dtype,
                             device=leaf.device),
        }
    return adapters


def merge_lora(params, adapters: Adapters, config: LoraConfig):
    """``params`` with ``W + (alpha / r) * A @ B`` at each adapted name (a
    new dict; the caller's tensors are not written)."""
    scaling = config.alpha / config.rank
    out = dict(params)
    for name, ad in adapters.items():
        out[name] = params[name] + scaling * (ad["A"] @ ad["B"])
    return out


def lora_apply_fn(base_fn: Callable, params, adapters: Adapters,
                  config: LoraConfig) -> Callable:
    """Build ``fn(adapters, *inputs)`` that runs ``base_fn(params,
    *inputs)`` with LoRA-merged weights. The merge happens in the params
    dict, so the base forward (and any quantsim built over it) is reused
    unchanged; base weights can be quantized / frozen while only
    ``adapters`` is trained. (``adapters`` is taken for the JAX
    package's signature; the returned function merges the adapters it is
    called with.)"""

    def fn(adapters, *inputs):
        return base_fn(merge_lora(params, adapters, config), *inputs)

    return fn


def lora_targets(graph: ConnectedGraph, config: LoraConfig):
    """(op, kernel name, bias product or None) of each linear / conv whose
    2-D kernel matches ``target_patterns``."""
    targets = []
    for op in graph.ops:
        if op.type not in ("linear", "conv", "depthwise_conv"):
            continue
        k = op.param_products.get("kernel")
        if k is not None and len(k.shape) == 2 \
                and any(p in k.param_path for p in config.target_patterns):
            targets.append((op, k.param_path, op.param_products.get("bias")))
    return targets


def lora_unmerged_fn(model: nn.Module, example_inputs, params,
                     config: LoraConfig) -> Callable:
    """QLoRA-deployment form: ``fn(combined, *inputs)`` with ``combined =
    {"base": params, "adapters": adapters}``, where every adapted layer
    computes ``base_op(x) + (alpha / r) * (x @ A) @ B`` as separate
    matmuls, the adapter path first (as the JAX package orders them). The
    base op is replayed from its data operand (``OpReplay``), so its
    views, bias and dtype casts are the model's own."""
    graph = ConnectedGraph(model, tuple(example_inputs), params)
    scaling = config.alpha / config.rank
    targets = [(op, kpath, bias_prod,
                OpReplay(graph, op, source=op.attrs["x_node"]),
                bool(op.attrs.get("kernel_transposed")))
               for op, kpath, bias_prod in lora_targets(graph, config)]

    def fn(combined, *inputs):
        base, adapters = combined["base"], combined["adapters"]
        reps = {}
        for op, kpath, bias_prod, replay, transposed in targets:
            if kpath not in adapters:
                continue
            ad = adapters[kpath]
            w = base[kpath]
            bias = base[bias_prod.param_path] if bias_prod is not None \
                else None

            def rep(x, replay=replay, w=w, bias=bias, ad=ad,
                    transposed=transposed):
                # jnp's promotion: a bf16 x against f32 adapters runs the
                # adapter path, and the sum, in f32; the sum then takes the
                # op's own dtype, which the traced ops after it expect. A
                # kernel held (out, in) takes x @ (A @ B)^T
                a, b = ((ad["B"].t(), ad["A"].t()) if transposed
                        else (ad["A"], ad["B"]))
                dt = torch.promote_types(x.dtype, a.dtype)
                delta = ((x.to(dt) @ a.to(dt)) @ b.to(dt)) * scaling
                out = _layer_apply(replay, x, w, bias, base)
                return (out + delta).to(out.dtype)

            reps[op.name] = rep
        return evaluate_with_replacements(graph, base, inputs, reps)

    return fn


BASE_PREFIX = "base."
ADAPTER_PREFIX = "adapters."


def _module_at(root: nn.Module, dotted: str) -> nn.Module:
    mod = root
    for part in dotted.split("."):
        if not hasattr(mod, part):
            mod.add_module(part, nn.Module())
        mod = getattr(mod, part)
    return mod


def _get(root: nn.Module, dotted: str):
    obj = root
    for part in dotted.split("."):
        obj = getattr(obj, part)
    return obj


class LoraModel(nn.Module):
    """The unmerged LoRA forward as a module: parameters ``base.<name>``
    (the base model's, by its names) and ``adapters.<kernel name>.A`` /
    ``.B``; ``forward(*inputs)`` runs :func:`lora_unmerged_fn`. The base
    model itself is only traced, not registered."""

    def __init__(self, model: nn.Module, example_inputs, params,
                 adapters: Adapters, config: LoraConfig):
        super().__init__()
        self._fn = lora_unmerged_fn(model, example_inputs, params, config)
        self._base_names = list(params)
        self._adapter_names = list(adapters)
        self.base = nn.Module()
        self.adapters = nn.Module()
        for name, t in params.items():
            mod_path, _, leaf = name.rpartition(".")
            holder = _module_at(self.base, mod_path) if mod_path else \
                self.base
            holder.register_parameter(
                leaf, nn.Parameter(t.detach(), requires_grad=False))
        for name, ab in adapters.items():
            holder = _module_at(self.adapters, name)
            for role in ("A", "B"):
                holder.register_parameter(
                    role, nn.Parameter(ab[role].detach(),
                                       requires_grad=False))

    def forward(self, *inputs):
        base = {n: _get(self.base, n) for n in self._base_names}
        adapters = {n: {r: _get(self.adapters, f"{n}.{r}")
                        for r in ("A", "B")} for n in self._adapter_names}
        return self._fn({"base": base, "adapters": adapters}, *inputs)


def combined_params(params, adapters: Adapters) -> Dict[str, torch.Tensor]:
    """The flat params dict of a :class:`LoraModel` (what its sim's
    forwards take) from the base params and the adapters."""
    out = {BASE_PREFIX + k: v for k, v in params.items()}
    for name, ab in adapters.items():
        for role in ("A", "B"):
            out[f"{ADAPTER_PREFIX}{name}.{role}"] = ab[role]
    return out


class PeftQuantUtils:
    """Quantsim-side helpers (peft.py:183 PeftQuantUtils). The JAX
    package marks adapter quantizers by the key string ``"['adapters']"``
    in their names; the port's adapter parameters carry the prefix
    ``adapters.``."""

    ADAPTER_KEY = ADAPTER_PREFIX

    @staticmethod
    def build_adapter_sim(model: nn.Module, example_inputs, params,
                          adapters: Adapters, lora_config: LoraConfig,
                          **sim_kwargs):
        """Sim over the UNMERGED LoRA forward (:class:`LoraModel`): base
        layers and adapter matmuls each own quantizers
        (get_quantized_lora_layer, peft.py:348). ``sim_kwargs`` go to the
        sim (its ``config`` among them, hence ``lora_config`` here).
        Returns (sim, the flat params dict its forwards take)."""
        from ..quantsim.qsim import QuantizationSimModel

        lora = LoraModel(model, example_inputs, params, adapters,
                         lora_config)
        combined = combined_params(params, adapters)
        return QuantizationSimModel(lora, tuple(example_inputs),
                                    **sim_kwargs), combined

    @classmethod
    def _is_adapter_quantizer(cls, sim, name, spec) -> bool:
        if spec.kind == "param":
            return name.startswith(cls.ADAPTER_KEY)
        # activation quantizer: op whose params live under adapters
        try:
            op = sim.graph.get_op(name[:-6] if name.endswith("_input")
                                  else name)
        except (KeyError, ValueError):
            return False
        return any(p.param_path and p.param_path.startswith(cls.ADAPTER_KEY)
                   for p in op.param_products.values())

    @classmethod
    def set_bitwidth_for_lora_adapters(cls, sim, output_bw: int,
                                       param_bw: int):
        """Adapter quantizers to (output_bw, param_bw) (peft.py:325-346)."""
        for name, spec in list(sim.quantizers.items()):
            if not cls._is_adapter_quantizer(sim, name, spec):
                continue
            sim.set_bitwidth(name, param_bw if spec.kind == "param"
                             else output_bw)

    @classmethod
    def disable_adapter_activation_quantizers(cls, sim) -> List[str]:
        """Turn off the activation quantizers of the adapter path and
        return their names. Adapters start with ``B = 0``, so ranges
        calibrated then are empty and would clip the path once it trains:
        call this after ``compute_encodings`` where the adapters train from
        their initial values. The JAX package has no such helper; there it
        is ``sim.set_quantizer_enabled(name, False)`` for each activation
        quantizer that ``_is_adapter_quantizer`` selects."""
        names = [n for n, s in sim.quantizers.items()
                 if s.kind != "param" and cls._is_adapter_quantizer(sim, n, s)]
        for n in names:
            sim.set_quantizer_enabled(n, False)
        return names

    @classmethod
    def freeze_base_model_param_quantizers(cls, sim):
        """(peft.py:288)"""
        for name, spec in sim.quantizers.items():
            if spec.kind == "param" and not name.startswith(cls.ADAPTER_KEY) \
                    and name in sim.encodings:
                sim.set_encoding(name, sim.encodings[name], freeze=True)

    @classmethod
    def freeze_base_model_activation_quantizers(cls, sim):
        """(peft.py:301)"""
        for name, spec in sim.quantizers.items():
            if spec.kind != "param" and name in sim.encodings \
                    and not cls._is_adapter_quantizer(sim, name, spec):
                sim.set_encoding(name, sim.encodings[name], freeze=True)

    @classmethod
    def freeze_base_model(cls, sim):
        """(peft.py:316)"""
        cls.freeze_base_model_param_quantizers(sim)
        cls.freeze_base_model_activation_quantizers(sim)

    # kept for back-compat with the merged flow
    freeze_base_model_encodings = freeze_base_model_param_quantizers

    @staticmethod
    def quantized_lora_fn(sim, params, adapters: Adapters,
                          config: LoraConfig):
        """Quantized forward with merged LoRA weights, ``fn(adapters,
        *inputs)`` on a sim of the base model: the merged kernel is
        fake-quantized with the (frozen) base encoding, as on a target
        where the adapters fold into the quantized base weight."""
        return lora_apply_fn(lambda p, *a: sim.quantized_fn(p, *a),
                             params, adapters, config)

    @staticmethod
    def export_adapter_weights(adapters: Adapters, path: str,
                               prefix: str) -> str:
        """Adapter-only safetensors artifact (peft.py:388):
        ``{path}/{prefix}_adapters.safetensors``, keys ``<kernel>.A`` /
        ``.B``."""
        from safetensors.torch import save_file

        tensors = {f"{kname}.{role}": t.detach().cpu().contiguous()
                   for kname, ab in adapters.items()
                   for role, t in ab.items()}
        out = f"{path}/{prefix}_adapters.safetensors"
        save_file(tensors, out)
        return out

    @staticmethod
    def enable_adapter_and_load_weights(weights_path: str,
                                        device=None) -> Adapters:
        """Load a swapped-in adapter set (peft.py:414) onto ``device``
        (default ``cuda``)."""
        from safetensors.torch import load_file

        from .._device import resolve_device

        dev = resolve_device(device)
        adapters: Adapters = {}
        for key, t in load_file(weights_path).items():
            kname, role = key.rsplit(".", 1)
            adapters.setdefault(kname, {})[role] = t.to(dev)
        return adapters

    @staticmethod
    def disable_lora_adapters(adapters: Adapters) -> Adapters:
        """Zeroed adapters == exact base model (peft.py:439)."""
        return {k: {r: torch.zeros_like(t) for r, t in ab.items()}
                for k, ab in adapters.items()}

    @classmethod
    def export_adapter_encodings(cls, sim) -> Dict:
        """Encodings subset covering only the adapter quantizers — the
        per-adapter artifact exported alongside adapter weights
        (track_lora_meta_data + export flow, peft.py:143-181)."""
        full = sim.export_encodings()
        keep_act = {}
        keep_par = {}
        for name, spec in sim.quantizers.items():
            if not cls._is_adapter_quantizer(sim, name, spec):
                continue
            src = (full["param_encodings"] if spec.kind == "param"
                   else full["activation_encodings"])
            dst = keep_par if spec.kind == "param" else keep_act
            if name in src:
                dst[name] = src[name]
        return {"version": full["version"],
                "activation_encodings": keep_act,
                "param_encodings": keep_par}

    @staticmethod
    def swap_adapters(fn_builder, new_adapters):
        """Adapters are just a dict — swapping is passing a different
        one."""
        return new_adapters
