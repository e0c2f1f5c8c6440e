"""Carry weights across from the JAX package, through numpy.

``params_from_flax`` maps a flax ``variables["params"]`` tree (numpy
arrays) onto the float ``Transformer``'s state dict; the module names are
the flax names, so this is a flatten. ``cnn_params_from_flax`` does the
same for the CNNs (``models/resnet.py``, ``models/mobilenet_v2.py``) from
``{params, batch_stats}``: conv kernels go from flax's HWIO to PyTorch's
OIHW, the running statistics become the BatchNorm's ``mean`` and
``var``. ``quantized_from_jax`` takes a JAX
quantized weight tree (numpy) to the port's tree: packed bytes and scales
pass through unchanged, since both packages share the storage contract.

Parameter names: the JAX package keys a parameter by its tree path
(``"['params']['layer_0']['attn']['wq']['kernel']"``), the port by its
qualified module name (``layer_0.attn.wq.kernel``); ``port_param_name`` and
``jax_param_key`` map one to the other (a list item ``['lstm'][0]`` is
``lstm.0``). ``deepspeech_params_from_jax`` carries the DeepSpeech2 and
recurrent-cell trees across. ``encodings_from_jax`` carries a
quantsim's encodings across (numpy fields, any object with the
``AffineEncoding`` attributes). ``adapters_from_jax`` carries LoRA
adapters (``algorithms/peft``) across.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from ._device import DeviceLike, resolve_device
from .quantization.affine import AffineEncoding


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes' bfloat16: reinterpret
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def params_from_flax(params_np, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Nested flax params (numpy leaves) -> flat state dict with ``.``-joined
    flax names, e.g. ``layer_0.attn.wq.kernel``."""
    out = {}
    for name, v in params_np.items():
        key = prefix + name
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(params_from_flax(v, key + "."))
        else:
            out[key] = _tensor(v)
    return out


def cnn_params_from_flax(variables_np) -> Dict[str, torch.Tensor]:
    """flax CNN ``{params, batch_stats}`` (numpy leaves) -> the port CNN's
    state dict: conv kernels (kh, kw, in/g, out) -> (out, in/g, kh, kw)."""
    out = {k: v.permute(3, 2, 0, 1).contiguous() if v.dim() == 4 else v
           for k, v in params_from_flax(variables_np["params"]).items()}
    out.update(params_from_flax(variables_np.get("batch_stats", {})))
    return out


def quantized_from_jax(qw_np, device: DeviceLike = None) -> Dict[str, Any]:
    """JAX quantized weight tree (numpy leaves) -> the port's tree on
    ``device`` (default ``cuda``); bytes unchanged."""
    dev = resolve_device(device)

    def conv(t):
        if isinstance(t, dict) or hasattr(t, "items"):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, list):
            return [conv(v) for v in t]
        if isinstance(t, tuple):
            return tuple(conv(v) for v in t)
        return _tensor(t).to(dev)

    return conv(qw_np)


_KEY_PART = re.compile(r"\['([^']*)'\]|\[(\d+)\]")
_ENC_FIELDS = ("min", "max", "delta", "offset")
_ENC_STATIC = ("bitwidth", "symmetric", "strict_symmetric",
               "unsigned_symmetric")


def port_param_name(jax_key: str) -> str:
    """``"['params']['layer_0']['attn']['wq']['kernel']"`` ->
    ``layer_0.attn.wq.kernel`` (and ``"['batch_stats']['BatchNorm_0']
    ['mean']"`` -> ``BatchNorm_0.mean``); any other name is returned
    unchanged."""
    found = _KEY_PART.findall(jax_key)
    if not found or "".join(f"['{k}']" if k else f"[{i}]"
                            for k, i in found) != jax_key:
        return jax_key
    parts = [k or i for k, i in found]
    if found[0][0] in ("params", "batch_stats"):
        parts = parts[1:]
    return ".".join(parts)


def jax_param_key(name: str, root: Optional[str] = "params") -> str:
    """``layer_0.attn.wq.kernel`` -> ``"['params']['layer_0']['attn']['wq']
    ['kernel']"`` (the flax ``variables`` tree path). ``root`` None: a plain
    parameter dict whose lists index by integer, as the recurrent models'
    (``lstm.0.fwd.kernel`` -> ``"['lstm'][0]['fwd']['kernel']"``)."""
    if root is None:
        return "".join(f"[{p}]" if p.isdigit() else f"['{p}']"
                       for p in name.split("."))
    return f"['{root}']" + "".join(f"['{p}']" for p in name.split("."))


def deepspeech_params_from_jax(params_np) -> Dict[str, torch.Tensor]:
    """The JAX package's DeepSpeech2 tree (numpy leaves: ``conv1``,
    ``conv2``, ``lstm`` a list of ``{fwd, bwd}``, ``head``) -> the state
    dict of ``models.deepspeech.DeepSpeech2``: conv kernels HWIO -> OIHW;
    ``lstm[i]["fwd"]["kernel"]`` -> ``lstm.i.fwd.kernel``. Any other tree
    of dicts and lists (a recurrent cell's) flattens the same way."""
    def walk(tree, prefix):
        items = tree.items() if hasattr(tree, "items") else enumerate(tree)
        for k, v in items:
            key = f"{prefix}{k}"
            if hasattr(v, "items") or isinstance(v, (list, tuple)):
                yield from walk(v, key + ".")
            else:
                yield key, _tensor(v)

    return {k: v.permute(3, 2, 0, 1).contiguous() if v.dim() == 4 else v
            for k, v in walk(params_np, "")}


def encodings_from_jax(encodings: Mapping[str, Any],
                       name_map: Optional[Mapping[str, str]] = None,
                       device: DeviceLike = None) -> Dict[str, AffineEncoding]:
    """JAX quantsim encodings (``sim.encodings``, or dicts of numpy fields)
    -> the port's, on ``device`` (default ``cuda``). Parameter keys become
    port names; other keys go through ``name_map`` (activation quantizers
    are named after ops, whose non-linear names differ between the
    packages) or stay as they are."""
    dev = resolve_device(device)
    name_map = name_map or {}
    out = {}
    for key, enc in encodings.items():
        get = enc.get if isinstance(enc, Mapping) else \
            (lambda f, e=enc: getattr(e, f))
        fields = {f: torch.from_numpy(np.array(get(f), np.float32)).to(dev)
                  for f in _ENC_FIELDS}
        static = {f: type(getattr(AffineEncoding, f))(get(f))
                  for f in _ENC_STATIC}
        name = name_map.get(key, port_param_name(key))
        out[name] = AffineEncoding(**fields, **static)
    return out


def adapters_from_jax(adapters_np: Mapping[str, Mapping[str, Any]],
                      transposed=(), device: DeviceLike = None
                      ) -> Dict[str, Dict[str, torch.Tensor]]:
    """JAX LoRA adapters (``{jax key of the kernel: {"A", "B"}}``, numpy
    leaves) -> the port's, keyed by port parameter name, on ``device``
    (default ``cuda``). A and B take the layout of the kernel they adapt:
    for a kernel named in ``transposed`` (held (out, in) in the port, (in,
    out) in the JAX package) A becomes B^T and B becomes A^T, so that
    ``A @ B`` is the transposed update."""
    dev = resolve_device(device)
    out = {}
    for key, ab in adapters_np.items():
        name = port_param_name(key)
        a, b = _tensor(ab["A"]).to(dev), _tensor(ab["B"]).to(dev)
        if name in transposed:
            a, b = b.t().contiguous(), a.t().contiguous()
        out[name] = {"A": a, "B": b}
    return out
