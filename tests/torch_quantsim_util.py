"""Shared models for the quantsim and lowering parity tests of the port:
the same weights and inputs, made with numpy from a seed, in the JAX
package and in aimet_tpu_torch."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from aimet_tpu.models.transformer import Transformer as JaxTransformer
from aimet_tpu.models.transformer import TransformerConfig as JaxConfig
from aimet_tpu_torch import convert
from aimet_tpu_torch.models.transformer import Transformer, TransformerConfig

TINY_B, TINY_T = 2, 24


def jax_mlp(params, x):
    """tests/test_lowering.py's MLP."""
    h = jax.nn.relu(x @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]


class TorchMLP(torch.nn.Module):
    def __init__(self, params):
        super().__init__()
        for k, v in params.items():
            self.register_parameter(
                k, torch.nn.Parameter(torch.from_numpy(np.array(v))))

    def forward(self, x):
        return torch.relu(x @ self.w1 + self.b1) @ self.w2 + self.b2


def mlp_pair(seed=0):
    """(jax params, torch module, x, calibration batches) as numpy-made
    float32 arrays (the shapes of tests/test_lowering.py)."""
    rng = np.random.RandomState(seed)
    params = {"w1": rng.randn(16, 32).astype(np.float32) * 0.3,
              "b1": rng.randn(32).astype(np.float32) * 0.1,
              "w2": rng.randn(32, 10).astype(np.float32) * 0.3,
              "b2": rng.randn(10).astype(np.float32) * 0.1}
    x = rng.randn(8, 16).astype(np.float32)
    batches = [rng.randn(8, 16).astype(np.float32) for _ in range(2)]
    return ({k: jnp.asarray(v) for k, v in params.items()},
            TorchMLP(params), x, batches)


@functools.lru_cache(maxsize=None)
def tiny_pair(seed=0):
    """(jax apply fn, flax variables, torch Transformer, tokens, batches):
    TransformerConfig.tiny() with the flax weights carried across (made
    once per seed and shared; the tests do not change the weights)."""
    rng = np.random.RandomState(seed)
    jm = JaxTransformer(JaxConfig.tiny())
    tok = rng.randint(0, 256, (TINY_B, TINY_T)).astype(np.int32)
    variables = jm.init(jax.random.PRNGKey(seed), jnp.asarray(tok))
    tm = Transformer(TransformerConfig.tiny())
    tm.load_state_dict(convert.params_from_flax(
        jax.tree_util.tree_map(np.asarray, variables)["params"]))
    batches = [rng.randint(0, 256, (TINY_B, TINY_T)).astype(np.int32)
               for _ in range(2)]
    return (lambda p, t: jm.apply(p, t)), variables, tm, tok, batches


def to_torch(a):
    a = torch.from_numpy(np.array(a))
    return a.long() if a.dtype == torch.int32 else a


def linear_input_names(jsim, tsim):
    """{JAX producer name: port producer name} of each linear's input (the
    activation quantizers the w8a8 lowering reads)."""
    pairs = zip(jsim.graph.ops_of_type("linear"),
                tsim.graph.ops_of_type("linear"))
    return {a.inputs[0].producer.name: b.inputs[0].producer.name
            for a, b in pairs if a.inputs[0].producer is not None}


def carry_encodings(jsim, tsim):
    """Give the port sim the JAX sim's parameter encodings and linear-input
    activation encodings."""
    name_map = linear_input_names(jsim, tsim)
    keep = {k: v for k, v in jsim.encodings.items()
            if k in name_map or (k.startswith("[")
                                 and convert.port_param_name(k)
                                 in tsim.quantizers)}
    for k, v in convert.encodings_from_jax(keep, name_map,
                                           device="cpu").items():
        tsim.set_encoding(k, v)


def masked_and_silu_quantizers(sim):
    """Quantizer names of the masked attention scores (``select_n`` on the
    softmax input) and of silu (its ``sigmoid`` and the product
    x * sigmoid(x)). The JAX package traces jnp.where and jax.nn.silu as
    shared sub-jaxprs, so every layer shares one quantizer of each; the
    port has one a layer."""
    names = []
    for op in sim.graph.ops:
        if op.type == "select_n" and any(c.type == "softmax"
                                         for c in op.output.consumers):
            names.append(op.name)
        if op.type == "sigmoid":
            names.append(op.name)
            names += [c.name for c in op.output.consumers if c.type == "mul"]
    return [n for n in names if n in sim.quantizers]


@functools.lru_cache(maxsize=None)
def tiny_numpy_pair(seed=0):
    """``tiny_pair``'s models with weights drawn with numpy on the shapes
    of ``jax.eval_shape`` (nothing compiled): kernels and embeddings
    N(0, 1 / fan_in), N(0, 1), norm scales one. Returns (jax apply fn,
    flax variables, torch Transformer, tokens, batches)."""
    rng = np.random.RandomState(seed)
    jm = JaxTransformer(JaxConfig.tiny())
    tok = rng.randint(0, 256, (TINY_B, TINY_T)).astype(np.int32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(tok))

    def leaf(path, s):
        k = path[-1].key
        if k == "scale":
            return np.ones(s.shape, np.float32)
        std = 1.0 if k == "embedding" else s.shape[0] ** -0.5
        return (rng.randn(*s.shape) * std).astype(np.float32)
    variables = jax.tree_util.tree_map_with_path(leaf, shapes)
    tm = Transformer(TransformerConfig.tiny())
    tm.load_state_dict(convert.params_from_flax(variables["params"]))
    batches = [rng.randint(0, 256, (TINY_B, TINY_T)).astype(np.int32)
               for _ in range(2)]
    jv = jax.tree_util.tree_map(jnp.asarray, variables)
    return (lambda p, t: jm.apply(p, t)), jv, tm, tok, batches
