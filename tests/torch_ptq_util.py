"""Shared models and carriers for the PTQ parity tests of the port: the
small models of tests/test_ptq.py and tests/test_adaround_seqmse.py in
both packages (flax NHWC, the port NCHW with the flax module names), their
weights made with numpy from a seed and carried across, and the way back:
port params -> a flax ``variables`` tree (OIHW -> HWIO, ``mean`` / ``var``
into ``batch_stats``)."""
import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aimet_tpu.models.cnn import ConvBnRelu as JaxConvBnRelu
from aimet_tpu.models.cnn import TinyCNN as JaxTinyCNN
from aimet_tpu.models.cnn import TinyMLP as JaxTinyMLP
from aimet_tpu.models.mobilenet_v2 import MobileNetV2 as JaxMobileNetV2
from aimet_tpu.models.resnet import BasicBlock as JaxBasicBlock
from aimet_tpu.models.resnet import ResNet as JaxResNet
from aimet_tpu_torch import convert
from aimet_tpu_torch.models.cnn import ConvBnRelu, TinyCNN, TinyMLP
from aimet_tpu_torch.models.layers import BatchNorm, Conv
from aimet_tpu_torch.models.mobilenet_v2 import MobileNetV2
from aimet_tpu_torch.models.resnet import BasicBlock, ResNet


class JaxConvBnConv(nn.Module):
    """tests/test_ptq.py's ConvBnConv."""
    @nn.compact
    def __call__(self, x):
        x = nn.Conv(8, (3, 3), padding="SAME")(x)
        x = nn.BatchNorm(use_running_average=True)(x)
        x = nn.relu(x)
        return nn.Conv(4, (3, 3), padding="SAME")(x)


class JaxDwSeparable(nn.Module):
    """tests/test_ptq.py's DwSeparable."""
    @nn.compact
    def __call__(self, x):
        x = nn.relu(nn.Conv(8, (3, 3), padding="SAME")(x))
        x = nn.Conv(8, (3, 3), padding="SAME", feature_group_count=8)(x)
        return nn.Conv(4, (1, 1))(nn.relu(x))


class ConvBnConv(torch.nn.Module):
    def __init__(self, in_ch=3):
        super().__init__()
        self.Conv_0 = Conv(in_ch, 8, (3, 3), use_bias=True)
        self.BatchNorm_0 = BatchNorm(8)
        self.Conv_1 = Conv(8, 4, (3, 3), use_bias=True)

    def forward(self, x):
        return self.Conv_1(torch.relu(self.BatchNorm_0(self.Conv_0(x))))


class DwSeparable(torch.nn.Module):
    def __init__(self, in_ch=3):
        super().__init__()
        self.Conv_0 = Conv(in_ch, 8, (3, 3), use_bias=True)
        self.Conv_1 = Conv(8, 8, (3, 3), groups=8, use_bias=True)
        self.Conv_2 = Conv(8, 4, (1, 1), use_bias=True)

    def forward(self, x):
        x = torch.relu(self.Conv_1(torch.relu(self.Conv_0(x))))
        return self.Conv_2(x)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while a PTQ parity file runs (import it into the
    test module): the tensors are small, and the test workers share the
    host's cores (many threads a worker made these files several times
    slower under the parallel run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MODELS = {
    "conv_bn_conv": (JaxConvBnConv, ConvBnConv, (2, 8, 8, 3)),
    "dw_separable": (JaxDwSeparable, DwSeparable, (2, 8, 8, 3)),
    "conv_bn_relu": (JaxConvBnRelu, ConvBnRelu, (2, 8, 8, 3)),
    "conv_bn_relu_nobias": (lambda: JaxConvBnRelu(use_bias=False),
                            lambda: ConvBnRelu(use_bias=False), (2, 8, 8, 3)),
    "tiny_cnn": (JaxTinyCNN, TinyCNN, (2, 8, 8, 1)),
    "tiny_mlp": (lambda: JaxTinyMLP(features=16),
                 lambda: TinyMLP(features=16), (8, 16)),
    "mobilenet_v2": (lambda: JaxMobileNetV2(num_classes=10, width_mult=0.25),
                     lambda: MobileNetV2(num_classes=10, width_mult=0.25),
                     (2, 32, 32, 3)),
    "resnet_basic": (lambda: JaxResNet([1, 1], JaxBasicBlock, num_classes=10,
                                       num_filters=8),
                     lambda: ResNet([1, 1], BasicBlock, num_classes=10,
                                    num_filters=8), (2, 16, 16, 3)),
}


def randomize(variables, rs, kernel_scale=None):
    """Non-trivial BatchNorm statistics (test_ptq.randomize_bn's
    distributions), drawn with numpy; ``kernel_scale``: multiply the first
    conv kernel's output channels by logspace(-2, 2) (unequal ranges)."""
    def walk(tree, path):
        out = {}
        for k, v in tree.items():
            p = path + (k,)
            if isinstance(v, dict) or hasattr(v, "items"):
                out[k] = walk(v, p)
                continue
            v = np.asarray(v)
            if any("BatchNorm" in s for s in p):
                if k == "mean":
                    v = rs.randn(*v.shape).astype(np.float32)
                elif k == "var":
                    v = (np.abs(rs.randn(*v.shape)) * 2.0 + 0.1).astype(
                        np.float32)
                elif k == "scale":
                    v = (rs.rand(*v.shape) * 2 + 0.5).astype(np.float32)
                elif k == "bias":
                    v = rs.randn(*v.shape).astype(np.float32)
            out[k] = v
        return out

    v = walk(variables, ())
    if kernel_scale is not None:
        k0 = v["params"]["Conv_0"]["kernel"]
        v["params"]["Conv_0"]["kernel"] = (k0 * np.logspace(
            *kernel_scale, k0.shape[-1]).astype(np.float32)).astype(
            np.float32)
    return v


def init_variables(jm, x, rs):
    """A flax ``variables`` tree for ``jm`` on ``x`` with numpy leaves drawn
    from ``rs`` as flax's initializers draw them: kernels N(0, 1 / fan_in)
    (LeCun normal, untruncated), biases and means zero, scales and
    variances one. Only the shapes come from flax (``jax.eval_shape``:
    nothing is compiled)."""
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))

    def leaf(path, s):
        k = path[-1].key
        if k == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rs.randn(*s.shape) / np.sqrt(fan_in)).astype(np.float32)
        return (np.ones if k in ("scale", "var") else np.zeros)(
            s.shape, np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def pair(name, seed=0, kernel_scale=None):
    """(jax apply fn, flax variables (numpy leaves), port model, example
    input NHWC (numpy), rs) for MODELS[name], the weights drawn with numpy
    and carried across."""
    jm_cls, make, shape = MODELS[name]
    rs = np.random.RandomState(seed)
    jm = jm_cls()
    x = rs.randn(*shape).astype(np.float32)
    v = randomize(init_variables(jm, x, rs), rs, kernel_scale)
    tm = make()
    tm.load_state_dict(convert.cnn_params_from_flax(v))
    return (lambda p, t: jm.apply(p, t)), v, tm, x, rs


def nchw(x):
    x = np.asarray(x)
    if x.ndim == 4:
        x = x.transpose(0, 3, 1, 2)
    return torch.from_numpy(np.ascontiguousarray(x))


def nhwc(t):
    a = t.detach().cpu().numpy()
    return a.transpose(0, 2, 3, 1) if a.ndim == 4 else a


def to_flax(params, template):
    """Port params (by module name) -> a flax ``variables`` tree shaped as
    ``template``: conv kernels OIHW -> HWIO, running statistics into
    ``batch_stats``."""
    def walk(tree, path):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict) or hasattr(v, "items"):
                out[k] = walk(v, path + (k,))
                continue
            t = params[".".join(path[1:] + (k,))].detach().cpu()
            if t.dim() == 4:
                t = t.permute(2, 3, 1, 0)
            out[k] = jnp.asarray(t.contiguous().numpy())
        return out
    return walk(template, ())


def from_flax(variables):
    """A flax ``variables`` tree -> the port's params dict (CPU)."""
    return convert.cnn_params_from_flax(
        jax.tree_util.tree_map(np.asarray, variables))


def assert_tree_close(a, b, rtol, atol):
    la = jax.tree_util.tree_leaves_with_path(a)
    lb = dict((jax.tree_util.keystr(p), v)
              for p, v in jax.tree_util.tree_leaves_with_path(b))
    assert len(la) == len(lb)
    for p, v in la:
        np.testing.assert_allclose(np.asarray(v), np.asarray(
            lb[jax.tree_util.keystr(p)]), rtol=rtol, atol=atol,
            err_msg=jax.tree_util.keystr(p))
