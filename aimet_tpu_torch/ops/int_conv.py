"""Integer convolutions — counterpart of ``aimet_tpu/ops/int_conv.py``.

Layouts: PyTorch's, not the JAX package's. Activations are NCHW (JAX:
NHWC), conv weights OIHW, i.e. (co, ci/g, kh, kw) (JAX: HWIO), and the
INT4 conv codes are packed along co on axis 0 (JAX: the last axis). After
that transpose the codes, the packed bytes, the int32 sums and the outputs
equal the JAX package's; the im2col weight matrices (ci*kh*kw, co) are the
same matrices in both, rows ordered (ci, kh, kw).

Two strategies, as in the JAX package:

1. **im2col + the integer matmuls** (the ops API): patches in (ci, kh, kw)
   order (``F.unfold``'s order on NCHW), then ``matmul_w8`` (KW8),
   ``matmul_w8a8`` (K1 + KQ8) or ``matmul_w4`` (KW4).
2. **Direct integer conv** (what ``quantsim.lowering`` runs):
   ``conv_int_core`` computes the exact int32 sums of an int8 x int8 conv
   with ``fill``-valued padding and transposed-conv zero insertion (the
   activation zero point, so the static-INT8 zero-point correction stays
   position independent). The JAX package leaves it to XLA's implicit
   GEMM; PyTorch has no int8 conv on CUDA, so here an ungrouped conv runs
   as a fill-padded int8 im2col (rows padded to 16 bytes) and KQ8's int32
   entry (``int8_matmul_int32``) on the OIHW weight as it lies, K-major
   (its TMA + wgmma route), and a grouped or depthwise one as an f64
   ``F.conv2d`` on the integer-valued tensors with cuDNN off, rounded
   back (exact: every partial sum is an integer below 2^53 in magnitude,
   checked, which f64 carries). ``conv2d_int8_static`` and ``conv2d_w8a8_dynamic`` wrap it
   with their quantizers and epilogues, in the JAX package's order.
   ``conv2d_weight_only`` dequantizes INT-resident weights inline and runs
   a float ``F.conv2d``, as the JAX package runs XLA's float conv, with
   TF32 off.

On CPU tensors everything runs the kernels' plain versions.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
from torch.nn import functional as F

from .._device import no_tf32
from .int_matmul import (int8_matmul_int32, matmul_w4, matmul_w8,
                         matmul_w8a8, quantize_weight_int4,
                         quantize_weight_per_channel)

Padding = Union[str, Sequence[Tuple[int, int]]]
Pairs = Tuple[Tuple[int, int], Tuple[int, int]]


def _weight_2d(w: torch.Tensor) -> torch.Tensor:
    """(co, ci, kh, kw) -> (ci*kh*kw, co), rows ordered (ci, kh, kw)."""
    return w.reshape(w.shape[0], -1).t()


def quantize_conv_weight_per_channel(w: torch.Tensor):
    """w (co, ci, kh, kw) -> (codes (ci*kh*kw, co) int8, scale (co,))."""
    return quantize_weight_per_channel(_weight_2d(w))


def quantize_conv_weight_int4(w: torch.Tensor):
    """As :func:`quantize_conv_weight_per_channel`, packed split-half INT4
    ((ci*kh*kw)//2, co); ci*kh*kw must be even."""
    return quantize_weight_int4(_weight_2d(w))


def conv_pads(size: Tuple[int, int], k: Tuple[int, int],
              strides: Tuple[int, int], padding: Padding,
              dilation: Tuple[int, int]) -> Pairs:
    """Explicit ((top, bottom), (left, right)) padding, lax's rules."""
    if isinstance(padding, str):
        if padding == "VALID":
            return (0, 0), (0, 0)
        if padding != "SAME":
            raise ValueError(f"unknown padding {padding!r}")
        out = []
        for n, kk, s, d in zip(size, k, strides, dilation):
            total = max(0, (-(-n // s) - 1) * s + (kk - 1) * d + 1 - n)
            out.append((total // 2, total - total // 2))
        return tuple(out)
    return tuple(tuple(int(v) for v in p) for p in padding)


def _patches(x: torch.Tensor, filter_shape, strides, padding: Padding,
             rhs_dilation=None, fill=0):
    """(B, C, H, W) -> ((B*Ho*Wo, C*kh*kw) patch rows, (B, Ho, Wo)):
    features ordered (C, kh, kw) (``lax.conv_general_dilated_patches``'
    order), padded with ``fill``. A strided view and one copy: any dtype,
    any device."""
    kh, kw = filter_shape
    dh, dw = rhs_dilation or (1, 1)
    sh, sw = strides
    (h0, h1), (w0, w1) = conv_pads(tuple(x.shape[2:]), (kh, kw), (sh, sw),
                                   padding, (dh, dw))
    if (h0, h1, w0, w1) != (0, 0, 0, 0):
        x = F.pad(x, (w0, w1, h0, h1), value=fill)
    B, C = x.shape[:2]
    v = x.unfold(2, (kh - 1) * dh + 1, sh).unfold(3, (kw - 1) * dw + 1, sw)
    v = v[..., ::dh, ::dw]                       # (B, C, Ho, Wo, kh, kw)
    Ho, Wo = v.shape[2:4]
    return v.permute(0, 2, 3, 1, 4, 5).reshape(B * Ho * Wo, C * kh * kw), \
        (B, Ho, Wo)


def _int_patches(xq: torch.Tensor, filter_shape, strides, rhs_dilation):
    """``_patches`` of an int8 NCHW tensor (VALID), written into rows of
    a multiple of 16 bytes: ((M, K) view of the (M, ceil16(K)) buffer,
    (B, Ho, Wo)). The TMA loads of KQ8's K-major route need 16-byte
    aligned row strides, and ResNet-50's stem has K = 3 * 7 * 7 = 147; the
    pad columns are never read (the route's K is the view's)."""
    kh, kw = filter_shape
    dh, dw = rhs_dilation or (1, 1)
    sh, sw = strides
    B, C = xq.shape[:2]
    v = xq.unfold(2, (kh - 1) * dh + 1, sh).unfold(3, (kw - 1) * dw + 1, sw)
    v = v[..., ::dh, ::dw]                       # (B, C, Ho, Wo, kh, kw)
    Ho, Wo = v.shape[2:4]
    K = C * kh * kw
    buf = torch.empty((B * Ho * Wo, -(-K // 16) * 16), dtype=xq.dtype,
                      device=xq.device)
    p = buf[:, :K]
    p.view(B, Ho, Wo, C, kh, kw).copy_(v.permute(0, 2, 3, 1, 4, 5))
    return p, (B, Ho, Wo)


def _weight_kmajor(wq: torch.Tensor) -> torch.Tensor:
    """(co, ci, kh, kw) int8 -> the (ci*kh*kw, co) weight matrix as a
    transposed view of the K-major (co, ci*kh*kw) reshape: no copy, unless
    K is not a multiple of 16; then the rows are padded with zeros to one
    (TMA's 16-byte aligned strides) and the view keeps K columns."""
    co = wq.shape[0]
    w2 = wq.reshape(co, -1)
    K = w2.shape[1]
    if K % 16:
        pad = torch.zeros((co, -(-K // 16) * 16), dtype=wq.dtype,
                          device=wq.device)
        pad[:, :K] = w2
        w2 = pad[:, :K]
    return w2.t()


def _im2col_conv(mm, x, w, w_scale, filter_shape, strides, padding,
                 rhs_dilation, out_dtype):
    p, (B, Ho, Wo) = _patches(x, filter_shape, strides, padding,
                              rhs_dilation)
    out = mm(p, w, w_scale, out_dtype=out_dtype or x.dtype)
    return out.reshape(B, Ho, Wo, -1).permute(0, 3, 1, 2)


def conv2d_w8(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
              filter_shape: Tuple[int, int], *, strides=(1, 1),
              padding: Padding = "SAME", rhs_dilation=None,
              out_dtype=None) -> torch.Tensor:
    """Weight-only INT8 conv: x (B, C, H, W) f32/bf16, w_q from
    :func:`quantize_conv_weight_per_channel` -> (B, co, Ho, Wo), through
    ``matmul_w8`` (KW8)."""
    return _im2col_conv(matmul_w8, x, w_q, w_scale, filter_shape, strides,
                        padding, rhs_dilation, out_dtype)


def conv2d_w8a8(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                filter_shape: Tuple[int, int], *, strides=(1, 1),
                padding: Padding = "SAME", rhs_dilation=None,
                out_dtype=None) -> torch.Tensor:
    """Full INT8 conv: each patch row (output pixel) quantized dynamically,
    int8 GEMM, scales in the epilogue — ``matmul_w8a8`` (K1 + KQ8)."""
    return _im2col_conv(matmul_w8a8, x, w_q, w_scale, filter_shape,
                        strides, padding, rhs_dilation, out_dtype)


def conv2d_w4(x: torch.Tensor, w_packed: torch.Tensor,
              w_scale: torch.Tensor, filter_shape: Tuple[int, int], *,
              strides=(1, 1), padding: Padding = "SAME", rhs_dilation=None,
              out_dtype=None) -> torch.Tensor:
    """Weight-only packed-INT4 conv (split-half nibbles), through
    ``matmul_w4`` (KW4)."""
    return _im2col_conv(matmul_w4, x, w_packed, w_scale, filter_shape,
                        strides, padding, rhs_dilation, out_dtype)


# --------------------------------------------------------------------------
# direct integer conv
# --------------------------------------------------------------------------

def _dilate_and_pad(xq: torch.Tensor, padding: Pairs, lhs_dilation,
                    fill) -> torch.Tensor:
    """Spatially dilate (transposed-conv zero insertion) and pad ``xq``
    (NCHW) with the constant ``fill`` (the activation zero point), so a
    VALID integer conv is exact for asymmetric activation grids."""
    dh, dw = lhs_dilation or (1, 1)
    if dh > 1 or dw > 1:
        B, C, H, W = xq.shape
        out = torch.full((B, C, (H - 1) * dh + 1, (W - 1) * dw + 1), fill,
                         dtype=xq.dtype, device=xq.device)
        out[:, :, ::dh, ::dw] = xq
        xq = out
    (ph0, ph1), (pw0, pw1) = padding
    if (ph0, ph1, pw0, pw1) != (0, 0, 0, 0):
        xq = F.pad(xq, (pw0, pw1, ph0, ph1), value=fill)
    return xq


def conv_int_core(xq: torch.Tensor, wq: torch.Tensor, *, strides,
                  padding: Pairs, feature_group_count: int = 1,
                  lhs_dilation=None, rhs_dilation=None,
                  fill: int = 0) -> torch.Tensor:
    """int8 x int8 -> int32 NCHW conv with explicit ``fill``-valued padding
    and dilation: xq (B, C, H, W) int8, wq (co, C/g, kh, kw) int8. An
    ungrouped conv runs as an int8 im2col and the exact int32 matmul (KQ8's
    int32 entry on the card); a grouped one as an f64 conv, exact."""
    xq = _dilate_and_pad(xq, padding, lhs_dilation, fill)
    co, cig, kh, kw = wq.shape
    if feature_group_count == 1:
        p, (B, Ho, Wo) = _int_patches(xq, (kh, kw), strides, rhs_dilation)
        acc = int8_matmul_int32(p, _weight_kmajor(wq))
        return acc.reshape(B, Ho, Wo, co).permute(0, 3, 1, 2).contiguous()
    bound = cig * kh * kw * 128 * 128
    if bound >= 2 ** 53:
        raise ValueError(f"grouped integer conv: sums may reach {bound}, "
                         f"beyond the 2^53 that f64 holds exactly")
    # cuDNN is off so that no FFT or Winograd algorithm is chosen: PyTorch's
    # own direct and im2col + DGEMM convs add exact products of integers
    with torch.backends.cudnn.flags(enabled=False):
        acc = F.conv2d(xq.to(torch.float64), wq.to(torch.float64),
                       stride=tuple(strides),
                       dilation=tuple(rhs_dilation or (1, 1)),
                       groups=feature_group_count)
    return torch.round(acc).to(torch.int32)


def conv2d_int8_static(x: torch.Tensor, wq: torch.Tensor,
                       w_scale: torch.Tensor, act_delta, act_offset,
                       act_steps: float, *, strides=(1, 1),
                       padding=((0, 0), (0, 0)),
                       feature_group_count: int = 1, lhs_dilation=None,
                       rhs_dilation=None, out_dtype=None) -> torch.Tensor:
    """Full static-INT8 conv: quantize x with its frozen calibration
    encoding, integer conv, zero-point correction:

        x = (q + off) * dx,  q in [0, steps]  ->  q_s = q - 128  (int8)
        y[co] = sw * dx * (conv_int(q_s, w)[co] + (128 + off) * sum(w[co]))

    Padded and inserted positions hold the signed zero point -(128 + off),
    so they contribute exactly 0. wq (co, ci/g, kh, kw) int8 codes, w_scale
    (co,)."""
    out_dtype = out_dtype or x.dtype
    dev = x.device
    dx = torch.as_tensor(act_delta, dtype=torch.float32,
                         device=dev).reshape(())
    off = torch.as_tensor(act_offset, dtype=torch.float32,
                          device=dev).reshape(())
    q = torch.clamp(torch.round(x.to(torch.float32) / dx - off), 0.0,
                    float(act_steps))
    q_s = (q - 128.0).to(torch.int8)
    zp = int(-(off + 128.0))
    acc = conv_int_core(q_s, wq, strides=strides, padding=padding,
                        feature_group_count=feature_group_count,
                        lhs_dilation=lhs_dilation,
                        rhs_dilation=rhs_dilation, fill=zp)
    wsum = wq.to(torch.int32).sum(dim=(1, 2, 3)).to(torch.float32)
    y = acc.to(torch.float32) + ((128.0 + off) * wsum)[None, :, None, None]
    return (y * (dx * w_scale)[None, :, None, None]).to(out_dtype)


def conv2d_w8a8_dynamic(x: torch.Tensor, wq: torch.Tensor,
                        w_scale: torch.Tensor, *, strides=(1, 1),
                        padding=((0, 0), (0, 0)),
                        feature_group_count: int = 1, lhs_dilation=None,
                        rhs_dilation=None, out_dtype=None) -> torch.Tensor:
    """Dynamic full-INT8 conv: per-tensor symmetric activation quantization
    (s = max(max|x|, 1e-8) / 127, zero point 0, so zero padding is exact),
    integer conv, epilogue rescale. The w4a8 / w8a8 conv without a static
    input encoding."""
    out_dtype = out_dtype or x.dtype
    xf = x.to(torch.float32)
    s = torch.clamp_min(xf.abs().amax(), 1e-8) / torch.tensor(
        127.0, device=x.device)
    q = torch.clamp(torch.round(xf / s), -127.0, 127.0)
    acc = conv_int_core(q.to(torch.int8), wq, strides=strides,
                        padding=padding,
                        feature_group_count=feature_group_count,
                        lhs_dilation=lhs_dilation,
                        rhs_dilation=rhs_dilation, fill=0)
    return (acc.to(torch.float32)
            * (s * w_scale)[None, :, None, None]).to(out_dtype)


def pack_int4_conv_co(q: torch.Tensor) -> torch.Tensor:
    """(co, ci/g, kh, kw) int codes in [-7, 7] -> (co//2, ci/g, kh, kw)
    int8, nibble-packed along the output channels (co even): even co in the
    low nibble, odd co in the high one."""
    q = q.to(torch.int32)
    return ((q[0::2] & 0xF) | ((q[1::2] & 0xF) << 4)).to(torch.int8)


def unpack_int4_conv_co(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4_conv_co` -> int8 codes (co, ci/g, kh,
    kw)."""
    lo = (packed << 4) >> 4                       # sign-extend low nibble
    hi = packed >> 4                              # arithmetic shift
    return torch.stack([lo, hi], dim=1).reshape(2 * packed.shape[0],
                                                *packed.shape[1:])


def conv2d_weight_only(x: torch.Tensor, wq: torch.Tensor,
                       w_scale: torch.Tensor, *, bits: int = 8,
                       strides=(1, 1), padding=((0, 0), (0, 0)),
                       feature_group_count: int = 1, lhs_dilation=None,
                       rhs_dilation=None,
                       out_dtype: Optional[torch.dtype] = None
                       ) -> torch.Tensor:
    """Weight-only INT conv: weights resident as INT codes (int8, or INT4
    packed along co when ``bits == 4``), dequantized inline, then a float
    conv in x's dtype (TF32 off)."""
    out_dtype = out_dtype or x.dtype
    if bits == 4:
        wq = unpack_int4_conv_co(wq)
    w = wq.to(torch.float32) * w_scale.to(torch.float32)[:, None, None, None]
    with no_tf32():
        return F.conv2d(
            _dilate_and_pad(x, padding, lhs_dilation, 0).to(x.dtype),
            w.to(x.dtype), stride=tuple(strides),
            dilation=tuple(rhs_dilation or (1, 1)),
            groups=feature_group_count).to(out_dtype)
