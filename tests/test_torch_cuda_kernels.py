"""The port's CUDA kernels against their plain PyTorch versions on the card,
at main-path shapes. Every test here needs a CUDA device and skips without
one. This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerances: codes, GEMM outputs and KV-cache bytes bit-exact; decode
attention output max error relative to its max < 2e-2 (bf16).
"""
import pytest
import torch

from aimet_tpu_torch.ops import int_matmul as tim
from aimet_tpu_torch.ops.decode_attention_fused import (
    fused_decode_attention, fused_decode_attention_torch)

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels)")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("m,k2,n,dtype", [
    (16, 2048, 6144, torch.bfloat16),       # decode wqkv
    (37, 72, 1000, torch.float32),          # ragged M, N and K
    (300, 7168, 4096, torch.bfloat16),      # prefill-like w_down
])
def test_w4a8_kernels_match_plain(gen, m, k2, n, dtype):
    x = torch.randn((m, 2 * k2), generator=gen, device="cuda").to(dtype)
    packed = torch.randint(-128, 128, (k2, n), dtype=torch.int8,
                           generator=gen, device="cuda")
    scale = torch.rand((n,), generator=gen, device="cuda") * 1e-3
    q, s = tim.quantize_activation_per_row(x)
    pq, ps = tim._quantize_activation_plain(x)
    assert torch.equal(q, pq) and torch.equal(s, ps)
    assert torch.equal(tim.matmul_w4a8(x, packed, scale),
                       tim.matmul_w4a8_torch(x, packed, scale))


@pytest.mark.parametrize("positions", ["scalar", "mixed", "outside"])
def test_decode_attention_kernel_matches_plain(gen, positions):
    b, s, h, kh, d = 16, 1024, 32, 8, 128
    kc = torch.randint(-127, 128, (b, s, kh, d), dtype=torch.int8,
                       generator=gen, device="cuda")
    vc = torch.randint(-127, 128, (b, s, kh, d), dtype=torch.int8,
                       generator=gen, device="cuda")
    ks = torch.rand((b, kh), generator=gen, device="cuda") * 0.05 + 0.01
    vs = torch.rand((b, kh), generator=gen, device="cuda") * 0.05 + 0.01
    qkv = torch.randn((b, (h + 2 * kh) * d), generator=gen,
                      device="cuda").to(torch.bfloat16)
    if positions == "scalar":
        pos = torch.full((b,), 700, dtype=torch.int32, device="cuda")
    else:
        pos = torch.randint(0, s, (b,), generator=gen, device="cuda",
                            dtype=torch.int32)
        pos[0], pos[-1] = 0, s - 1
        if positions == "outside":
            pos[1], pos[2] = s, s + 7
    ang = pos.float()[:, None] * torch.rand(d // 2, generator=gen,
                                            device="cuda")
    cos, sin = torch.cos(ang), torch.sin(ang)
    kc2, vc2 = kc.clone(), vc.clone()
    out, _, _ = fused_decode_attention(qkv, cos, sin, kc, vc, ks, vs, pos,
                                       n_heads=h, n_kv_heads=kh)
    ref, _, _ = fused_decode_attention_torch(qkv, cos, sin, kc2, vc2, ks, vs,
                                             pos, n_heads=h, n_kv_heads=kh)
    torch.cuda.synchronize()
    assert torch.equal(kc, kc2) and torch.equal(vc, vc2)
    err = (out.float() - ref.float()).abs().max() / ref.float().abs().max()
    assert err < 2e-2, err
