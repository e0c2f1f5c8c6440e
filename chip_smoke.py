#!/usr/bin/env python3
"""Smoke run of aimet_tpu_torch on one NVIDIA H100: Llama-3-8B in W4A8.

    python3 chip_smoke.py

1. builds the three hand-written kernels from ``aimet_tpu_torch/csrc``;
2. holds each kernel against its plain PyTorch version on the card at the
   main path's shapes (codes, GEMM outputs and KV-cache bytes bit-exact;
   decode attention within 2e-2 of its max), and times kernel, plain
   version and the bound the card's peaks set;
3. draws ``TransformerConfig.llama3_8b()`` weights with
   ``random_quantized_weights`` on the card and drives the main path with
   the launch counts set to 0: a prefill of 8 x 512 tokens, 32 decode steps
   at batch 16 and at batch 32, and 32 requests served to completion by
   ``ContinuousBatcher(num_slots=16)``; every kernel must have launched;
4. compares one prefill and one decode step of the whole model through the
   kernels with the same through the plain versions (prefill logits
   identical; decode logits within 5e-2 of their max);
5. prints the measurements, the card's name and power limit, a ``kernels``
   JSON line and, last, ``{"ok": true, "device": {...}}``.

Any failed phase exits non-zero. Without CUDA, or outside a checkout of the
repository, it exits non-zero before printing any result.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3, int8 tensor
# core ops/s, f32 CUDA-core FLOP/s
HBM_BPS = 3.35e12
INT8_OPS = 1979e12
F32_FLOPS = 67e12
TOL_ATTN = 2e-2          # K3 vs plain: max |diff| / max |plain|, bf16
TOL_DECODE_LOGITS = 5e-2  # whole-model decode logits, same measure


def log(*a):
    print(*a, flush=True)


def _kernel_events(prof, match=None):
    """CUDA kernel events of a profile, optionally those whose name
    contains one of the strings in ``match``."""
    import torch
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and (match is None or any(m in e.name for m in match))]


def timed(fn, iters, match=None, warmup=3):
    """Run fn(i) ``iters`` times under torch.profiler. Returns (device ms
    per call of the CUDA kernels named by ``match``, or of all kernels when
    ``match`` is None; host-clock ms per call, synchronised)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev = _kernel_events(prof, match)
    assert ev, f"profiler recorded no CUDA kernel matching {match}"
    dev_us = sum(e.time_range.elapsed_us() for e in ev)
    return dev_us / 1e3 / iters, wall * 1e3 / iters


def bound_ms(nbytes, ops, peak_ops):
    t_bytes, t_ops = nbytes / HBM_BPS, ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check_kernels(torch, tim, dattn):
    """Phase 2: every kernel against its plain version, and its timing."""
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(1)
    rows = {}
    errs = {"act_quant": 0.0, "w4a8_gemm": 0.0, "decode_attention": 0.0}

    def note(name, a, b):
        e = (a.float() - b.float()).abs().max().item()
        errs[name] = max(errs[name], e)

    # --- K1: activation quantizer at prefill and decode shapes
    for m, k in ((4096, 4096), (4096, 14336), (16, 4096)):
        x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
        q, s = tim.quantize_activation_per_row(x)
        pq, ps = tim._quantize_activation_plain(x)
        note("act_quant", q, pq)
        assert torch.equal(q, pq) and torch.equal(s, ps), ("K1", m, k)
    log("K1 act_quant: codes and scales bit-exact at (4096,4096), "
        "(4096,14336), (16,4096)")
    m, k = 4096, 4096
    xs = [torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
          for _ in range(4)]
    ms, call = timed(lambda i: tim.quantize_activation_per_row(xs[i % 4]),
                     50, ["act_quant_kernel"])
    pms, _ = timed(lambda i: tim._quantize_activation_plain(xs[i % 4]), 10)
    b, how = bound_ms(m * k * 2 + m * k + m * 4, 3 * m * k, F32_FLOPS)
    rows["act_quant"] = dict(kernel="act_quant", shape=f"x ({m},{k}) bf16",
                             ms=ms, call_ms=call, plain_ms=pms, bound_ms=b,
                             bound_by=how, library_ms=None)

    # --- K2: W4A8 GEMM, bit-exact at every main-path (K, N) and M in
    # {16, 2048}, plus a ragged shape
    kn = [(4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096),
          (4096, 131072)]
    for m in (16, 2048):
        for k, n in kn:
            x = torch.randn((m, k), generator=g, device=dev).to(
                torch.bfloat16)
            w = torch.randint(-128, 128, (k // 2, n), dtype=torch.int8,
                              generator=g, device=dev)
            sw = (torch.rand((n,), generator=g, device=dev) + 0.5) * 0.02 \
                / k ** 0.5
            xq, sx = tim.quantize_activation_per_row(x)
            got = tim.w4a8_gemm(xq, sx, w, sw, torch.bfloat16)
            want = tim.w4a8_gemm_torch(xq, sx, w, sw, torch.bfloat16)
            note("w4a8_gemm", got, want)
            assert torch.equal(got, want), ("K2", m, k, n)
            del x, w, got, want
    x = torch.randn((37, 144), generator=g, device=dev)
    w = torch.randint(-128, 128, (72, 1000), dtype=torch.int8, generator=g,
                      device=dev)
    sw = torch.rand((1000,), generator=g, device=dev)
    assert torch.equal(tim.matmul_w4a8(x, w, sw),
                       tim.matmul_w4a8_torch(x, w, sw)), "K2 ragged"
    log("K2 w4a8_gemm: bit-exact at M in {16, 2048} x (K, N) in "
        f"{kn}, and at ragged (37, 144) x (144, 1000) f32")

    def gemm_row(m, k, n, label):
        # rotate 3 weight copies so the decode weights stream from HBM
        ws = [torch.randint(-128, 128, (k // 2, n), dtype=torch.int8,
                            generator=g, device=dev) for _ in range(3)]
        sw = torch.rand((n,), generator=g, device=dev) * 1e-3
        xq, sx = tim.quantize_activation_per_row(
            torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16))
        ms, call = timed(lambda i: tim.w4a8_gemm(xq, sx, ws[i % 3], sw,
                                                 torch.bfloat16), 20,
                         ["w4a8_gemm_kernel", "w4a8_epilogue_kernel"])
        pms, _ = timed(lambda i: tim.w4a8_gemm_torch(xq, sx, ws[i % 3], sw,
                                                     torch.bfloat16), 3,
                       warmup=1)
        b, how = bound_ms(m * k + m * 4 + k // 2 * n + n * 4 + m * n * 2,
                          2 * m * n * k, INT8_OPS)
        rows[label] = dict(kernel="w4a8_gemm", shape=f"M={m} K={k} N={n}",
                           ms=ms, call_ms=call, plain_ms=pms,
                           bound_ms=b, bound_by=how, library_ms=None)

    gemm_row(16, 4096, 28672, "w4a8_gemm[decode]")
    gemm_row(4096, 4096, 28672, "w4a8_gemm[prefill]")

    # --- K3: decode attention at B=16, S=1024, H=32, KH=8, D=128
    B, S, H, KH, D = 16, 1024, 32, 8, 128

    def attn_inputs(pos):
        kc = torch.randint(-127, 128, (B, S, KH, D), dtype=torch.int8,
                           generator=g, device=dev)
        vc = torch.randint(-127, 128, (B, S, KH, D), dtype=torch.int8,
                           generator=g, device=dev)
        ks = torch.rand((B, KH), generator=g, device=dev) * 0.05 + 0.01
        vs = torch.rand((B, KH), generator=g, device=dev) * 0.05 + 0.01
        qkv = torch.randn((B, (H + 2 * KH) * D), generator=g,
                          device=dev).to(torch.bfloat16)
        ang = pos.float()[:, None] * torch.rand(D // 2, generator=g,
                                                device=dev)
        return [qkv, torch.cos(ang), torch.sin(ang), kc, vc, ks, vs, pos]

    mixed = torch.randint(0, S, (B,), generator=g, device=dev,
                          dtype=torch.int32)
    mixed[0], mixed[-1] = 0, S - 1
    for name, pos in (("scalar 700", torch.full((B,), 700, device=dev,
                                                dtype=torch.int32)),
                      ("mixed", mixed)):
        a = attn_inputs(pos)
        b_ = [t.clone() for t in a]
        out, _, _ = dattn.fused_decode_attention(*a, n_heads=H,
                                                 n_kv_heads=KH)
        ref, _, _ = dattn.fused_decode_attention_torch(*b_, n_heads=H,
                                                       n_kv_heads=KH)
        note("decode_attention", out, ref)
        assert torch.equal(a[3], b_[3]) and torch.equal(a[4], b_[4]), \
            ("K3 cache bytes", name)
        err = ((out.float() - ref.float()).abs().max()
               / ref.float().abs().max()).item()
        assert err < TOL_ATTN, ("K3", name, err)
        log(f"K3 decode_attention ({name} positions): cache bytes "
            f"bit-exact, attn max rel err {err:.3e} < {TOL_ATTN}")
    # timing: 4 input sets (4 x 33.5 MB of cache) so reads come from HBM
    sets = [attn_inputs(mixed) for _ in range(4)]
    ms, call = timed(lambda i: dattn.fused_decode_attention(
        *sets[i % 4], n_heads=H, n_kv_heads=KH), 40,
        ["decode_attention_kernel"])
    pms, _ = timed(lambda i: dattn.fused_decode_attention_torch(
        *sets[i % 4], n_heads=H, n_kv_heads=KH), 10)
    live = int((mixed.clamp(max=S - 1) + 1).sum())
    nbytes = (B * (H + 2 * KH) * D * 2 + 2 * B * D // 2 * 4
              + 2 * live * KH * D + 4 * B * KH * 4 + 2 * B * KH * D
              + B * H * D * 2)
    b, how = bound_ms(nbytes, 4 * live * H * D, F32_FLOPS)
    rows["decode_attention"] = dict(
        kernel="decode_attention",
        shape=f"B={B} S={S} H={H} KH={KH} D={D} mixed positions "
        f"({live} live rows)", ms=ms, call_ms=call, plain_ms=pms, bound_ms=b, bound_by=how,
        library_ms=None)
    for r in rows.values():
        r["max_abs_err"] = errs[r["kernel"]]
    return rows


@contextlib.contextmanager
def plain_versions(qllm, tim, dattn):
    """Route the serving path through the plain versions (comparison only:
    the package itself always launches the kernels on the card)."""
    saved = (qllm.matmul_w4a8, qllm.fused_decode_attention)
    qllm.matmul_w4a8 = tim.matmul_w4a8_torch
    qllm.fused_decode_attention = dattn.fused_decode_attention_torch
    try:
        yield
    finally:
        qllm.matmul_w4a8, qllm.fused_decode_attention = saved


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from aimet_tpu_torch import _build
    from aimet_tpu_torch.models.transformer import TransformerConfig
    from aimet_tpu_torch.ops import decode_attention_fused as dattn
    from aimet_tpu_torch.ops import int_matmul as tim
    from aimet_tpu_torch.serving import quantized_llm as qllm
    from aimet_tpu_torch.serving.batcher import ContinuousBatcher

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"device {torch.cuda.get_device_name(0)}; {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False

    # --- 1. build
    t = time.time()
    lib = _build.build()
    log(f"build: {time.time() - t:.1f} s -> {lib}")
    _build.library()

    # --- 2. kernels against their plain versions
    rows = check_kernels(torch, tim, dattn)
    for name, r in rows.items():
        log(f"  {name:20s} {r['shape']}: kernel {r['ms']:.4f} ms on the "
            f"device ({r['call_ms']:.4f} ms per wrapper call), plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})")

    # --- 3. the main path at Llama-3-8B widths
    cfg = TransformerConfig.llama3_8b()
    t = time.time()
    qw = qllm.random_quantized_weights(cfg, seed=0)
    torch.cuda.synchronize()
    log(f"weights: {qllm.quantized_weight_bytes(qw) / 1e9:.3f} GB drawn in "
        f"{time.time() - t:.1f} s")
    llm = qllm.QuantizedLLM.from_quantized(qw, cfg, max_len=1024)
    g = torch.Generator(device="cuda").manual_seed(2)
    counters = (tim.quantize_activation_per_row, tim.w4a8_gemm,
                dattn.fused_decode_attention)
    for fn in counters:
        fn.launches = 0
    counts = lambda: [fn.launches for fn in counters]
    metrics = {}

    def prefill(b, t_len):
        toks = torch.randint(0, cfg.vocab_size, (b, t_len), generator=g,
                             device="cuda")
        caches = llm.new_caches(b)
        torch.cuda.synchronize()
        t0 = time.time()
        logits, caches = llm.prefill(toks, caches)
        torch.cuda.synchronize()
        dt = time.time() - t0
        assert logits.shape == (b, t_len, cfg.vocab_size)
        assert torch.isfinite(logits).all(), "prefill logits not finite"
        return logits, caches, dt

    c0 = counts()
    _, _, dt = prefill(8, 512)              # first call: allocator warm-up
    c1 = counts()
    _, _, dt = prefill(8, 512)
    metrics["prefill_8x512_s"] = dt
    metrics["prefill_tok_s"] = 8 * 512 / dt
    per_prefill = [b - a for a, b in zip(c0, c1)]
    log(f"prefill 8x512: {dt * 1e3:.1f} ms, {8 * 512 / dt:.0f} tok/s; "
        f"launches (K1, K2, K3) per prefill {per_prefill}")

    for b in (16, 32):
        logits, caches, _ = prefill(b, 512)
        tok = logits[:, -1].argmax(-1)[:, None]
        del logits
        pos = 512
        for rep in range(2):             # twice: the spread of the host clock
            logits, caches = llm.decode(tok, caches, pos)    # warm-up step
            tok = logits[:, -1].argmax(-1)[:, None]
            pos += 1
            c0 = counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(32):
                logits, caches = llm.decode(tok, caches, pos)
                tok = logits[:, -1].argmax(-1)[:, None]
                pos += 1
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            c1 = counts()
            assert torch.isfinite(logits).all(), "decode logits not finite"
            assert logits.shape == (b, 1, cfg.vocab_size)
            per_step = [(y - x) / 32 for x, y in zip(c0, c1)]
            metrics[f"decode_b{b}_ms_step"] = dt / 32 * 1e3
            metrics[f"decode_b{b}_tok_s"] = b * 32 / dt
            log(f"decode batch {b} (run {rep}): {dt / 32 * 1e3:.2f} ms/step,"
                f" {b * 32 / dt:.0f} tok/s; launches (K1, K2, K3) per step "
                f"{per_step}")
        if b == 16:
            # where a decode step's time goes: device busy share and the
            # device time of each kernel, over 4 profiled steps
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(4):
                    logits, caches = llm.decode(tok, caches, pos)
                    tok = logits[:, -1].argmax(-1)[:, None]
                    pos += 1
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            by_name = {}
            for e in _kernel_events(prof):
                key = e.name.replace("(anonymous namespace)::", "")
                key = key.removeprefix("void ").split("<")[0].split("(")[0]
                by_name[key] = by_name.get(key, 0.0) + \
                    e.time_range.elapsed_us() / 4e3
            busy = sum(by_name.values()) / (wall * 1e3 / 4)
            metrics["decode_b16_device_busy"] = busy
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
            log(f"decode batch 16 profile: {wall * 1e3 / 4:.2f} ms/step on "
                f"the host clock, device busy {busy:.3f}; device ms/step by "
                "kernel: " + ", ".join(f"{k} {v:.3f}" for k, v in top))
        del caches, logits

    batcher = ContinuousBatcher(llm, num_slots=16, step_chunk=4)
    draw = lambda lo, hi, n: torch.randint(lo, hi, (n,), generator=g,
                                           device="cuda").tolist()
    lens, news = draw(32, 257, 32), draw(16, 65, 32)
    reqs = [batcher.submit(draw(0, cfg.vocab_size, n), max_new_tokens=m)
            for n, m in zip(lens, news)]
    torch.cuda.synchronize()
    t0 = time.time()
    steps = batcher.run_until_done(max_steps=1000)
    dt = time.time() - t0
    assert all(r.done for r in reqs), "batcher left requests unfinished"
    assert [len(r.generated) for r in reqs] == news
    assert all(0 <= t < cfg.vocab_size for r in reqs for t in r.generated)
    metrics["cb_requests"] = len(reqs)
    metrics["cb_tok_s"] = sum(news) / dt
    metrics["cb_s"] = dt
    log(f"continuous batcher: {len(reqs)} requests, {sum(news)} tokens in "
        f"{dt:.2f} s ({sum(news) / dt:.0f} tok/s), {steps} engine steps")

    launches = dict(zip(("act_quant", "w4a8_gemm", "decode_attention"),
                        counts()))
    log(f"main-path launches: {launches}")
    for name, n in launches.items():
        assert n > 0, f"kernel {name} never launched on the main path"

    # --- 4. whole model through the kernels vs through the plain versions
    toks = torch.randint(0, cfg.vocab_size, (2, 128), generator=g,
                         device="cuda")

    def one_prefill_and_decode():
        caches = llm.new_caches(2)
        pl, caches = llm.prefill(toks, caches)
        nxt = pl[:, -1].argmax(-1)[:, None]
        dl, _ = llm.decode(nxt, caches, torch.tensor([128, 128],
                                                     device="cuda"))
        return pl, dl

    kp, kd = one_prefill_and_decode()
    with plain_versions(qllm, tim, dattn):
        pp, pd = one_prefill_and_decode()
    assert torch.equal(kp, pp), "prefill logits: kernels != plain versions"
    derr = ((kd - pd).abs().max() / pd.abs().max()).item()
    agree = (kd.argmax(-1) == pd.argmax(-1)).float().mean().item()
    assert derr < TOL_DECODE_LOGITS, ("decode logits", derr)
    log(f"whole model (32 layers, 2x128 prefill + 1 decode step): prefill "
        f"logits identical; decode logits max rel err {derr:.3e} < "
        f"{TOL_DECODE_LOGITS}, top-1 agreement {agree:.3f}")
    metrics["decode_logits_rel_err"] = derr

    srcs = {"act_quant": "aimet_tpu_torch/csrc/act_quant.cu",
            "w4a8_gemm": "aimet_tpu_torch/csrc/w4a8_gemm.cu",
            "decode_attention": "aimet_tpu_torch/csrc/decode_attention.cu"}
    replaces = {
        "act_quant": "aimet_tpu/ops/int_matmul.py:692",
        "w4a8_gemm": "aimet_tpu/ops/int_matmul.py:692, "
                     "aimet_tpu/ops/int_matmul.py:767",
        "decode_attention": "aimet_tpu/ops/decode_attention_fused.py:280"}
    kernels = []
    for label, r in rows.items():
        base = r["kernel"]
        kernels.append(dict(
            name=label, route="cuda", source=srcs[base],
            replaces=replaces[base], launches=launches[base],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            shape=r["shape"]))
    log(json.dumps({"metrics": metrics, "card": smi}))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
