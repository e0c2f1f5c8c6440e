"""Build the hand-written Hopper kernels in ``csrc/`` at first use.

Each ``.cu`` source is compiled by its own ``nvcc`` process (all started
together) for ``sm_90a`` into an object file, and the objects are linked
into one shared library with a plain C interface, loaded with ``ctypes``.
No PyTorch headers are involved, so a build takes seconds.

The library lives under ``aimet_tpu_torch/_build/<hash>/``, keyed by a hash
of the sources and the flags, so an edited source rebuilds and an unchanged
one is loaded as it is. No ``--use_fast_math``: the kernels' integer codes
must match the plain versions bit for bit, which needs IEEE division and
round-half-to-even.

The whole-layer kernels (``csrc/fused_layer.cu``) and K2's fused decode
kernel (``csrc/w4a8_gemm.cu``) synchronise the grid with
``cooperative_groups::this_grid().sync()`` under
``cudaLaunchCooperativeKernel``; since CUDA 11 that needs no relocatable
device code (``-rdc``) and no device link, so every source builds with
the same flags.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LIB_NAME = "libaimet_tpu_torch_kernels.so"

_VP = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: name -> argtypes. Every function returns cudaError_t.
SIGNATURES = {
    # x, q, sx, M, K, lanes, rows, x_is_bf16, stream
    "aimet_act_quant": [_VP, _VP, _VP] + [_I] * 5 + [_VP],
    # xq, sx, wp, sw, out, ws, M, N, K2, splits, out_is_bf16, stream
    "aimet_w4a8_gemm": [_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I,
                        _VP],
    # xq, sx, wp, sw, out, ws, cnt, M, N, K2, blocks, ws_values,
    # cnt_values, out_is_bf16, stream
    "aimet_w4a8_decode_gemm": [_VP] * 7 + [_I] * 4
    + [ctypes.c_longlong, _I, _I, _VP],
    # xq, sx, wp, sw, out, M, N, K2, out_is_bf16, stream
    "aimet_w4a8_tile_gemm": [_VP] * 5 + [_I] * 4 + [_VP],
    # x, xq, sx, wp, sw, out, ws, cnt, M, N, K2, blocks, ws_values,
    # cnt_values, x_is_bf16, out_is_bf16, stream
    "aimet_w4a8_fusedq_decode_gemm": [_VP] * 8 + [_I] * 4
    + [ctypes.c_longlong, _I, _I, _I, _VP],
    # qkv, cos, sin, kc, vc, ks, vs, iks, ivs, pos, out, ws, cnt,
    # B, S, H, KH, D, chunk, ws_values, cnt_values, sqrt_d, io_is_bf16,
    # stream
    "aimet_decode_attention": [_VP] * 13 + [_I] * 6
    + [ctypes.c_longlong, _I, _F, _I, _VP],
    # q, kc, vc, ks, vs, pos, out, ws, cnt, B, S, KH, rep, D, chunk,
    # ws_values, cnt_values, sqrt_d, q_is_bf16, stream
    "aimet_gqa_attention": [_VP] * 5 + [_I] + [_VP] * 3 + [_I] * 6
    + [ctypes.c_longlong, _I, _F, _I, _VP],
    # x, w, sw, out, ws, M, N, K, splits, x_is_f32, out_is_bf16, stream
    "aimet_w4_gemm": [_VP] * 5 + [_I] * 6 + [_VP],
    "aimet_w8_gemm": [_VP] * 5 + [_I] * 6 + [_VP],
    # x, w, sw, out, ws, cnt, M, N, K, blocks, ws_values, cnt_values,
    # out_is_bf16, stream
    "aimet_w8_decode_gemm": [_VP] * 6 + [_I] * 4
    + [ctypes.c_longlong, _I, _I, _VP],
    "aimet_w4_decode_gemm": [_VP] * 6 + [_I] * 4
    + [ctypes.c_longlong, _I, _I, _VP],
    # x, w, sw, out, ws, M, N, K, x_is_f32, out_is_bf16, ws_bytes, stream
    "aimet_w4_tile_gemm": [_VP] * 5 + [_I] * 5 + [ctypes.c_longlong, _VP],
    "aimet_w8_tile_gemm": [_VP] * 5 + [_I] * 5 + [ctypes.c_longlong, _VP],
    # x, w, gs, out, ws, M, N, K, group, x_is_f32, out_is_bf16, ws_bytes,
    # stream
    "aimet_w4g_tile_gemm": [_VP] * 5 + [_I] * 6 + [ctypes.c_longlong, _VP],
    # x, w, gs, out, ws, M, N, K, group, splits, x_is_f32, out_is_bf16,
    # decode, stream
    "aimet_w4g_gemm": [_VP] * 5 + [_I] * 8 + [_VP],
    # x, xq, M, K, inv_dx, shift, hi, x_is_bf16, stream
    "aimet_staticq_quant": [_VP, _VP, _I, _I, _F, _F, _F, _I, _VP],
    # xq, w, sv, cb, out, ws, M, N, K, splits, out_is_bf16, stream
    "aimet_staticq_gemm": [_VP] * 6 + [_I] * 5 + [_VP],
    # xq, w, sv, cb, out, M, N, K, out_is_bf16, stream
    "aimet_staticq_tile_gemm": [_VP] * 5 + [_I] * 4 + [_VP],
    # xq, sx, w, sw, cb, out, ws, M, N, K, splits, out_kind, stream
    "aimet_q8_gemm": [_VP] * 7 + [_I] * 5 + [_VP],
    # xq, sx, w, sw, cb, out, M, N, K, out_is_bf16, stream
    "aimet_q8_tile_gemm": [_VP] * 6 + [_I] * 4 + [_VP],
    # xq, lda, w (N, K), ldb, out, M, N, K, splits, stream
    "aimet_q8_int32_kmajor": [_VP, _I, _VP, _I, _VP] + [_I] * 4 + [_VP],
    # attn, int8, rep, head_dim, S -> bytes (not an error code)
    "aimet_fused_layer_smem": [_I] * 5,
    # attn, int8, smem, int* blocks
    "aimet_fused_layer_grid": [_I] * 3 + [_VP],
    # FusedLayerArgs*, attn, int8, grid, smem, stream
    "aimet_fused_layer": [_VP] + [_I] * 4 + [_VP],
}


def _sources():
    return sorted(list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")))


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the aimet_tpu_torch kernels")


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> Path:
    """Compile (if not yet built) and return the path of the library.
    Raises ``RuntimeError`` with the compiler's output if a build fails."""
    out_dir = build_dir()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    nvcc = find_nvcc()
    # objects go to a directory of this process's own, so concurrent first
    # uses (test workers) never link each other's half-written files
    work = out_dir / f"objs.{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = work / (src.stem + ".o")
        cmd = [nvcc, *CFLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    for src, _, p in procs:
        text, _ = p.communicate()
        log.append(f"== {src.name} (rc {p.returncode})\n{text}")
        if p.returncode != 0:
            failed.append(src.name)
    (out_dir / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
    tmp = work / LIB_NAME
    link = subprocess.run(
        [nvcc, *ARCH, "-shared", "-o", str(tmp),
         *[str(o) for _, o, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib)        # atomic: a concurrent loader sees all or none
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def launch(name: str, *args) -> None:
    """Call one C entry point with ``args``; raise if it returned a CUDA
    error (a refused or failed launch)."""
    err = getattr(library(), name)(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


def stream_ptr(device) -> int:
    """The current CUDA stream of ``device``, for a kernel launch."""
    return torch.cuda.current_stream(device).cuda_stream
