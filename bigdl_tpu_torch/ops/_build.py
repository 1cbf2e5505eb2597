"""Builds the port's CUDA kernels from ``bigdl_tpu_torch/csrc`` and
loads them with ctypes.

Each ``.cu`` source becomes one shared library with a plain C interface
(``nvcc -gencode arch=compute_90a,code=sm_90a -shared``), named by a hash
of its sources so an edited kernel is rebuilt and an unchanged one is
reused.  The libraries go to ``build/kernels/`` at the checkout's root.
All sources compile in parallel, one ``nvcc`` each, at first use; a
failed build raises with the compiler's output.  Nothing is compiled
when the package is imported.  A first use inside a CUDA graph capture
raises: build before capturing (``utils/graphs.py`` ``prepare``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

#: one shared library per source: name -> (source, C entry points)
SOURCES: Dict[str, tuple] = {
    "fused_matmul_bn": ("fused_matmul_bn.cu",
                        ("fused_matmul_bn_bf16", "fused_matmul_bn_f32")),
    "fused_conv3x3_bn": ("fused_conv3x3_bn.cu",
                         ("fused_conv3x3_bn_bf16", "fused_conv3x3_bn_f32")),
    "fused_matmul_bn_dgrad": ("fused_matmul_bn_dgrad.cu",
                              ("fused_matmul_bn_dgrad_bf16",
                               "fused_matmul_bn_dgrad_f32")),
    "fused_matmul_bn_wgrad": ("fused_matmul_bn_wgrad.cu",
                              ("fused_matmul_bn_wgrad_bf16",
                               "fused_matmul_bn_wgrad_f32")),
    "fused_conv3x3_bn_dgrad": ("fused_conv3x3_bn_dgrad.cu",
                               ("fused_conv3x3_bn_dgrad_bf16",
                                "fused_conv3x3_bn_dgrad_f32")),
    "flash_attention": ("flash_attention.cu",
                        ("flash_attention_fwd_bf16",
                         "flash_attention_fwd_f32")),
    "int8_matmul": ("int8_matmul.cu",
                    ("int8_matmul_dequant_bf16", "int8_matmul_dequant_f32")),
}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
#: argument types of each entry point (pointers as c_void_p: a Python
#: int passed bare would be cut to 32 bits)
ARGTYPES = {
    # x, w, ps, pb, y, ws, 4 column-sum buffers; M, K, N, prologue,
    # relu, bn, per, blocks; stream
    "fused_matmul_bn": [_P] * 10 + [_I] * 8 + [_P],
    # x, w, ps, pb, y, ws, 4 column-sum buffers; B, H, W, C, Co,
    # prologue, relu, bn, per; stream
    "fused_conv3x3_bn": [_P] * 10 + [_I] * 9 + [_P],
    # dy, y, dssum, dssq, w, x, ps, pb, dx, ws, 4 column-sum buffers;
    # M, K, N, prologue, relu, bn, per, blocks; stream
    "fused_matmul_bn_dgrad": [_P] * 14 + [_I] * 8 + [_P],
    # x, ps, pb, dy, y, dssum, dssq, part, dw; M, K, N, bk, per,
    # prologue, relu; stream
    "fused_matmul_bn_wgrad": [_P] * 9 + [_I] * 7 + [_P],
    # dy, y, dssum, dssq, w, x, ps, pb, dx, ws, 4 column-sum buffers;
    # B, H, W, Ci, Co, prologue, relu, bn, per; stream
    "fused_conv3x3_bn_dgrad": [_P] * 14 + [_I] * 9 + [_P],
    # q, k, v, o, lse; B, H, T, S, D; the 12 strides (a host array);
    # sm_scale, causal, stream
    "flash_attention": [_P] * 5 + [_I] * 5 + [_P, _F, _I, _P],
    # x, w, scale, y, split-K workspace and counters; M, K, N; the row
    # strides of x, of w's (N, K) view and of y; swap, bm, bn, stages,
    # per, blocks, resident; stream
    "int8_matmul": [_P] * 6 + [_I] * 3 + [_L] * 3 + [_I] * 7 + [_P],
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: what the last build did: seconds, per-library compiler output
build_info: Dict[str, object] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def _digest(src: Path) -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cuh")) + [src]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:12]


def _nvcc_cmd(src: Path, out: Path, verbose: bool) -> List[str]:
    cmd = [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-I", str(CSRC), "-o", str(out), str(src)]
    if verbose:
        cmd[1:1] = ["-Xptxas", "-v"]
    return cmd


def build(verbose: bool = False) -> Dict[str, Path]:
    """Compile every source whose library is missing, all in parallel;
    returns name -> library path.  Raises ``RuntimeError`` naming the
    source and the compiler output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    paths, procs = {}, {}
    for name, (src_name, _) in SOURCES.items():
        src = CSRC / src_name
        lib = BUILD_DIR / f"lib{name}-{_digest(src)}.so"
        paths[name] = lib
        if lib.exists() and not verbose:
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            _nvcc_cmd(src, tmp, verbose), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, lib)
    logs, failed = {}, []
    for name, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)  # atomic: a concurrent loader never
            # sees a half-written library
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    build_info.update(seconds=time.perf_counter() - t0,
                      compiled=sorted(procs), logs=logs)
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (building all kernels on first use),
    with argument and return types set on its entry points."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    import torch

    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"kernel library {name!r} is first used inside a CUDA graph "
            "capture, where nvcc and dlopen cannot run: build and load the "
            "kernels before capturing (bigdl_tpu_torch.utils.graphs.prepare)")
    with _lock:
        if name not in _libs:
            paths = build()
            for n, path in paths.items():
                handle = ctypes.CDLL(str(path))
                for fn in SOURCES[n][1]:
                    f = getattr(handle, fn)
                    f.argtypes = ARGTYPES[n]
                    f.restype = ctypes.c_int
                _libs[n] = handle
        return _libs[name]


def check(err: int, what: str):
    """Raise when a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
