"""Build and load the hand-written Hopper kernels.

All of ``editor_tpu_torch/csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a``
into one shared library with a plain C interface (no PyTorch headers, so the
build takes seconds), at first use, into ``editor_tpu_torch/_build/`` (listed
in ``.gitignore``): one ``nvcc -c`` per source, all started together, then one
link. The library's file name carries a hash of the sources and
flags, so an edited source is rebuilt and a stale library is never loaded.
Only sources in the repository are compiled; nothing is downloaded.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a non-zero code into an exception.
This module is imported only on the CUDA branch of the kernel wrappers.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signature of each entry point: (argtypes); every one returns an int code
SIGNATURES = {
    # qkv, out, probs, B, N, H, D, scale, stream
    "editor_attention_qkv": [_P, _P, _P, _I, _I, _I, _I, _F, _P],
    # T1: q, k, v, ldq, ldk, ldv, out, probs, B, N, H, D, scale, heads per
    # block, sequences per block, stream
    "editor_attention_split": [_P, _P, _P, _I, _I, _I, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P],
    # T2: qkv, out, B, N, H, D, scale, sequences per block, stream
    "editor_attention_nomax": [_P, _P, _I, _I, _I, _I, _F, _I, _P],
    # T3: x, ln weight, ln bias, wqkv, bqkv, wp, bp, out, probs, qkv workspace,
    # attention workspace (first the normalised rows'), B, N, H, D, scale, eps,
    # sequences per block, stream
    "editor_attn_layer": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F,
                          _I, _P],
    # probs, out, L, Z, N, stream
    "editor_rollout_chain": [_P, _P, _I, _I, _I, _P],
    # T4: probs, out, L, Z, N, how (0 f32, 1 bf16, 2 rows), pairs per block, stream
    "editor_rollout_variant": [_P, _P, _I, _I, _I, _I, _I, _P],
    # T5: probs, out, L, Z, N, maps in flight, pairs per block, stream
    "editor_rollout_multi": [_P, _P, _I, _I, _I, _I, _I, _P],
    # qkv, mask, out, B, N, H, D, scale, fill, group (sequences a block; 0: one), stream
    "editor_masked_attention": [_P, _P, _P, _I, _I, _I, _I, _F, _F, _I, _P],
    # qkv, g, dqkv, p scratch, dl scratch, B, N, H, D, scale, stream
    "editor_attention_qkv_bwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    # N, D, the side of each scratch map (out; 0: none)
    "editor_attention_qkv_bwd_scratch": [_I, _I, ctypes.POINTER(_I)],
    # qkv, mask, g, dqkv, p scratch, dl scratch, B, N, H, D, scale, fill, group, stream
    "editor_masked_attention_bwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _I, _P],
    # N, D, the side of each scratch map of K5's launch (out; 0: none)
    "editor_masked_attention_bwd_scratch": [_I, _I, ctypes.POINTER(_I)],
    # qkv, mask, out, B, N, H, D, scale, fill, tile, group, stream
    "editor_masked_attention_tiled": [_P, _P, _P, _I, _I, _I, _I, _F, _F, _I, _I, _P],
    # qkv, mask, g, dqkv, p scratch, dl scratch, B, N, H, D, scale, fill, tile, stream
    "editor_masked_attention_tiled_bwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F,
                                          _I, _P],
    # x, w, bias (or null), gamma, beta, out, scratch for the normalised rows,
    # T, C, O, eps, gelu, stream
    "editor_ln_matmul": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P],
}

_lock = threading.Lock()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH): the CUDA "
            "kernels of editor_tpu_torch cannot be built")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libeditor_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library for these exact sources exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [str(Path(tmp) / f"{src.stem}.o") for src in cu]
        compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                    for src, obj in zip(cu, objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  text=True) for cmd in compiles]
        failed = []
        for cmd, proc in zip(compiles, procs):
            stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                              f"{stdout}\n{stderr}")
        if failed:
            raise RuntimeError("\n".join(failed))
        lib = str(Path(tmp) / out.name)
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{' '.join(link)}\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(lib, out)  # atomic: a concurrent loader never sees half a file
    return out


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library with every entry point's argtypes set."""
    with _lock:
        lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.editor_error_string.argtypes = [ctypes.c_int]
    lib.editor_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, kernel: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if code != 0:
        msg = library().editor_error_string(code).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: {msg} (cudaError {code})")
