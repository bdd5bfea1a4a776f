"""Native (C++) host code bound through ctypes: k-reciprocal re-ranking and
the batch JPEG decode + bicubic resize.

Counterpart of ``editor_tpu/native/__init__.py``, with the port's own copies
of its sources (``reranking.cpp``, ``imagecodec.cpp``). Host code: ``g++``
builds each at first use (``-O3 -march=native -std=c++17 -shared -fPIC
-fopenmp``, the codec with ``-ljpeg``) into ``editor_tpu_torch/_build/native/``,
a library named by the hash of its source, its command and the host (a
``-march=native`` build of one machine is not run on another), written under
a temporary name and renamed, so processes that build at once never load a
half-written file. A failed build is logged once, as a warning carrying the
compiler's message, and the library counts as unavailable for the process:
:func:`rerank_auto` then runs the numpy copy, and :func:`decode_resize_batch`
/ :func:`decode_resize_multicrop` raise ``RuntimeError`` (the loader falls
back to PIL), as in the JAX package.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np

HERE = Path(__file__).resolve().parent
BUILD_DIR = HERE.parent / "_build" / "native"
_FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", "-fopenmp"]
_LOCK = threading.Lock()
_LIBS: Dict[str, Optional[ctypes.CDLL]] = {}
_log = logging.getLogger("editor_tpu_torch.native")


def _build(source: str, libs: tuple) -> Path:
    """Compile ``source`` (a file beside this module) into a shared library,
    unless the one named by its hash exists; returns its path. Raises
    ``RuntimeError`` with the compiler's stderr on failure."""
    src = HERE / source
    # -march=native: a library built on one host is not another's
    key = " ".join(_FLAGS + list(libs) + [platform.node(), platform.machine()])
    digest = hashlib.sha256(src.read_bytes() + key.encode()).hexdigest()[:16]
    so = BUILD_DIR / f"lib{src.stem}_{digest}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *_FLAGS, str(src), *libs, "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:  # no compiler at all
        raise RuntimeError(f"{' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(cmd)} exited {proc.returncode}:\n{proc.stderr.strip()}")
    os.replace(tmp, so)
    return so


def _load(name: str, source: str, libs: tuple, bind) -> Optional[ctypes.CDLL]:
    """Build (once a process) and load a library, binding its entries with
    ``bind(lib)``; None, with one warning, if that fails."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        try:
            lib = ctypes.CDLL(str(_build(source, libs)))
            bind(lib)
        except (RuntimeError, OSError, AttributeError) as e:
            _log.warning("native %s unavailable: %s", name, e)
            lib = None
        _LIBS[name] = lib
        return lib


def _bind_rerank(lib: ctypes.CDLL) -> None:
    fn = lib.editor_tpu_k_reciprocal_rerank
    fn.argtypes = [
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_float,
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
    ]
    fn.restype = None


def _bind_codec(lib: ctypes.CDLL) -> None:
    fn = lib.editor_tpu_decode_resize_batch
    fn.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
    ]
    fn.restype = ctypes.c_int32
    fn = lib.editor_tpu_decode_multicrop_batch
    fn.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
    ]
    fn.restype = ctypes.c_int32


def load_native() -> Optional[ctypes.CDLL]:
    """The re-ranking library; None if it cannot be built or loaded."""
    return _load("reranking", "reranking.cpp", (), _bind_rerank)


def load_imagecodec() -> Optional[ctypes.CDLL]:
    """The JPEG codec library; None if it cannot be built or loaded (no
    ``g++`` or no libjpeg headers)."""
    return _load("imagecodec", "imagecodec.cpp", ("-ljpeg",), _bind_codec)


def k_reciprocal_rerank_native(prob_feat: np.ndarray, gal_feat: np.ndarray,
                               k1: int = 20, k2: int = 6,
                               lambda_value: float = 0.3) -> np.ndarray:
    """Re-ranking in C++; the numpy version's contract (``evals.reranking``):
    [nq, ng] float32 distances. ``RuntimeError`` if the library is
    unavailable."""
    lib = load_native()
    if lib is None:
        raise RuntimeError("native reranking library unavailable")
    original = original_dist(prob_feat, gal_feat)
    nq, n = prob_feat.shape[0], original.shape[0]
    out = np.empty((nq, n - nq), np.float32)
    lib.editor_tpu_k_reciprocal_rerank(original, n, nq, k1, k2, np.float32(lambda_value), out)
    return out


def original_dist(prob_feat: np.ndarray, gal_feat: np.ndarray) -> np.ndarray:
    """The C++ re-ranking's input: the squared distances among queries and
    gallery, each column divided by its largest, transposed (the
    reference's ``(dist / max(dist, axis=0)).T``), [n, n] float32."""
    feat = np.concatenate([np.asarray(prob_feat, np.float32),
                           np.asarray(gal_feat, np.float32)], axis=0)
    sq = np.sum(feat ** 2, axis=1)
    d = np.maximum(sq[:, None] + sq[None, :] - 2.0 * feat @ feat.T, 0.0)
    return np.ascontiguousarray((d / np.max(d, axis=0, keepdims=True)).T.astype(np.float32))


def rerank_auto(prob_feat, gal_feat, k1=20, k2=6, lambda_value=0.3) -> np.ndarray:
    """The C++ re-ranking if its library is available, else the numpy one."""
    try:
        return k_reciprocal_rerank_native(prob_feat, gal_feat, k1, k2, lambda_value)
    except RuntimeError:
        from editor_tpu_torch.evals.reranking import k_reciprocal_rerank
        return k_reciprocal_rerank(prob_feat, gal_feat, k1, k2, lambda_value)


def _codec() -> ctypes.CDLL:
    lib = load_imagecodec()
    if lib is None:
        raise RuntimeError("native imagecodec unavailable")
    return lib


def decode_resize_batch(paths, out_hw, crop_x0=None, crop_w: int = 0,
                        crop_h: int = 0) -> np.ndarray:
    """Decode ``paths`` (JPEGs) and bicubic-resize each to ``out_hw`` = (H, W)
    in parallel (OpenMP): u8 [n, H, W, 3]. ``crop_w > 0`` first crops
    [crop_x0[i], +crop_w) x [0, crop_h) (the wide-JPEG modality tiling,
    reference bases.py:21-26). ``RuntimeError`` if the library is unavailable
    or any decode fails."""
    lib = _codec()
    h, w = out_hw
    n = len(paths)
    out = np.empty((n, h, w, 3), np.uint8)
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    cx_ptr = None
    if crop_x0 is not None:
        cx = np.ascontiguousarray(np.asarray(crop_x0, np.int32))
        cx_ptr = cx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    failures = lib.editor_tpu_decode_resize_batch(arr, n, cx_ptr, int(crop_w), int(crop_h),
                                                  h, w, out)
    if failures:
        raise RuntimeError(f"{failures}/{n} decodes failed")
    return out


def decode_resize_multicrop(paths, out_hw, crop_x0, crop_w: int, crop_h: int) -> np.ndarray:
    """Decode each JPEG of ``paths`` once and emit ``k`` crops of it
    (``crop_x0`` [n, k] tile origins, each [x0, x0 + crop_w) x [0, crop_h)),
    bicubic-resized to ``out_hw``: u8 [n * k, H, W, 3], image-major."""
    lib = _codec()
    h, w = out_hw
    cx = np.ascontiguousarray(np.asarray(crop_x0, np.int32))
    n, k = cx.shape
    out = np.empty((n * k, h, w, 3), np.uint8)
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    failures = lib.editor_tpu_decode_multicrop_batch(
        arr, n, k, cx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), int(crop_w), int(crop_h),
        h, w, out)
    if failures:
        raise RuntimeError(f"{failures}/{n * k} decodes failed")
    return out
