"""2D/1D discrete wavelet transforms as grouped convolutions.

Counterpart of ``editor_tpu/ops/wavelets.py`` (the vendored
``pytorch_wavelets`` DWT re-designed): analysis is a grouped strided
correlation with the reversed decomposition filters (``F.conv2d``), synthesis
an input-dilated correlation with the reversed reconstruction filters
(``F.conv_transpose2d``, which is exactly that). Padding modes: zero,
symmetric, reflect, periodization.

Layout is NHWC, as in the JAX package; a level's bands are stacked on a new
trailing axis in the order ``(detail_H, detail_W, detail_diag)``. For
``haar`` + ``zero`` on even extents the filter bank is a pairwise
average/difference, computed as a reshape and sums (the Haar fast path).

The JAX package runs these as XLA convolutions at ``Precision.HIGHEST``; no
TPU kernel is involved, so the port uses plain PyTorch convolutions. Their
precision is set explicitly: every convolution here runs with cuDNN's TF32
switched off (:func:`_ieee_fp32`), so an fp32 transform on the card is fp32
throughout; a reconstruction near 0 is what the frequency mask reads the sign
of, and TF32's 10-bit mantissa would move it.

Filter coefficients are the standard public Daubechies/symlet/coiflet and
biorthogonal values (this module's own copy of the JAX package's tables).
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

SQRT2_INV = 1.0 / math.sqrt(2.0)

# scaling (rec_lo) filters; everything else derived by QMF relations
_REC_LO: Dict[str, List[float]] = {
    "haar": [SQRT2_INV, SQRT2_INV],
    "db1": [SQRT2_INV, SQRT2_INV],
    "db2": [0.48296291314469025, 0.836516303737469,
            0.22414386804185735, -0.12940952255092145],
    "db3": [0.3326705529509569, 0.8068915093133388, 0.4598775021193313,
            -0.13501102001039084, -0.08544127388224149, 0.035226291882100656],
    "db4": [0.23037781330885523, 0.7148465705525415, 0.6308807679295904,
            -0.02798376941698385, -0.18703481171888114, 0.030841381835986965,
            0.032883011666982945, -0.010597401784997278],
    "sym2": [0.48296291314469025, 0.836516303737469,
             0.22414386804185735, -0.12940952255092145],
    "sym4": [0.03222310060404270, -0.012603967262037833, -0.09921954357684722,
             0.29785779560527736, 0.8037387518059161, 0.49761866763201545,
             -0.02963552764599851, -0.07576571478927333],
    # coiflets (Daubechies, "Ten Lectures", table 8.1)
    "coif1": [-0.01565572813546454, -0.0727326195128539, 0.38486484686420286,
              0.8525720202122554, 0.3378976624578092, -0.0727326195128539],
    "coif2": [-0.000720549445364512, -0.0018232088707029932,
              0.0056114348193944995, 0.023680171946334084,
              -0.0594344186464569, -0.0764885990783064, 0.41700518442169254,
              0.8127236354455423, 0.3861100668211622, -0.06737255472196302,
              -0.04146493678175915, 0.016387336463522112],
}

# biorthogonal families as (dec_lo, rec_lo) in the pywt zero-padded layout;
# dec_hi[n] = (-1)^(n+1) rec_lo[n], rec_hi[n] = (-1)^n dec_lo[n]. bior2.2 is
# the LeGall/CDF 5/3 pair and bior4.4 the CDF 9/7 pair, both x sqrt(2)
_S2 = math.sqrt(2.0)
_BIOR: Dict[str, Tuple[List[float], List[float]]] = {
    "bior1.1": ([SQRT2_INV, SQRT2_INV], [SQRT2_INV, SQRT2_INV]),
    "bior1.3": ([-1 / (8 * _S2), 1 / (8 * _S2), SQRT2_INV, SQRT2_INV,
                 1 / (8 * _S2), -1 / (8 * _S2)],
                [0.0, 0.0, SQRT2_INV, SQRT2_INV, 0.0, 0.0]),
    "bior2.2": ([0.0, -0.125 * _S2, 0.25 * _S2, 0.75 * _S2, 0.25 * _S2,
                 -0.125 * _S2],
                [0.0, 0.25 * _S2, 0.5 * _S2, 0.25 * _S2, 0.0, 0.0]),
    "bior4.4": ([0.0,
                 0.026748757410810106 * _S2, -0.01686411844287467 * _S2,
                 -0.07822326652899052 * _S2, 0.2668641184428749 * _S2,
                 0.6029490182363593 * _S2, 0.2668641184428749 * _S2,
                 -0.07822326652899052 * _S2, -0.01686411844287467 * _S2,
                 0.026748757410810106 * _S2],
                [0.0,
                 -0.045635881557125636 * _S2, -0.028771763114250094 * _S2,
                 0.2956358815571257 * _S2, 0.5575435262285023 * _S2,
                 0.2956358815571257 * _S2, -0.028771763114250094 * _S2,
                 -0.045635881557125636 * _S2, 0.0, 0.0]),
}


def daubechies_rec_lo(N: int) -> np.ndarray:
    """The order-N Daubechies scaling filter (2N taps) by spectral
    factorization: the roots of P(y) = sum_{k<N} C(N-1+k, k) y^k mapped to
    z, the |z| < 1 ones (minimum phase) against the ((1+z)/2)^N factor,
    normalised to sum sqrt(2)."""
    if N < 1:
        raise ValueError("db order must be >= 1")
    if N == 1:
        return np.asarray([SQRT2_INV, SQRT2_INV])
    P = np.asarray([math.comb(N - 1 + k, k) for k in range(N)], np.float64)[::-1]
    zroots = []
    for y in np.roots(P):
        # y = (2 - z - 1/z)/4  =>  z^2 - (2 - 4y) z + 1 = 0
        b = 2.0 - 4.0 * y
        disc = np.sqrt(b * b - 4.0 + 0j)
        for z in ((b + disc) / 2.0, (b - disc) / 2.0):
            if abs(z) < 1.0 - 1e-12:
                zroots.append(z)
    h = np.asarray([1.0 + 0j])
    for _ in range(N):
        h = np.convolve(h, [0.5, 0.5])
    for z in zroots:
        h = np.convolve(h, [1.0, -z])
    h = np.real(h)
    h *= math.sqrt(2.0) / h.sum()
    if abs(h[0]) < abs(h[-1]):  # the standard order: the larger end first
        h = h[::-1]
    return h.copy()


def wavelet_filters(wave) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(dec_lo, dec_hi, rec_lo, rec_hi) float64 arrays (pywt convention).
    ``wave``: an explicit 4-tuple of coefficient arrays, an orthogonal family
    name (haar, db1..db20, sym2, sym4, coif1, coif2) or a biorthogonal one
    (bior1.1, bior1.3, bior2.2, bior4.4)."""
    if isinstance(wave, tuple):
        return tuple(np.asarray(f, np.float64) for f in wave)
    if wave in _BIOR:
        dec_lo = np.asarray(_BIOR[wave][0], np.float64)
        rec_lo = np.asarray(_BIOR[wave][1], np.float64)
        sgn = np.asarray([(-1.0) ** (n + 1) for n in range(len(dec_lo))])
        return dec_lo, sgn * rec_lo, rec_lo, -sgn * dec_lo
    if wave in _REC_LO:
        rec_lo = np.asarray(_REC_LO[wave], dtype=np.float64)
    elif wave.startswith("db") and wave[2:].isdigit() and int(wave[2:]) <= 20:
        rec_lo = daubechies_rec_lo(int(wave[2:]))
    else:
        raise ValueError(
            f"unknown wavelet '{wave}'; have {sorted(_REC_LO)}, "
            f"{sorted(_BIOR)}, db1..db20, or an explicit filter 4-tuple")
    L = len(rec_lo)
    rec_hi = np.array([(-1) ** n * rec_lo[L - 1 - n] for n in range(L)])  # qmf
    return rec_lo[::-1].copy(), rec_hi[::-1].copy(), rec_lo, rec_hi


def dwt_coeff_len(n: int, filt_len: int, mode: str) -> int:
    """pywt.dwt_coeff_len: the coefficient count of one level."""
    if mode in ("per", "periodization"):
        return (n + 1) // 2
    return (n + filt_len - 1) // 2


_TF32_LOCK = threading.Lock()
_TF32_STATE = {"depth": 0, "saved": False}


@contextlib.contextmanager
def _ieee_fp32():
    """cuDNN convolutions in true fp32 (no TF32) inside the block.

    ``torch.backends.cudnn.allow_tf32`` is one flag for the whole process, so
    the blocks of all threads share one switch: the first block to enter
    saves the caller's setting and turns TF32 off, the last to leave restores
    it, whatever order the threads leave in. A cuDNN convolution that another
    thread runs meanwhile runs in full fp32 too (slower, not less exact)."""
    with _TF32_LOCK:
        if _TF32_STATE["depth"] == 0:
            _TF32_STATE["saved"] = torch.backends.cudnn.allow_tf32
            torch.backends.cudnn.allow_tf32 = False
        _TF32_STATE["depth"] += 1
    try:
        yield
    finally:
        with _TF32_LOCK:
            _TF32_STATE["depth"] -= 1
            if _TF32_STATE["depth"] == 0:
                torch.backends.cudnn.allow_tf32 = _TF32_STATE["saved"]


def _taps(f: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(f), dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# 1D filter banks along H or W of an NHWC tensor
# ---------------------------------------------------------------------------

_NP_MODES = {"symmetric": "symmetric", "reflect": "reflect",
             "per": "wrap", "periodization": "wrap", "periodic": "wrap"}


def _pad_axis(x: torch.Tensor, axis: int, before: int, after: int, mode: str) -> torch.Tensor:
    """``jnp.pad`` of one axis: zeros, or the indices numpy's symmetric,
    reflect and wrap modes read (any pad length)."""
    if before == 0 and after == 0:
        return x
    if mode == "zero":
        pads = [0, 0] * (x.dim() - 1 - axis) + [before, after]
        return F.pad(x, pads)
    if mode not in _NP_MODES:
        raise ValueError(f"unknown pad mode '{mode}'")
    idx = np.pad(np.arange(x.shape[axis]), (before, after), mode=_NP_MODES[mode])
    return x.index_select(axis, torch.as_tensor(idx, device=x.device))


def _grouped_conv_axis(x: torch.Tensor, kernels: torch.Tensor, axis: int, stride: int,
                       dilation: int = 1) -> torch.Tensor:
    """Correlate each channel of NHWC ``x`` with the K 1-D ``kernels`` [K, L]
    along ``axis`` (1 = H, 2 = W), VALID, kernel dilated by ``dilation`` (à
    trous). Returns [B, Ho, Wo, C, K]."""
    C = x.shape[3]
    K, L = kernels.shape
    shape = (C * K, 1, L, 1) if axis == 1 else (C * K, 1, 1, L)
    # output channel c * K + k holds channel c correlated with kernel k
    w = kernels[None].expand(C, K, L).reshape(shape)
    s = (stride, 1) if axis == 1 else (1, stride)
    d = (dilation, 1) if axis == 1 else (1, dilation)
    with _ieee_fp32():
        y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=s, dilation=d, groups=C)
    B, _, Ho, Wo = y.shape
    return y.permute(0, 2, 3, 1).reshape(B, Ho, Wo, C, K)


def afb1d(x: torch.Tensor, wave, axis: int, mode: str = "zero"
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """1D analysis bank along ``axis`` (1 = H, 2 = W) of NHWC ``x``:
    (lo, hi), each with the filtered axis halved."""
    dec_lo, dec_hi, _, _ = wavelet_filters(wave)
    L = len(dec_lo)
    N = x.shape[axis]
    kernels = _taps(np.stack([dec_lo[::-1], dec_hi[::-1]]), x)
    if mode in ("per", "periodization"):
        if N % 2 == 1:
            x = torch.cat([x, x.narrow(axis, N - 1, 1)], dim=axis)
            N += 1
        x = torch.roll(x, -(L // 2), dims=axis)
        x = _pad_axis(x, axis, L - 1, L - 1, "zero")
        y = _grouped_conv_axis(x, kernels, axis, stride=2)
        n2, l2 = N // 2, L // 2
        if l2 > 0:
            y = torch.cat([y.narrow(axis, 0, l2) + y.narrow(axis, n2, l2),
                           y.narrow(axis, l2, n2 - l2)], dim=axis)
        y = y.narrow(axis, 0, n2)
    else:
        outsize = dwt_coeff_len(N, L, mode)
        p = 2 * (outsize - 1) - N + L
        if mode == "zero":
            x = _pad_axis(x, axis, p // 2, p // 2 + p % 2, "zero")
        else:
            x = _pad_axis(x, axis, p // 2, (p + 1) // 2, mode)
        y = _grouped_conv_axis(x, kernels, axis, stride=2)
    return y[..., 0], y[..., 1]


def _sfb_conv(x: torch.Tensor, kernel: np.ndarray, axis: int, edge_pad: int) -> torch.Tensor:
    """Dilate by 2, pad by ``edge_pad``, correlate with ``kernel`` [L] along
    ``axis``: ``conv_transpose2d`` at stride 2 with the kernel reversed and
    padding ``L - 1 - edge_pad``."""
    C = x.shape[3]
    L = len(kernel)
    shape = (C, 1, L, 1) if axis == 1 else (C, 1, 1, L)
    w = _taps(kernel[::-1], x).reshape(1, 1, L).expand(C, 1, L).reshape(shape)
    s = (2, 1) if axis == 1 else (1, 2)
    p = (L - 1 - edge_pad, 0) if axis == 1 else (0, L - 1 - edge_pad)
    with _ieee_fp32():
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w, stride=s, padding=p, groups=C)
    return y.permute(0, 2, 3, 1)


def sfb1d(lo: torch.Tensor, hi: torch.Tensor, wave, axis: int, mode: str = "zero"
          ) -> torch.Tensor:
    """1D synthesis bank, the inverse of :func:`afb1d`."""
    _, _, rec_lo, rec_hi = wavelet_filters(wave)
    L = len(rec_lo)
    k_lo, k_hi = rec_lo[::-1], rec_hi[::-1]
    if mode in ("per", "periodization"):
        y = _sfb_conv(lo, k_lo, axis, L - 1) + _sfb_conv(hi, k_hi, axis, L - 1)
        N = 2 * lo.shape[axis]
        if L - 2 > 0:
            y = torch.cat([y.narrow(axis, 0, L - 2) + y.narrow(axis, N, L - 2),
                           y.narrow(axis, L - 2, N - (L - 2))], dim=axis)
        return torch.roll(y.narrow(axis, 0, N), 1 - L // 2, dims=axis)
    return _sfb_conv(lo, k_lo, axis, 1) + _sfb_conv(hi, k_hi, axis, 1)


# ---------------------------------------------------------------------------
# 2D single level
# ---------------------------------------------------------------------------

def afb2d(x: torch.Tensor, wave, mode: str = "zero") -> Tuple[torch.Tensor, torch.Tensor]:
    """One analysis level: (ll, bands [B, h, w, C, 3]) with the bands in the
    order (detail_H, detail_W, detail_diag)."""
    lo_w, hi_w = afb1d(x, wave, axis=2, mode=mode)
    ll, lh = afb1d(lo_w, wave, axis=1, mode=mode)
    hl, hh = afb1d(hi_w, wave, axis=1, mode=mode)
    return ll, torch.stack([lh, hl, hh], dim=-1)


def sfb2d(ll: torch.Tensor, bands: torch.Tensor, wave, mode: str = "zero") -> torch.Tensor:
    """The inverse of :func:`afb2d`; ``ll`` one larger than the bands (an
    odd extent one level up) is cropped first."""
    lh, hl, hh = bands.unbind(-1)
    for ax in (1, 2):
        if ll.shape[ax] > lh.shape[ax]:
            ll = ll.narrow(ax, 0, lh.shape[ax])
    lo_w = sfb1d(ll, lh, wave, axis=1, mode=mode)
    hi_w = sfb1d(hl, hh, wave, axis=1, mode=mode)
    return sfb1d(lo_w, hi_w, wave, axis=2, mode=mode)


# ---------------------------------------------------------------------------
# stationary (undecimated, à trous) transform
# ---------------------------------------------------------------------------

def _afb1d_atrous(x: torch.Tensor, kernels: torch.Tensor, axis: int, mode: str,
                  dilation: int) -> torch.Tensor:
    """1D à trous analysis: pad (L2 - dilation, L2), no downsampling, the
    kernel dilated by ``dilation``."""
    L2 = kernels.shape[1] * dilation // 2
    x = _pad_axis(x, axis, L2 - dilation, L2, mode)
    return _grouped_conv_axis(x, kernels, axis, stride=1, dilation=dilation)


def swt2(x: torch.Tensor, wave="haar", J: int = 1, mode: str = "periodic"
         ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """2D stationary wavelet transform: J levels of ``(ll, bands)``, each the
    full [B, H, W, C] extent (bands [B, H, W, C, 3], the order of
    :func:`wavedec2`); level j's filters are dilated by 2**j and run on the
    previous level's ``ll``. ``mode``: 'periodic' (wrap), 'zero',
    'symmetric' or 'reflect'."""
    dec_lo, dec_hi, _, _ = wavelet_filters(wave)
    kernels = _taps(np.stack([dec_lo[::-1], dec_hi[::-1]]), x)
    ll, out = x, []
    for j in range(J):
        d = 2 ** j
        B, H, W, C = ll.shape
        lohi = _afb1d_atrous(ll, kernels, 2, mode, d)  # [B, H, W, C, 2]
        y = _afb1d_atrous(lohi.reshape(B, H, W, C * 2), kernels, 1, mode, d)
        y = y.reshape(B, H, W, C, 2, 2)  # [..., C, W band, H band]
        ll = y[..., 0, 0]
        out.append((ll, torch.stack([y[..., 0, 1], y[..., 1, 0], y[..., 1, 1]], dim=-1)))
    return out


def _sfb1d_atrous(lo: torch.Tensor, hi: torch.Tensor, wave, axis: int, mode: str,
                  dilation: int) -> torch.Tensor:
    """1D à trous synthesis, the inverse of :func:`_afb1d_atrous`: pad the
    mirror (L2, L2 - d), correlate with the reversed reconstruction filters
    at dilation d and halve the sum of the two bands (the undecimated
    perfect-reconstruction identity G0 H0 + G1 H1 = 2 z^-(L-1))."""
    _, _, rec_lo, rec_hi = wavelet_filters(wave)
    d = dilation
    L2 = len(rec_lo) * d // 2
    k_lo = _taps(rec_lo[::-1], lo).reshape(1, -1)
    k_hi = _taps(rec_hi[::-1], hi).reshape(1, -1)
    lo_p = _pad_axis(lo, axis, L2, L2 - d, mode)
    hi_p = _pad_axis(hi, axis, L2, L2 - d, mode)
    y = (_grouped_conv_axis(lo_p, k_lo, axis, stride=1, dilation=d)[..., 0]
         + _grouped_conv_axis(hi_p, k_hi, axis, stride=1, dilation=d)[..., 0])
    return y * 0.5


def _sfb2d_atrous(ll: torch.Tensor, bands: torch.Tensor, wave, mode: str,
                  dilation: int) -> torch.Tensor:
    lh, hl, hh = bands.unbind(-1)
    lo_w = _sfb1d_atrous(ll, lh, wave, axis=1, mode=mode, dilation=dilation)
    hi_w = _sfb1d_atrous(hl, hh, wave, axis=1, mode=mode, dilation=dilation)
    return _sfb1d_atrous(lo_w, hi_w, wave, axis=2, mode=mode, dilation=dilation)


def iswt2(coeffs: Sequence[Tuple[torch.Tensor, torch.Tensor]], wave="haar",
          mode: str = "periodic") -> torch.Tensor:
    """The inverse of :func:`swt2` from its full J-level list (the deepest
    ``ll`` and every level's bands). Exact for 'periodic'; for zero and
    symmetric a border of L * 2**J pixels is approximate."""
    coeffs = list(coeffs)
    ll = coeffs[-1][0]
    for j in reversed(range(len(coeffs))):
        ll = _sfb2d_atrous(ll, coeffs[j][1], wave, mode, dilation=2 ** j)
    return ll


# ---------------------------------------------------------------------------
# fast Haar path (zero mode, even extents)
# ---------------------------------------------------------------------------

def _haar_afb2d_fast(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    B, H, W, C = x.shape
    x = x.reshape(B, H // 2, 2, W // 2, 2, C)
    a, b = x[:, :, 0, :, 0], x[:, :, 0, :, 1]
    c, d = x[:, :, 1, :, 0], x[:, :, 1, :, 1]
    ll = (a + b + c + d) * 0.5
    lh = (a + b - c - d) * 0.5  # detail along H
    hl = (a - b + c - d) * 0.5  # detail along W
    hh = (a - b - c + d) * 0.5
    return ll, torch.stack([lh, hl, hh], dim=-1)


def _haar_sfb2d_fast(ll: torch.Tensor, bands: torch.Tensor) -> torch.Tensor:
    lh, hl, hh = bands.unbind(-1)
    a = (ll + lh + hl + hh) * 0.5
    b = (ll + lh - hl - hh) * 0.5
    c = (ll - lh + hl - hh) * 0.5
    d = (ll - lh - hl + hh) * 0.5
    B, h, w, C = ll.shape
    y = torch.stack([torch.stack([a, b], dim=3), torch.stack([c, d], dim=3)], dim=2)
    return y.reshape(B, 2 * h, 2 * w, C)  # [B, h, 2 (H), w, 2 (W), C]


def _haar_fast_ok(shape, wave, mode: str) -> bool:
    return (wave in ("haar", "db1") and mode == "zero"
            and shape[1] % 2 == 0 and shape[2] % 2 == 0)


# ---------------------------------------------------------------------------
# multi-level API
# ---------------------------------------------------------------------------

def wavedec2(x: torch.Tensor, wave="haar", J: int = 1, mode: str = "zero"
             ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """J-level 2D DWT of NHWC ``x``: (lowpass, [bands of level 1..J])."""
    highs: List[torch.Tensor] = []
    ll = x
    for _ in range(J):
        if _haar_fast_ok(ll.shape, wave, mode):
            ll, bands = _haar_afb2d_fast(ll)
        else:
            ll, bands = afb2d(ll, wave, mode)
        highs.append(bands)
    return ll, highs


def waverec2(ll: torch.Tensor, highs: Sequence[torch.Tensor], wave="haar",
             mode: str = "zero") -> torch.Tensor:
    """The inverse of :func:`wavedec2`."""
    for bands in reversed(list(highs)):
        if (_haar_fast_ok((0, 2 * bands.shape[1], 2 * bands.shape[2]), wave, mode)
                and ll.shape[1] == bands.shape[1] and ll.shape[2] == bands.shape[2]):
            ll = _haar_sfb2d_fast(ll, bands)
        else:
            ll = sfb2d(ll, bands, wave, mode)
    return ll


def wavedec1(x: torch.Tensor, wave="haar", J: int = 1, mode: str = "zero"
             ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """x [B, N, C] -> (lowpass, [high of level 1..J])."""
    lo = x[:, :, None, :]  # NHWC with W = 1, filtered along H
    highs = []
    for _ in range(J):
        lo, hi = afb1d(lo, wave, axis=1, mode=mode)
        highs.append(hi[:, :, 0, :])
    return lo[:, :, 0, :], highs


def waverec1(lo: torch.Tensor, highs: Sequence[torch.Tensor], wave="haar",
             mode: str = "zero") -> torch.Tensor:
    """The inverse of :func:`wavedec1`."""
    y = lo[:, :, None, :]
    for hi in reversed(list(highs)):
        hiw = hi[:, :, None, :]
        if y.shape[1] > hiw.shape[1]:
            y = y[:, :hiw.shape[1]]
        y = sfb1d(y, hiw, wave, axis=1, mode=mode)
    return y[:, :, 0, :]
