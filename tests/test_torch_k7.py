"""K7 (``masked_attention_tiled_bwd``): its plain version against the TPU
kernel body, with a check that can tell the body's rounding.

The CUDA kernel ``csrc/masked_attention_bwd.cu`` rounds where the TPU kernel
``_qkv_masked_bwd_kernel`` does: the patch keys' attn and dl to bf16 before
the products, each tile's cls key (m % tile == 0) in fp32. On the card it is
held to its plain version, ``masked_attention_tiled_bwd_plain``, by the share
of elements more than one bf16 ulp away (``_bench.bf16_off_share``, at most
0.5%; chip_smoke phase 2). Here, on the CPU, the same function holds the
plain version to the TPU body itself, run through
``pl.pallas_call(..., interpret=True)`` with ``_pallas_masked_qkv_bwd``'s
BlockSpecs on the same bf16 inputs, and shows that the check fails the two
wrong forms it exists to catch:

* the unrounded form (the plain version on fp32 inputs, rounded once):
  4.6-5.7% of all elements off at these shapes;
* the cls-rounded form (K5's, ``masked_attention_qkv_bwd_plain``: every
  weight rounded): 7-13% of the cls rows' dk and dv off, while over all
  elements it is off in only 0.1-0.2%, under the limit.

The plain version is off the TPU body in at most 0.002% of the elements.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from editor_tpu_torch import ops
from editor_tpu_torch.ops import masked_attention as port_ma
from editor_tpu_torch.tools import _bench
from tests.torch_parity import bf16_pair as _bf16

jax_ma = importlib.import_module("editor_tpu.ops.masked_attention")

FILL = -65504.0
TILE = 129
B = 4
SHARE_TOL = 0.005  # chip_smoke.SHARE_TOL
# (N, H, D): 1, 2 and 3 modality tiles at a narrow width, and the flagship's heads
SHAPES = [(129, 2, 16), (258, 2, 16), (387, 2, 16), (129, 12, 64)]


@functools.lru_cache(maxsize=None)
def _case(N, H, D):
    """Seeded bf16 inputs (qkv, mask, g as torch tensors) and the TPU body's
    dqkv on them (fp32 numpy). Masks: rand < 0.5 with every cls key kept and
    sequence 0's first tile masked but for its cls token."""
    C = H * D
    rng = np.random.RandomState(N + H)
    jq, tq = _bf16(rng.randn(B, N, 3 * C))
    jg, tg = _bf16(rng.randn(B, N, C))
    m = rng.rand(B, N) < 0.5
    m[:, ::TILE] = True
    m[0, 1:TILE] = False
    mask = m.astype(np.float32)
    ref = _tpu_body(jq, jnp.asarray(mask), jg, N, H, D)
    return tq, torch.from_numpy(mask), tg, torch.from_numpy(ref)


def _tpu_body(qkv, mask, g, N, H, D):
    """``_qkv_masked_bwd_kernel`` in Pallas interpret mode with the BlockSpecs
    of ``_pallas_masked_qkv_bwd`` (one sequence per grid step)."""
    import jax.experimental.pallas as pl

    C = H * D
    fn = functools.partial(jax_ma._qkv_masked_bwd_kernel, scale=D ** -0.5, H=H, D=D,
                           fill=FILL, tile=TILE, n_tiles=N // TILE)
    out = pl.pallas_call(
        fn, out_shape=jax.ShapeDtypeStruct((B, N, 3 * C), qkv.dtype), grid=(B,),
        in_specs=[pl.BlockSpec((1, N, 3 * C), lambda i: (i, 0, 0)),
                  pl.BlockSpec((1, 1, N), lambda i: (i, 0, 0)),
                  pl.BlockSpec((1, N, C), lambda i: (i, 0, 0))],
        out_specs=pl.BlockSpec((1, N, 3 * C), lambda i: (i, 0, 0)),
        interpret=True)(qkv, mask.astype(qkv.dtype)[:, None, :], g)
    return np.array(out.astype(jnp.float32))


def _shares(got, ref, C):
    """(share over all of dqkv, share over the cls rows' dk and dv)."""
    return (_bench.bf16_off_share(got, ref),
            _bench.bf16_off_share(got[:, ::TILE, C:], ref[:, ::TILE, C:]))


@pytest.mark.parametrize("N, H, D", SHAPES)
def test_plain_passes_the_share_tests_against_tpu_body(N, H, D):
    qkv, mask, g, ref = _case(N, H, D)
    got = ops.masked_attention_tiled_bwd_plain(qkv, mask, g, H, D ** -0.5, FILL, TILE)
    assert got.dtype == torch.bfloat16
    share, cls = _shares(got, ref, H * D)
    assert share <= SHARE_TOL and cls <= SHARE_TOL, (share, cls)


@pytest.mark.parametrize("N, H, D", SHAPES)
def test_unrounded_form_fails_the_all_element_test(N, H, D):
    qkv, mask, g, ref = _case(N, H, D)
    unrounded = ops.masked_attention_tiled_bwd_plain(qkv.float(), mask, g.float(), H,
                                                     D ** -0.5, FILL, TILE).bfloat16()
    share, _ = _shares(unrounded, ref, H * D)
    assert share > SHARE_TOL, share


@pytest.mark.parametrize("N, H, D", SHAPES)
def test_cls_rounded_form_fails_the_cls_row_test(N, H, D):
    """K5's form rounds the cls keys' weights too: over all elements it is
    within the limit, over the cls rows' dk and dv far outside it."""
    qkv, mask, g, ref = _case(N, H, D)
    cls_rounded = ops.masked_attention_qkv_bwd_plain(qkv, mask, g, H, D ** -0.5, FILL)
    share, cls = _shares(cls_rounded, ref, H * D)
    assert share <= SHARE_TOL < cls, (share, cls)


def test_bf16_off_share():
    ref = torch.tensor([1.0, 1.0, 0.5, -2.0, 0.0, 1e-3])
    # 1 + one ulp is within, 1 + two ulps is not; 0.5 + one ulp of 1 is
    # two ulps of 0.5; at 0 the 1e-6 of the max (2e-6) is the tolerance
    got = torch.tensor([1.0 + 2.0 ** -7, 1.0 + 2.0 ** -6, 0.5 + 2.0 ** -7, -2.0, 1e-6, 1e-3])
    assert _bench.bf16_off_share(got, ref) == pytest.approx(2 / 6)
    assert _bench.bf16_off_share(ref, ref) == 0.0


@pytest.mark.parametrize("D, tile, ok", [
    (16, 129, True), (32, 129, True), (64, 129, True), (96, 129, True), (128, 129, True),
    (64, 16, True), (8, 129, False), (72, 129, False), (144, 129, False), (64, 9, False)])
def test_kernel_shape_check(D, tile, ok):
    """The CUDA kernel takes every head dim that is a multiple of 16 up to 128
    and tiles of at least 16 tokens; the wrapper refuses the others before
    any launch."""
    if ok:
        port_ma.check_k7_shape(D, tile)
    else:
        with pytest.raises(ValueError, match="head dim|tile"):
            port_ma.check_k7_shape(D, tile)


@pytest.mark.parametrize("N, stride", [(129, 144), (258, 272), (387, 400), (17, 32), (16, 16)])
def test_scratch_stride(N, stride):
    """The scratch rows start 32-byte aligned and hold the padded keys."""
    assert port_ma.k7_scratch_stride(N) == stride


def test_cpu_wrapper_runs_the_plain_version():
    """On a CPU tensor the wrapper runs the plain version, any head dim, and
    counts no launch."""
    qkv, mask, g, _ = _case(129, 2, 16)
    before = ops.masked_attention_tiled_bwd.launches
    got = ops.masked_attention_tiled_bwd(qkv, mask, g, 2, 0.25, FILL, TILE)
    want = ops.masked_attention_tiled_bwd_plain(qkv, mask, g, 2, 0.25, FILL, TILE)
    assert torch.equal(got, want)
    odd = ops.masked_attention_tiled_bwd(qkv.float()[..., :24], mask, g.float()[..., :8], 2,
                                         0.5, FILL, TILE)  # D = 4: plain on the CPU
    assert odd.shape == (B, 129, 24)
    assert ops.masked_attention_tiled_bwd.launches == before
