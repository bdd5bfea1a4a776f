"""K6 (``masked_attention_tiled``): its plain version against the TPU kernel
body, with a check that can tell the body's rounding.

The CUDA kernel (the kTiled instance of the tensor-core forward
``csrc/attention_fwd_mma.cuh`` that K1 and K3 share) rounds where the TPU
kernel ``_qkv_masked_kernel`` does: the fill added as a bias, a
row-max-stabilised softmax over all keys, the exps of the patch keys rounded
to bf16 before e.v, the exp of each tile's cls key (m % tile == 0) kept in
fp32 and its e.v in fp32, the output scaled by ``mask_q / sum e`` over the
unrounded exps (lazy normalisation). On the card it is held to its plain
version, ``masked_attention_tiled_plain``, by the share of elements more
than one bf16 ulp away (``_bench.bf16_off_share``, at most 0.5%; chip_smoke
phase 2), read twice: over all elements of a batch whose masks keep half the
patches, and over the valid query rows of a sparse batch (every cls token
and a tenth of the patches kept), where the cls keys carry weight. Here, on
the CPU, the same readings hold the plain version to the TPU body itself,
run through ``pl.pallas_call(..., interpret=True)`` with
``_pallas_masked_from_qkv``'s grid and group size on the same bf16 inputs
(0-0.003% of all elements off, 0-0.012% of the sparse batch's valid rows),
and show that the check fails the two wrong forms it exists to catch:

* the unrounded form (the plain version on fp32 inputs, rounded once):
  3.6-5.1% of all elements off at these shapes;
* K3's form (``masked_attention_qkv_tpu_plain``: the cls keys' exps rounded
  too): 0.30-0.55% of all elements of the half-kept batch, about the limit,
  where the exact zeros of the masked rows dilute it, but 1.4-2.4% of the
  valid rows of the sparse batch.

Both are told apart on randn inputs. On the x30 inputs (|logit| ~ 1e3) each
row's softmax is one-hot: the weights are 1 and exact zeros, which round
alike in every form, so the x30 cases hold only the plain version.
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
B = 4
TILE = 129
SHARE_TOL = 0.005  # chip_smoke.SHARE_TOL
# (N, H, D): the uncompacted tail's one, two and three tiles at a narrow
# width, and one and three at the flagship's heads
SHAPES = [(129, 2, 16), (258, 2, 16), (387, 2, 16), (129, 12, 64), (387, 12, 64)]


def _mask(rng, N, keep):
    """[B, N] float32: patches kept with probability ``keep``, every cls token
    kept, and sequence 0's first tile masked but for its cls token."""
    m = rng.rand(B, N) < keep
    m[:, ::TILE] = True
    m[0, 1:TILE] = False
    return m.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _case(N, H, D, mul, keep):
    """Seeded bf16 inputs (qkv, mask as torch tensors) and the TPU body's
    output on them (fp32 torch)."""
    rng = np.random.RandomState(N + H + int(100 * keep))
    jq, tq = _bf16(rng.randn(B, N, 3 * H * D) * mul)
    mask = _mask(rng, N, keep)
    ref = _tpu_body(jq, jnp.asarray(mask), N, H, D)
    return tq, torch.from_numpy(mask), torch.from_numpy(ref)


def _tpu_body(qkv, mask, N, H, D):
    """``_qkv_masked_kernel`` in Pallas interpret mode with the grid and group
    size of ``_pallas_masked_from_qkv``."""
    import jax.experimental.pallas as pl

    C = H * D
    g = 4 if N <= 192 else 1
    while B % g:
        g //= 2
    fn = functools.partial(jax_ma._qkv_masked_kernel, scale=D ** -0.5, H=H, D=D, fill=FILL,
                           tile=TILE, n_tiles=N // TILE)
    out = pl.pallas_call(
        fn, out_shape=jax.ShapeDtypeStruct((B, N, C), qkv.dtype), grid=(B // g,),
        in_specs=[pl.BlockSpec((g, N, 3 * C), lambda i: (i, 0, 0)),
                  pl.BlockSpec((g, 1, N), lambda i: (i, 0, 0))],
        out_specs=pl.BlockSpec((g, N, C), lambda i: (i, 0, 0)),
        interpret=True)(qkv, mask.astype(qkv.dtype)[:, None, :])
    return np.array(out.astype(jnp.float32))


def _valid_share(got, ref, mask):
    """The share test over the valid query rows only."""
    rows = mask.bool()
    return _bench.bf16_off_share(got[rows], ref[rows])


@pytest.mark.parametrize("mul", [1.0, 30.0], ids=["randn", "x30"])
@pytest.mark.parametrize("N, H, D", SHAPES)
def test_plain_passes_both_readings_against_tpu_body(N, H, D, mul):
    for keep, reading in ((0.5, "all"), (0.1, "valid")):
        qkv, mask, ref = _case(N, H, D, mul, keep)
        got = ops.masked_attention_tiled_plain(qkv, mask, H, D ** -0.5, FILL, TILE)
        assert got.dtype == torch.bfloat16
        share = (_bench.bf16_off_share(got, ref) if reading == "all"
                 else _valid_share(got, ref, mask))
        assert share <= SHARE_TOL, (reading, share)
        assert torch.count_nonzero(got[mask == 0]) == 0


@pytest.mark.parametrize("N, H, D", SHAPES)
def test_unrounded_form_fails_the_share_test(N, H, D):
    qkv, mask, ref = _case(N, H, D, 1.0, 0.5)
    unrounded = ops.masked_attention_tiled_plain(qkv.float(), mask, H, D ** -0.5, FILL,
                                                 TILE).bfloat16()
    share = _bench.bf16_off_share(unrounded, ref)
    assert share > SHARE_TOL, share


@pytest.mark.parametrize("N, H, D", SHAPES)
def test_k3_form_fails_the_sparse_reading(N, H, D):
    """K3's form rounds the cls keys' exps too: on the valid rows of the
    sparse batch, where the cls keys carry weight, farther from the TPU body
    than the limit."""
    qkv, mask, ref = _case(N, H, D, 1.0, 0.1)
    k3_form = ops.masked_attention_qkv_tpu_plain(qkv, mask, H, D ** -0.5, FILL)
    share = _valid_share(k3_form, ref, mask)
    assert share > SHARE_TOL, share


@pytest.mark.parametrize("D, tile, ok", [(16, 129, True), (32, 129, True), (64, 129, True),
                                         (96, 16, True), (128, 64, True), (64, 16, True),
                                         (64, 15, False), (64, 11, False), (8, 129, False),
                                         (72, 129, False), (144, 129, False)])
def test_kernel_shape_check(D, tile, ok):
    """The tensor-core kernel takes every head dim that is a multiple of 16 up
    to 128 and tiles of at least 16 tokens (those K7 takes); the wrapper
    refuses the others, with a message, before any launch."""
    if ok:
        port_ma.check_k6_shape(D, tile)
    else:
        with pytest.raises(ValueError, match="head dim|tile"):
            port_ma.check_k6_shape(D, tile)


def test_cpu_wrapper_runs_the_plain_version():
    """On a CPU tensor the wrapper runs the plain version at every group of
    the JAX sweep (and 0, the model path's), at any tile and head dim, and
    counts no launch."""
    qkv, mask, _ = _case(129, 2, 16, 1.0, 0.5)
    fn = ops.masked_attention_tiled
    before = (fn.launches, fn.variant_launches)
    want = ops.masked_attention_tiled_plain(qkv, mask, 2, 0.25, FILL, TILE)
    for group in (0, 1, 2, 4, 8):
        assert torch.equal(fn(qkv, mask, 2, 0.25, FILL, TILE, group=group), want)
    small = fn(qkv[:, :11], mask[:, :11], 2, 0.25, FILL, 11)  # a tile of 11
    assert torch.equal(small, ops.masked_attention_tiled_plain(qkv[:, :11], mask[:, :11], 2,
                                                               0.25, FILL, 11))
    odd = fn(qkv.float()[..., :24], mask, 2, 0.5, FILL, TILE)  # D = 4
    assert odd.shape == (B, 129, 8)
    assert (fn.launches, fn.variant_launches) == before
