"""K5 (``masked_attention_qkv_bwd``): its plain version against the TPU kernel
body, with a check that can tell the body's rounding.

The CUDA kernel (the instance without cls keys of the tensor-core backward
``csrc/attention_bwd_mma.cuh`` that K4 and K7 share) rounds where the TPU
kernel ``_qkv_masked_full_bwd_kernel`` does: the fill added to the logits,
every key's attn and dl rounded to bf16 before the products. On the card it
is held to its plain version, ``masked_attention_qkv_bwd_plain``, by the
share of elements more than one bf16 ulp away (``_bench.bf16_off_share``, at
most 0.5% over all of dqkv and over the dk and dv of the rows m % 88 == 0;
chip_smoke phase 2). Here, on the CPU, the same function holds the plain
version to the TPU body itself, run through ``pl.pallas_call(...,
interpret=True)`` with ``_pallas_masked_full_bwd``'s BlockSpecs and group
size on the same bf16 inputs (0-0.002% of all elements off, 0-0.011% of
the rows m % 88 == 0), and shows that the check fails the two wrong forms it
exists to catch:

* the unrounded form (the plain version on fp32 inputs, rounded once):
  4.1-4.9% of all elements off at these shapes;
* the cls-kept form (K7's, ``masked_attention_tiled_bwd_plain`` with tile
  88, which K7's launcher would take at N = 88 and 264: the keys m % 88 == 0
  in fp32): 7.4-9.4% of those rows' dk and dv off, while over all elements
  it is off in only 0.16-0.23%, under the limit.
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
CLS = 88  # chip_smoke.K5_CLS_ROWS: the compact tail's cls tokens
SHARE_TOL = 0.005  # chip_smoke.SHARE_TOL
# (N, H, D): the compact tail's per-modality and joint token counts at a
# narrow width and at the flagship's heads
SHAPES = [(88, 2, 16), (264, 2, 16), (88, 12, 64), (264, 12, 64)]


@functools.lru_cache(maxsize=None)
def _case(N, H, D):
    """Seeded bf16 inputs (qkv, mask, g as torch tensors) and the TPU body's
    dqkv on them (fp32 torch). Masks: rand < 0.5 with every cls token (m %
    88 == 0) kept and sequence 0 masked but for its cls token."""
    C = H * D
    rng = np.random.RandomState(N + H)
    jq, tq = _bf16(rng.randn(B, N, 3 * C))
    jg, tg = _bf16(rng.randn(B, N, C))
    m = rng.rand(B, N) < 0.5
    m[:, ::CLS] = True
    m[0, 1:] = False
    mask = m.astype(np.float32)
    ref = _tpu_body(jq, jnp.asarray(mask), jg, N, H, D)
    return tq, torch.from_numpy(mask), tg, torch.from_numpy(ref)


def _tpu_body(qkv, mask, g, N, H, D):
    """``_qkv_masked_full_bwd_kernel`` in Pallas interpret mode with the
    BlockSpecs and group size of ``_pallas_masked_full_bwd``."""
    import jax.experimental.pallas as pl

    C = H * D
    grp = jax_ma._full_group(N, B, bwd=True)
    fn = functools.partial(jax_ma._qkv_masked_full_bwd_kernel, scale=D ** -0.5, H=H, D=D,
                           fill=FILL)
    out = pl.pallas_call(
        fn, out_shape=jax.ShapeDtypeStruct((B, N, 3 * C), qkv.dtype), grid=(B // grp,),
        in_specs=[pl.BlockSpec((grp, N, 3 * C), lambda i: (i, 0, 0)),
                  pl.BlockSpec((grp, 1, N), lambda i: (i, 0, 0)),
                  pl.BlockSpec((grp, N, C), lambda i: (i, 0, 0))],
        out_specs=pl.BlockSpec((grp, N, 3 * C), lambda i: (i, 0, 0)),
        interpret=True)(qkv, mask.astype(qkv.dtype)[:, None, :], g)
    return np.array(out.astype(jnp.float32))


def _shares(got, ref, C):
    """(share over all of dqkv, share over the dk and dv of the rows m % 88 == 0)."""
    return (_bench.bf16_off_share(got, ref),
            _bench.bf16_off_share(got[:, ::CLS, C:], ref[:, ::CLS, C:]))


@pytest.mark.parametrize("N, H, D", SHAPES)
def test_plain_passes_the_share_tests_against_tpu_body(N, H, D):
    qkv, mask, g, ref = _case(N, H, D)
    got = ops.masked_attention_qkv_bwd_plain(qkv, mask, g, H, D ** -0.5, FILL)
    assert got.dtype == torch.bfloat16
    share, cls = _shares(got, ref, H * D)
    assert share <= SHARE_TOL and cls <= SHARE_TOL, (share, cls)


@pytest.mark.parametrize("N, H, D", SHAPES)
def test_masked_rows_get_exact_zeros(N, H, D):
    """A masked row gets no gradient as a query (dq) nor as a key (dk, dv),
    in the plain version as in the TPU body; sequence 0's only valid key is
    its cls token, whose softmax over one key gives no dq or dk (its dv is
    g of the cls row)."""
    qkv, mask, g, ref = _case(N, H, D)
    got = ops.masked_attention_qkv_bwd_plain(qkv, mask, g, H, D ** -0.5, FILL)
    assert torch.count_nonzero(got[mask == 0]) == 0
    assert torch.count_nonzero(ref[mask == 0]) == 0
    assert torch.count_nonzero(got[0, :, :2 * H * D]) == 0
    assert torch.count_nonzero(got[0, 0, 2 * H * D:]) > 0


@pytest.mark.parametrize("N, H, D", SHAPES)
def test_unrounded_form_fails_the_all_element_test(N, H, D):
    qkv, mask, g, ref = _case(N, H, D)
    unrounded = ops.masked_attention_qkv_bwd_plain(qkv.float(), mask, g.float(), H,
                                                   D ** -0.5, FILL).bfloat16()
    share, _ = _shares(unrounded, ref, H * D)
    assert share > SHARE_TOL, share


@pytest.mark.parametrize("N, H, D", SHAPES)
def test_cls_kept_form_fails_the_cls_row_test(N, H, D):
    """K7's form keeps the keys m % 88 == 0 in fp32: over all elements it is
    within the limit, over those rows' dk and dv far outside it."""
    qkv, mask, g, ref = _case(N, H, D)
    cls_kept = ops.masked_attention_tiled_bwd_plain(qkv, mask, g, H, D ** -0.5, FILL, CLS)
    share, cls = _shares(cls_kept, ref, H * D)
    assert share <= SHARE_TOL < cls, (share, cls)


@pytest.mark.parametrize("D, ok", [(16, True), (32, True), (48, True), (64, True),
                                   (96, True), (128, True), (8, False), (72, False),
                                   (144, False)])
def test_kernel_head_dim_check(D, ok):
    """The 4-warp tensor-core kernel takes every head dim that is a multiple
    of 16 up to 128; the wrapper refuses the others before any launch."""
    if ok:
        port_ma.check_k5_head_dim(D)
    else:
        with pytest.raises(ValueError, match=f"^masked_attention_qkv_bwd: head dim {D} is not "
                                             "a multiple of 16 up to 128$"):
            port_ma.check_k5_head_dim(D)


def test_cpu_wrapper_runs_the_plain_version():
    """On a CPU tensor the wrapper runs the plain version at any group and
    head dim, and counts no launch."""
    qkv, mask, g, _ = _case(88, 2, 16)
    fn = ops.masked_attention_qkv_bwd
    before = (fn.launches, fn.variant_launches)
    want = ops.masked_attention_qkv_bwd_plain(qkv, mask, g, 2, 0.25, FILL)
    for group in (0, 1, 3, 4):
        assert torch.equal(fn(qkv, mask, g, 2, 0.25, FILL, group=group), want)
    odd = fn(qkv.float()[..., :24], mask, g.float()[..., :8], 2, 0.5, FILL)  # D = 4
    assert odd.shape == (B, 88, 24)
    assert (fn.launches, fn.variant_launches) == before
