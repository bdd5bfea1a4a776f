"""K4 (``attention_qkv_bwd``): its plain version against the TPU kernel body,
with a check that can tell the body's rounding.

The CUDA kernel ``csrc/attention_qkv_bwd.cu`` (the unmasked instance of the
tensor-core body in ``csrc/attention_bwd_mma.cuh``) rounds where the TPU
kernel ``_qkv_bwd_kernel`` does: the patch keys' p and dl to bf16 before the
products, the cls key's (m = 0) in fp32. On the card it is held to its plain
version, ``attention_qkv_bwd_plain``, by the share of elements more than one
bf16 ulp away (``_bench.bf16_off_share``, at most 0.5%; chip_smoke phase 2).
Here, on the CPU, the same function holds the plain version to the TPU body
itself, run through ``pl.pallas_call(..., interpret=True)`` with
``_pallas_attention_qkv_bwd``'s grid and BlockSpecs on the same bf16 inputs,
and shows that the check fails the two wrong forms it exists to catch:

* the unrounded form (the plain version on fp32 inputs, rounded once):
  10-13% of all elements off at these shapes;
* the cls-rounded form (K5's, ``masked_attention_qkv_bwd_plain`` with an
  all-ones mask: every weight rounded): 10-14% of the cls row's dk and dv
  off.

The plain version is off the TPU body in at most 0.01% of the elements,
none of the cls row's dk and dv. At x30 (|logit| ~ 1e3) the softmax is
nearly one-hot and the wrong forms are as close as the plain one, so they
are held on randn inputs only.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from editor_tpu_torch import ops
from editor_tpu_torch.ops import fused_attention as port_fa
from editor_tpu_torch.tools import _bench
from tests.torch_parity import bf16_pair as _bf16

jax_fa = importlib.import_module("editor_tpu.ops.fused_attention")

B = 8  # two grid steps of _pick_group(8, 4) = 4 sequences
SHARE_TOL = 0.005  # chip_smoke.SHARE_TOL
# (N, H, D): the model's 129 tokens at a narrow width and at the flagship's
# heads; fewer than one 16-key tile of patch keys past the cls key; past the
# resident instance's 144 keys; the most tokens at the widest head
SHAPES = [(129, 2, 16), (129, 12, 64), (17, 2, 16), (200, 2, 16), (512, 1, 128)]


@functools.lru_cache(maxsize=None)
def _case(N, H, D, mul=1.0):
    """Seeded bf16 inputs (qkv x ``mul``, g; torch tensors) and the TPU
    body's dqkv on them (fp32 torch)."""
    C = H * D
    rng = np.random.RandomState(N + H)
    jq, tq = _bf16(rng.randn(B, N, 3 * C) * mul)
    jg, tg = _bf16(rng.randn(B, N, C))
    return tq, tg, torch.from_numpy(_tpu_body(jq, jg, N, H, D))


def _tpu_body(qkv, g, N, H, D):
    """``_qkv_bwd_kernel`` in Pallas interpret mode with the grid and
    BlockSpecs of ``_pallas_attention_qkv_bwd`` (g sequences per step)."""
    import jax.experimental.pallas as pl

    C = H * D
    gs = jax_fa._pick_group(B, 4)
    fn = functools.partial(jax_fa._qkv_bwd_kernel, scale=D ** -0.5, H=H, D=D)
    out = pl.pallas_call(
        fn, out_shape=jax.ShapeDtypeStruct((B, N, 3 * C), qkv.dtype), grid=(B // gs,),
        in_specs=[pl.BlockSpec((gs, N, 3 * C), lambda i: (i, 0, 0)),
                  pl.BlockSpec((gs, N, C), lambda i: (i, 0, 0))],
        out_specs=pl.BlockSpec((gs, N, 3 * C), lambda i: (i, 0, 0)),
        interpret=True)(qkv, g)
    return np.array(out.astype(jnp.float32))


def _shares(got, ref, C):
    """(share over all of dqkv, share over the cls row's dk and dv)."""
    return (_bench.bf16_off_share(got, ref),
            _bench.bf16_off_share(got[:, 0, C:], ref[:, 0, C:]))


@pytest.mark.parametrize("N, H, D, mul", [s + (1.0,) for s in SHAPES] + [(129, 2, 16, 30.0)])
def test_plain_passes_the_share_tests_against_tpu_body(N, H, D, mul):
    """Also at x30 (|logit| ~ 1e3), where the softmax is nearly one-hot."""
    qkv, g, ref = _case(N, H, D, mul)
    got = ops.attention_qkv_bwd_plain(qkv, g, H, D ** -0.5)
    assert got.dtype == torch.bfloat16
    share, cls = _shares(got, ref, H * D)
    assert share <= SHARE_TOL and cls <= SHARE_TOL, (share, cls)


@pytest.mark.parametrize("N, H, D", SHAPES)
def test_unrounded_form_fails_the_all_element_test(N, H, D):
    qkv, g, ref = _case(N, H, D)
    unrounded = ops.attention_qkv_bwd_plain(qkv.float(), g.float(), H,
                                            D ** -0.5).bfloat16()
    share, _ = _shares(unrounded, ref, H * D)
    assert share > SHARE_TOL, share


@pytest.mark.parametrize("N, H, D", SHAPES)
def test_cls_rounded_form_fails_the_cls_row_test(N, H, D):
    """K5's form rounds the cls key's weights too; its cls row's dk and dv
    are far outside the limit."""
    qkv, g, ref = _case(N, H, D)
    cls_rounded = ops.masked_attention_qkv_bwd_plain(qkv, torch.ones(B, N), g, H, D ** -0.5)
    _, cls = _shares(cls_rounded, ref, H * D)
    assert cls > SHARE_TOL, cls


@pytest.mark.parametrize("D", [8, 16, 32, 48, 64, 72, 80, 96, 112, 128, 144])
def test_head_dims_as_k1(D):
    """The CUDA kernel takes the head dims K1 takes (multiples of 16 up to
    128); a refused head dim raises the same way in both checks."""
    if D % 16 == 0 and D <= 128:
        port_fa.check_k1_head_dim(D)
        port_fa.check_k4_head_dim(D)
    else:
        for name, check in (("attention_qkv", port_fa.check_k1_head_dim),
                            ("attention_qkv_bwd", port_fa.check_k4_head_dim)):
            with pytest.raises(ValueError,
                               match=f"^{name}: head dim {D} is not a multiple of 16 up to 128$"):
                check(D)


@pytest.mark.parametrize("N", [1, 17, 129, 200, 512])
@pytest.mark.parametrize("D", [16, 64, 96, 128])
def test_cpu_wrappers_run_plain_versions(N, D):
    """On a CPU tensor both wrappers run their plain versions, here at shapes
    K1 takes, and count no launch. (That the CUDA kernel takes every such
    shape, N = 512 at D = 128 included, chip_smoke phase 2 shows on the
    card.)"""
    rng = np.random.RandomState(N + D)
    qkv = torch.from_numpy(rng.randn(1, N, 3 * D)).bfloat16()
    g = torch.from_numpy(rng.randn(1, N, D)).bfloat16()
    before = (ops.attention_qkv.launches, ops.attention_qkv_bwd.launches)
    out, _ = ops.attention_qkv(qkv, 1, D ** -0.5)
    assert out.shape == (1, N, D)
    got = ops.attention_qkv_bwd(qkv, g, 1, D ** -0.5)
    assert torch.equal(got, ops.attention_qkv_bwd_plain(qkv, g, 1, D ** -0.5))
    assert (ops.attention_qkv.launches, ops.attention_qkv_bwd.launches) == before


def test_cpu_wrapper_any_head_dim():
    qkv, g, _ = _case(129, 2, 16)
    odd = ops.attention_qkv_bwd(qkv.float()[..., :24], g.float()[..., :8], 2, 0.5)
    assert odd.shape == (B, 129, 24)  # D = 4: plain on the CPU
    assert torch.equal(odd, ops.attention_qkv_bwd_plain(qkv.float()[..., :24],
                                                         g.float()[..., :8], 2, 0.5))
