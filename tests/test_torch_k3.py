"""K3 (``masked_attention_qkv``): its plain version in the TPU kernel's form
against the TPU kernel body, with a check that can tell the body's rounding.

The CUDA kernel (the masked instance of ``csrc/attention_fwd_mma.cuh``)
rounds where the TPU kernel ``_qkv_masked_full_kernel`` does: the fill added
as a bias, every row-max-stabilised exp rounded to bf16 before e.v, the
output scaled by ``mask_q / sum e`` over the unrounded exps (lazy
normalisation). On the card it is held to its plain version,
``masked_attention_qkv_tpu_plain``, by the share of elements more than one
bf16 ulp away (``_bench.bf16_off_share``, at most 0.5%; chip_smoke phase 2).
Here, on the CPU, the same function holds the plain version to the TPU body
itself, run through ``pl.pallas_call(..., interpret=True)`` with
``_pallas_masked_full``'s BlockSpecs on the same bf16 inputs (0-0.001% of
the elements off), and shows that the check fails the two wrong forms it
exists to catch:

* the unrounded form (the plain version on fp32 inputs, rounded once):
  3.6-4.3% of the elements off at these shapes;
* the XLA form (``masked_attention_qkv_plain``, the model's CPU path:
  normalised weights, re-masked, then rounded): 5.3-6.3% off.

Both are told apart on randn inputs. On the x30 inputs (|logit| ~ 1e3) each
row's softmax is one-hot: the weights are 1 and exact zeros, which round
alike in every form, so there the wrong forms are within the limit too
(0-0.02%) and the x30 cases hold only the plain version.
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
from tests.torch_parity import assert_close, x64  # noqa: F401
from tests.torch_parity import bf16_pair as _bf16

jax_ma = importlib.import_module("editor_tpu.ops.masked_attention")

FILL = -65504.0
B = 4
SHARE_TOL = 0.005  # chip_smoke.SHARE_TOL
# (N, H, D): the compact tail's per-modality and joint token counts at a
# narrow width and at the flagship's heads
SHAPES = [(88, 2, 16), (264, 2, 16), (88, 12, 64), (264, 12, 64)]


@functools.lru_cache(maxsize=None)
def _case(N, H, D, mul):
    """Seeded bf16 inputs (qkv, mask as torch tensors) and the TPU body's
    output on them (fp32 tensor). Masks: rand < 0.5 with every cls token kept
    and sequence 0 masked but for its cls token."""
    rng = np.random.RandomState(N + H)
    jq, tq = _bf16(rng.randn(B, N, 3 * H * D) * mul)
    m = rng.rand(B, N) < 0.5
    m[:, 0] = True
    m[0, 1:] = False
    mask = m.astype(np.float32)
    ref = _tpu_body(jq, jnp.asarray(mask), N, H, D)
    return tq, torch.from_numpy(mask), torch.from_numpy(ref)


def _tpu_body(qkv, mask, N, H, D):
    """``_qkv_masked_full_kernel`` in Pallas interpret mode with the
    BlockSpecs and group size of ``_pallas_masked_full``."""
    import jax.experimental.pallas as pl

    C = H * D
    g = jax_ma._full_group(N, B)
    fn = functools.partial(jax_ma._qkv_masked_full_kernel, scale=D ** -0.5, H=H, D=D,
                           fill=FILL)
    out = pl.pallas_call(
        fn, out_shape=jax.ShapeDtypeStruct((B, N, C), qkv.dtype), grid=(B // g,),
        in_specs=[pl.BlockSpec((g, N, 3 * C), lambda i: (i, 0, 0)),
                  pl.BlockSpec((g, 1, N), lambda i: (i, 0, 0))],
        out_specs=pl.BlockSpec((g, N, C), lambda i: (i, 0, 0)),
        interpret=True)(qkv, mask.astype(qkv.dtype)[:, None, :])
    return np.array(out.astype(jnp.float32))


@pytest.mark.parametrize("mul", [1.0, 30.0], ids=["randn", "x30"])
@pytest.mark.parametrize("N, H, D", SHAPES)
def test_plain_passes_the_share_test_against_tpu_body(N, H, D, mul):
    qkv, mask, ref = _case(N, H, D, mul)
    got = ops.masked_attention_qkv_tpu_plain(qkv, mask, H, D ** -0.5, FILL)
    assert got.dtype == torch.bfloat16
    share = _bench.bf16_off_share(got, ref)
    assert share <= SHARE_TOL, share
    assert torch.count_nonzero(got[mask == 0]) == 0


@pytest.mark.parametrize("N, H, D", SHAPES)
def test_unrounded_form_fails_the_share_test(N, H, D):
    qkv, mask, ref = _case(N, H, D, 1.0)
    unrounded = ops.masked_attention_qkv_tpu_plain(qkv.float(), mask, H, D ** -0.5,
                                                   FILL).bfloat16()
    share = _bench.bf16_off_share(unrounded, ref)
    assert share > SHARE_TOL, share


@pytest.mark.parametrize("N, H, D", SHAPES)
def test_xla_form_fails_the_share_test(N, H, D):
    """The model's CPU path rounds the normalised, re-masked weights: farther
    from the TPU body than the limit."""
    qkv, mask, ref = _case(N, H, D, 1.0)
    xla = ops.masked_attention_qkv_plain(qkv, mask, H, D ** -0.5, FILL)
    share = _bench.bf16_off_share(xla, ref)
    assert share > SHARE_TOL, share


@pytest.mark.parametrize("N", [88, 264, 17])
def test_tpu_plain_matches_xla_f64(x64, N):
    """At f64 the roundings are no-ops: the TPU form is the XLA oracle."""
    H, D = 2, 16
    rng = np.random.RandomState(N)
    qkv = rng.randn(3, N, 3 * H * D)
    m = rng.rand(3, N) < 0.5
    m[:, 0] = True
    m[1, 1:] = False
    mask = m.astype(np.float64)
    ref = np.asarray(jax_ma._xla_masked_from_qkv(jnp.asarray(qkv), jnp.asarray(mask), H,
                                                 D ** -0.5, FILL))
    got = ops.masked_attention_qkv_tpu_plain(torch.from_numpy(qkv), torch.from_numpy(mask),
                                             H, D ** -0.5, FILL)
    assert got.dtype == torch.float64
    assert_close(got, ref)


@pytest.mark.parametrize("D, ok", [(16, True), (32, True), (48, True), (64, True),
                                   (96, True), (128, True), (8, False), (72, False),
                                   (144, False)])
def test_kernel_head_dim_check(D, ok):
    """The tensor-core kernel takes every head dim that is a multiple of 16 up
    to 128; the wrapper refuses the others before any launch."""
    if ok:
        port_ma.check_k3_head_dim(D)
    else:
        with pytest.raises(ValueError, match="head dim"):
            port_ma.check_k3_head_dim(D)


def test_cpu_wrapper_runs_the_model_paths_plain_version():
    """On a CPU tensor the wrapper runs the XLA form that JAX's CPU path runs,
    at any group (0, the model paths'; 3, which B = 4 leaves a short last
    block) and head dim, and counts no launch."""
    qkv, mask, _ = _case(88, 2, 16, 1.0)
    before = (ops.masked_attention_qkv.launches, ops.masked_attention_qkv.variant_launches)
    want = ops.masked_attention_qkv_plain(qkv, mask, 2, 0.25, FILL)
    for group in (0, 1, 2, 3, 8):
        got = ops.masked_attention_qkv(qkv, mask, 2, 0.25, FILL, group=group)
        assert torch.equal(got, want)
    odd = ops.masked_attention_qkv(qkv.float()[..., :24], mask, 2, 0.5, FILL)  # D = 4
    assert odd.shape == (B, 88, 8)
    assert (ops.masked_attention_qkv.launches,
            ops.masked_attention_qkv.variant_launches) == before
