"""K1 (attention from the raw qkv) in the TPU kernel's form.

The CUDA kernel ``csrc/attention_qkv.cu`` rounds where the TPU kernel
``_qkv_kernel`` / ``_head_split_softmax_av`` rounds: the patch keys'
probabilities to bf16 before the p.v product, the cls key's kept in fp32.
Its plain version in that form, ``ops.attention_qkv_tpu_plain``, is held here

* at bf16 against the TPU kernel body ``_kernel_probs`` itself, run through
  ``pl.pallas_call(..., interpret=True)`` with ``_pallas_attention_qkv``'s
  BlockSpecs, on the same bf16 inputs: ``out`` and the split probs
  reassembled to [B, H, N, N]. Both sides round at the same points and sum
  in fp32 in other orders, so an element may land one bf16 step away: the
  limit is one bf16 ulp of the largest magnitude. The model path's plain
  version (``attention_qkv_plain``, the form of ``_xla_attention_qkv``,
  which rounds the cls probability too) must be strictly farther from the
  TPU body's ``out``, so the comparison tells the two forms apart;
* at f64 against ``_xla_attention_qkv`` and ``attention_qkv_plain``, where
  no rounding happens and the two forms are one function (rtol 1e-9).
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
from tests.torch_parity import assert_close, x64  # noqa: F401
from tests.torch_parity import bf16_pair as _bf16, ulp_of_max as _ulp_of_max

jax_fa = importlib.import_module("editor_tpu.ops.fused_attention")

# (B, N, H, D): the flagship width (ViT-B/16: 12 heads of 64) at 129 tokens,
# and D = 96 (vit_small_config: 768 / 8)
SHAPES = [(2, 129, 12, 64), (2, 129, 8, 96)]


def _qkv(B, N, H, D, seed, mul=1.0):
    return mul * np.random.RandomState(seed).randn(B, N, 3 * H * D)


def _tpu_body(qkv, H, D, scale):
    """``_kernel_probs`` in Pallas interpret mode with the BlockSpecs of
    ``_pallas_attention_qkv`` (with probs): (out [B, N, C], probs [B, H, N, N])
    as float32 numpy arrays."""
    import jax.experimental.pallas as pl

    B, N, C3 = qkv.shape
    C, P = C3 // 3, N - 1
    g = jax_fa._pick_group(B, 4)
    out, pp, pc = pl.pallas_call(
        functools.partial(jax_fa._kernel_probs, scale=scale, H=H, D=D),
        out_shape=(jax.ShapeDtypeStruct((B, N, C), qkv.dtype),
                   jax.ShapeDtypeStruct((B, H, N, P), qkv.dtype),
                   jax.ShapeDtypeStruct((B, H, N), qkv.dtype)),
        grid=(B // g,),
        in_specs=[pl.BlockSpec((g, N, C3), lambda i: (i, 0, 0))],
        out_specs=(pl.BlockSpec((g, N, C), lambda i: (i, 0, 0)),
                   pl.BlockSpec((g, H, N, P), lambda i: (i, 0, 0, 0)),
                   pl.BlockSpec((g, H, N), lambda i: (i, 0, 0))),
        interpret=True)(qkv)
    probs = jnp.concatenate([pc[..., None], pp], axis=-1)
    return (np.asarray(out.astype(jnp.float32)), np.asarray(probs.astype(jnp.float32)))


@pytest.mark.parametrize("B, N, H, D", SHAPES)
@pytest.mark.parametrize("mul", [1.0, 30.0], ids=["randn", "x30"])
def test_tpu_plain_matches_tpu_kernel_bf16(B, N, H, D, mul):
    """x30 puts the logits near 1e3: the row max must keep every exp finite."""
    scale = D ** -0.5
    jq, tq = _bf16(_qkv(B, N, H, D, seed=D + N, mul=mul))
    ref_out, ref_probs = _tpu_body(jq, H, D, scale)
    got_out, got_probs = ops.attention_qkv_tpu_plain(tq, H, scale, True)
    assert got_out.dtype == got_probs.dtype == torch.bfloat16
    assert got_out.shape == (B, N, H * D) and got_probs.shape == (B, H, N, N)
    got_out, got_probs = got_out.float().numpy(), got_probs.float().numpy()
    assert np.isfinite(got_out).all()
    np.testing.assert_allclose(got_out, ref_out, rtol=0, atol=_ulp_of_max(ref_out))
    np.testing.assert_allclose(got_probs, ref_probs, rtol=0, atol=_ulp_of_max(ref_probs))
    np.testing.assert_allclose(got_probs.sum(-1), 1.0, atol=1e-2)
    if mul != 1.0:  # x30 rows are near one-hot: a cls p of ~0 or ~1 rounds exactly
        return
    # the model path's form rounds the cls probability too: farther away
    xla_out = ops.attention_qkv_plain(tq, H, scale, False).float().numpy()
    d_tpu, d_xla = np.abs(got_out - ref_out), np.abs(xla_out - ref_out)
    assert d_xla.sum() > d_tpu.sum() and (d_xla > 0).sum() > (d_tpu > 0).sum()


@pytest.mark.parametrize("B, N, H, D", [(3, 17, 4, 16), (2, 129, 8, 96)])
def test_tpu_plain_and_plain_match_xla_f64(x64, B, N, H, D):
    scale = D ** -0.5
    qkv = _qkv(B, N, H, D, seed=N + 3)
    ref_out, (ref_pp, ref_pc) = jax_fa._xla_attention_qkv(jnp.asarray(qkv), H, scale, True)
    ref_probs = np.concatenate([np.asarray(ref_pc)[..., None], np.asarray(ref_pp)], -1)
    t = torch.from_numpy(qkv)
    for fn in (ops.attention_qkv_tpu_plain, ops.attention_qkv_plain):
        out, probs = fn(t, H, scale, True)
        assert out.dtype == probs.dtype == torch.float64
        assert_close(out, ref_out)
        assert_close(probs, ref_probs)


def test_cpu_wrapper_runs_the_model_path_plain_version():
    """On a CPU tensor ``attention_qkv`` runs ``attention_qkv_plain`` (the
    form the CPU parity tests of the model path hold against JAX)."""
    B, N, H, D = 2, 17, 4, 16
    _, tq = _bf16(_qkv(B, N, H, D, seed=1))
    probs = torch.empty(B, H, N, N, dtype=torch.bfloat16)
    out, got = ops.attention_qkv(tq, H, D ** -0.5, probs_out=probs)
    ref_out, ref_probs = ops.attention_qkv_plain(tq, H, D ** -0.5, True)
    assert got is probs and torch.equal(out, ref_out) and torch.equal(probs, ref_probs)


@pytest.mark.parametrize("D, ok", [(16, True), (64, True), (96, True), (128, True),
                                   (8, False), (72, False), (144, False)])
def test_kernel_head_dims(D, ok):
    """The CUDA kernel takes every head dim that is a multiple of 16 up to
    128; the wrapper refuses the others before any launch."""
    if ok:
        port_fa.check_k1_head_dim(D)
    else:
        with pytest.raises(ValueError, match="head dim"):
            port_fa.check_k1_head_dim(D)
