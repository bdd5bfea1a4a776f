"""The port's attention ops (K1-K3 plain versions and their CPU wrappers)
against the JAX package's XLA oracles, at f32 and f64.

Inputs come from numpy with a fixed seed; both sides see the same arrays.
Tolerances (tests/torch_parity.py): rtol 1e-9 at f64 and 1e-5 at f32, since
both sides compute the same formula and differ only in summation order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from editor_tpu.ops.fused_attention import _xla_attention_qkv
from editor_tpu.ops.masked_attention import _xla_masked_from_qkv
from editor_tpu.ops.rollout import rollout_from_probs, rollout_from_split_probs
from editor_tpu_torch import ops
from tests.torch_parity import assert_close, tolerances, x64  # noqa: F401

H, D = 4, 8
C = H * D
SCALE = D ** -0.5
FILL = -65504.0
DTYPES = [np.float32, np.float64]


def _qkv(B, N, seed, mul=1.0, dtype=np.float64):
    return (np.random.RandomState(seed).randn(B, N, 3 * C) * mul).astype(dtype)


def _scaled_tol(dtype, mul):
    """At x30 the logits reach ~1e3, so f32 rounding of a logit (~1e3 x 6e-8)
    moves a softmax weight by ~1e-4 relative: outputs are compared scaled by
    their maximum, with atol 1e-4 at f32. f64 keeps its usual tolerance."""
    if mul > 1 and np.dtype(dtype) == np.float32:
        return dict(rtol=0.0, atol=1e-4)
    return tolerances(dtype)


def _mask(B, N, seed):
    """Random keep mask with the cls token kept; each masked token is a fully
    masked query row."""
    m = np.random.RandomState(seed).rand(B, N) < 0.5
    m[:, 0] = True
    return m.astype(np.float32)


@pytest.mark.parametrize("mul", [1.0, 30.0])
@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_plain_matches_xla(x64, dtype, mul):
    qkv = _qkv(2, 17, 0, mul, dtype)
    ref_out, (pp, pc) = _xla_attention_qkv(jnp.asarray(qkv), H, SCALE, with_probs=True)
    ref_probs = np.concatenate([np.asarray(pc)[..., None], np.asarray(pp)], -1)
    out, probs = ops.attention_qkv_plain(torch.from_numpy(qkv), H, SCALE, True)
    assert out.dtype == probs.dtype == torch.from_numpy(qkv).dtype
    # the x30 case has |logits| ~ 1e3: compare scaled by the output's size
    sc = max(float(np.abs(ref_out).max()), 1e-12) if mul > 1 else 1.0
    assert np.isfinite(out.numpy()).all()
    assert_close(out / sc, np.asarray(ref_out) / sc, **_scaled_tol(dtype, mul))
    assert_close(probs, ref_probs, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_wrapper_on_cpu_is_plain(x64, dtype):
    qkv = torch.from_numpy(_qkv(2, 9, 1, dtype=dtype))
    before = ops.attention_qkv.launches
    probs = torch.empty(2, H, 9, 9, dtype=qkv.dtype)
    out, got_probs = ops.attention_qkv(qkv, H, SCALE, probs_out=probs)
    ref_out, ref_probs = ops.attention_qkv_plain(qkv, H, SCALE, True)
    assert got_probs is probs
    assert torch.equal(out, ref_out) and torch.equal(probs, ref_probs)
    out2, none = ops.attention_qkv(qkv, H, SCALE)
    assert none is None and torch.equal(out2, ref_out)
    assert ops.attention_qkv.launches == before  # no kernel on the CPU
    with pytest.raises(ValueError):
        ops.attention_qkv(qkv, H, SCALE, probs_out=torch.empty(2, H, 9, 8, dtype=qkv.dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_rollout_plain_matches_full_and_split_chain(x64, dtype):
    L, B, N = 4, 2, 17
    logits = np.random.RandomState(2).randn(L, B, H, N, N)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    probs = probs.astype(dtype)
    got = ops.rollout_from_probs_plain(torch.from_numpy(probs))
    assert got.shape == (B, H, N - 1)
    assert_close(got, rollout_from_probs(jnp.asarray(probs)), dtype)
    assert_close(got, rollout_from_split_probs(jnp.asarray(probs[..., 1:]),
                                               jnp.asarray(probs[..., 0])), dtype)
    before = ops.rollout_chain.launches
    assert torch.equal(ops.rollout_chain(torch.from_numpy(probs)), got)
    assert ops.rollout_chain.launches == before


def test_rollout_of_attention_probs_matches_jax(x64):
    """The probs contract end to end: K1's plain probs stacked over layers
    and reduced by K2's plain chain equal the JAX split-probs rollout."""
    qkvs = [_qkv(2, 17, 10 + l) for l in range(3)]
    stacked = torch.stack([ops.attention_qkv_plain(torch.from_numpy(q), H, SCALE, True)[1]
                           for q in qkvs])
    pairs = [_xla_attention_qkv(jnp.asarray(q), H, SCALE, with_probs=True)[1] for q in qkvs]
    ref = rollout_from_split_probs(jnp.stack([p[0] for p in pairs]),
                                   jnp.stack([p[1] for p in pairs]))
    assert_close(ops.rollout_chain(stacked), ref)


@pytest.mark.parametrize("mul", [1.0, 30.0])
@pytest.mark.parametrize("N", [11, 33])  # 1+keep per modality, 3(1+keep) joint
@pytest.mark.parametrize("dtype", DTYPES)
def test_masked_attention_plain_matches_xla(x64, dtype, N, mul):
    B = 3
    qkv = _qkv(B, N, 3, mul, dtype)
    mask = _mask(B, N, 4)
    ref = np.asarray(_xla_masked_from_qkv(jnp.asarray(qkv), jnp.asarray(mask), H,
                                          SCALE, FILL))
    got = ops.masked_attention_qkv_plain(torch.from_numpy(qkv), torch.from_numpy(mask),
                                         H, SCALE, FILL)
    sc = max(float(np.abs(ref).max()), 1e-12) if mul > 1 else 1.0
    assert_close(got / sc, ref / sc, **_scaled_tol(dtype, mul))
    # fully masked query rows come out exactly 0
    dead = torch.from_numpy(mask) == 0
    assert dead.any() and torch.count_nonzero(got[dead]) == 0


@pytest.mark.parametrize("dtype", DTYPES)
def test_masked_attention_wrapper_on_cpu_is_plain(x64, dtype):
    qkv = torch.from_numpy(_qkv(2, 11, 5, dtype=dtype))
    mask = torch.from_numpy(_mask(2, 11, 6))
    before = ops.masked_attention_qkv.launches
    got = ops.masked_attention_qkv(qkv, mask.bool(), H, SCALE)  # any mask dtype
    ref = ops.masked_attention_qkv_plain(qkv, mask, H, SCALE)
    assert torch.equal(got, ref)
    assert ops.masked_attention_qkv.launches == before
    with pytest.raises(ValueError):
        ops.masked_attention_qkv(qkv, mask[:, :-1], H, SCALE)
