"""The port's mixture of experts (``parallel/moe.py``, ``MODEL.MOE_EXPERTS``)
against the JAX package's ``editor_tpu/parallel/moe.py``, on the CPU with
inputs from a numpy seed and JAX x64 on. JAX's MoE casts its tokens and
weights to fp32 whatever their type, and so does the port, so two fp32
computations in different orders meet at fp32's precision, as stated at each
check.

* The index dispatch (a cumsum over a [T*K, E] one-hot, ``index_copy`` into
  the [E, C, D] buffers, ``index_select`` back) equals JAX's
  ``_dispatch_masks`` einsums at float64, dropped pairs included (T*K = 48
  pairs for 4 experts of 3, 6 and 24 slots); the slots of two halves with
  the first half's counts as the second's offset are the whole's (the data
  mesh's routing). At the flagship's joint block (T = 33,792, E = 8, C =
  16,896; width 8) no allocation passes 16 MB, where JAX's [T, K, E, C]
  one-hot would take 36 GB.
* ``moe_ffn_dense`` and the ``moe_shards`` = 2 emulation of the fusion's
  ``moe_masked_mlp``: outputs and the aux loss within 1e-5 relative of
  JAX's, the gradients of sum(y * w) + aux within 2e-5 of the largest.
* ``moe_ffn`` over an 'expert' mesh of W = 2 and 4 gloo ranks against
  JAX's ``moe_ffn`` (the same bounds; the ranks' mean gradient), and the
  fusion block with ``moe_mesh`` against JAX's ``blockmask_apply(
  moe_mesh=)`` (loss rtol 1e-6) and the port's ``moe_shards`` = W block
  (gradients within 1e-6 of the largest).

The EDITOR with the MoE joint MLP is in ``tests/test_torch_moe_step.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from editor_tpu.models import fusion as jfusion
from editor_tpu.parallel import moe as jmoe
from editor_tpu_torch.models.fusion import moe_masked_mlp
from editor_tpu_torch.parallel import moe
from tests.torch_dp import finish, start_ranks
from tests.torch_dp_jax import fusion_inputs, jax_fusion_loss, local_fusion
from tests.torch_parity import x64  # noqa: F401


def test_index_dispatch_equals_jax_einsum(x64):
    rng = np.random.RandomState(0)
    T, D, E, K = 24, 8, 4, 2
    x = rng.randn(T, D)
    router = jnp.asarray(rng.randn(D, E))
    gates, idx, _ = jmoe._route(router, jnp.asarray(x), K)
    ye = rng.randn(E, 24, D)
    for C in (3, 6, 24):  # 3 and 6 drop pairs, 24 none
        disp, comb = jmoe._dispatch_masks(idx, gates, E, C)
        ref_x = np.asarray(jnp.einsum("td,tec->ecd", jnp.asarray(x), disp))
        ref_y = np.asarray(jnp.einsum("ecd,tec->td", jnp.asarray(ye[:, :C]), comb))
        ti = torch.tensor(np.asarray(idx), dtype=torch.long)
        pos = moe.slots(ti, E)
        xe, row = moe.dispatch(torch.from_numpy(x), ti, pos, E, C)
        np.testing.assert_array_equal(xe.numpy(), ref_x)
        y = moe.combine(torch.from_numpy(ye[:, :C]), row,
                        torch.tensor(np.asarray(gates), dtype=torch.float64))
        np.testing.assert_allclose(y.numpy(), ref_y, rtol=1e-15, atol=1e-15)
        assert int((row < E * C).sum()) == int(np.asarray(disp).sum())
    assert int((row < E * 24).sum()) == T * K
    # the data mesh: the second half's slots start after the first half's
    half = ti[:T // 2]
    offset = torch.bincount(half.reshape(-1), minlength=E)
    both = torch.cat([moe.slots(half, E), moe.slots(ti[T // 2:], E, offset)])
    assert torch.equal(both, moe.slots(ti, E))


def test_dispatch_builds_no_one_hot_at_the_flagship_size():
    T, E, D, F = 128 * 264, 8, 8, 16
    C = moe.capacity_of(T, E)
    assert C == 16896 and T * 2 * E * C * 4 > 36e9  # JAX's [T, K, E, C] fp32 one-hot
    gen = torch.Generator().manual_seed(0)
    params = moe.moe_init(D, F, E, gen)
    x = torch.randn(T, D, generator=gen)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU], profile_memory=True) as prof:
        y, aux = moe.moe_ffn_dense(params, x)
    assert y.shape == (T, D) and torch.isfinite(y).all() and torch.isfinite(aux)
    biggest = max(e.cpu_memory_usage for e in prof.key_averages())
    assert biggest < 16e6, biggest


def _close(got, ref, rel, what=""):
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * max(np.abs(ref).max(), 1e-30),
                               err_msg=what)


def _jax_params(E, D, F, seed):
    p = jmoe.moe_init(jax.random.PRNGKey(seed), D, F, E)
    # non-zero biases, so that their gradients and the dense/sharded paths show
    rng = np.random.RandomState(seed)
    return p._replace(b1=jnp.asarray(rng.randn(E, F) * 0.1),
                      b2=jnp.asarray(rng.randn(E, D) * 0.1))


def _port_params(p, grad=False):
    return moe.MoEParams(*(torch.tensor(np.asarray(v), dtype=torch.float64,
                                        requires_grad=grad) for v in p))


def _jax_value_and_grads(fn, p, x, w):
    def loss(p, x):
        y, aux = fn(p, x)
        return jnp.sum(y * w) + aux, (y, aux)
    (_, (y, aux)), g = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(p, x)
    return np.asarray(y), float(aux), dict(zip(p._fields, g[0]), x=g[1])


def test_moe_ffn_dense_and_shards_match_jax(x64):
    E, D, F, T = 4, 16, 32, 64
    p = _jax_params(E, D, F, 1)
    rng = np.random.RandomState(2)
    x, w = rng.randn(T, D), rng.randn(T, D)
    # the dense layer, with a capacity that drops pairs
    y_ref, aux_ref, g_ref = _jax_value_and_grads(
        lambda p, x: jmoe.moe_ffn_dense(p, x, capacity_factor=1.0), p, jnp.asarray(x), w)
    pp = _port_params(p, grad=True)
    xt = torch.tensor(x, requires_grad=True)
    y, aux = moe.moe_ffn_dense(pp, xt, capacity_factor=1.0)
    ((y * torch.tensor(w)).sum() + aux).backward()
    _close(y.detach(), y_ref, 1e-5, "y")
    np.testing.assert_allclose(float(aux.detach()), aux_ref, rtol=1e-6)
    for k, g in g_ref.items():
        _close((xt if k == "x" else getattr(pp, k)).grad, g, 2e-5, k)
    # moe_masked_mlp with moe_shards = 2: [B, N, C] tokens under a mask
    B, N = 4, 16
    xs = rng.randn(B, N, D)
    mask = (rng.rand(B, N, 1) < 0.7).astype(np.float64)
    y_ref, aux_ref = jax.jit(lambda p, x, m: jfusion.moe_masked_mlp(p, x, m, moe_shards=2))(
        p._asdict(), jnp.asarray(xs), jnp.asarray(mask))
    y, aux = moe_masked_mlp(_port_params(p), torch.tensor(xs), torch.tensor(mask),
                            moe_shards=2)
    _close(y, y_ref, 1e-5, "moe_shards y")
    np.testing.assert_allclose(float(aux), float(aux_ref), rtol=1e-6)


@pytest.mark.parametrize("W", [2, 4])
def test_moe_ffn_over_an_expert_mesh_matches_jax(x64, W, tmp_path):
    E, D, F, T = 8, 16, 32, 64
    p = _jax_params(E, D, F, 3)
    rng = np.random.RandomState(4)
    x, w = rng.randn(T, D), rng.randn(T, D)
    params, fusion = fusion_inputs(W, experts=2 * W, seed=5)
    launches = [start_ranks("moe", W, tmp_path / "ffn", {
                    "params": {k: np.asarray(v) for k, v in p._asdict().items()},
                    "x": x, "w": w}),
                start_ranks("fusion_parallel", W, tmp_path / "fusion",
                            {"fusion": fusion, "axis": "expert"})]
    mesh = Mesh(np.asarray(jax.devices()[:W]), ("expert",))
    y_ref, aux_ref, g_ref = _jax_value_and_grads(
        lambda p, x: jmoe.moe_ffn(p, x, mesh), p, jnp.asarray(x), w)
    ref_loss = jax_fusion_loss(params, fusion, moe_mesh=mesh)
    loss, grads = local_fusion(fusion, moe_shards=W)
    got, fused = (finish(launch, timeout=120) for launch in launches)
    for r in range(W):
        _close(got[r]["y"], y_ref, 1e-5, "y")
        np.testing.assert_allclose(got[r]["aux"], aux_ref, rtol=1e-6)
        np.testing.assert_allclose(fused[r]["loss"], ref_loss, rtol=1e-6)
        np.testing.assert_allclose(fused[r]["loss"], loss, rtol=1e-6)
    for k, g in g_ref.items():
        _close(sum(got[r]["grads"][k] for r in range(W)) / W, g, 2e-5, k)
    for k, g in grads.items():
        _close(sum(fused[r]["grads"][k] for r in range(W)) / W, g, 1e-6, k)
