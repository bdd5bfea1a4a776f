"""The port's sequence parallelism (``parallel/ring.py``) against the JAX
package's ``editor_tpu/parallel/ring.py``, on the CPU: the port's ranks are
gloo processes (``tests/torch_dp.py``) on a 'seq' mesh of W = 2 and 4, JAX
runs ``shard_map`` on the conftest's 8 virtual CPU devices; inputs from a
numpy seed at float64 with JAX x64 on.

* Ring and Ulysses attention, masked and unmasked, forward and the
  gradients of sum(out * w) with respect to q, k and v (each rank computes
  the same loss, so the mean of the ranks' gradients is its gradient):
  against the plain local attention at float64 (1e-12), against JAX's
  Ulysses at float64 (1e-12) and JAX's ring (rtol 1e-5, atol 1e-6: JAX's
  ring accumulates in fp32 whatever the input type); one mask keeps no key
  of a whole shard and no token of one sequence (zero rows, finite
  gradients).
* The divisibility errors: a sequence or, for Ulysses, a head count the
  group does not divide (uncompacted N = 129 at S = 2 through
  ``masked_attention_from_qkv(seq_mesh=)`` on the ranks).
* The fusion block with ``seq_mesh`` (every masked attention on the masked
  ring) in training at W = 2 and 4: the loss mean(fused * proj) + OCFR
  (``proj`` a fixed random projection of the fused tokens) of JAX's
  ``blockmask_apply(seq_mesh=)`` (rtol 1e-5, its ring in fp32), and the
  mean of the ranks' parameter gradients equal to the port's local block's
  (1e-10).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from editor_tpu.parallel import ring as jring
from editor_tpu_torch.ops import masked_attention_qkv_plain
from tests.torch_dp import finish, start_ranks
from tests.torch_dp_jax import fusion_inputs, jax_fusion_loss, local_fusion
from tests.torch_parity import x64  # noqa: F401

B, H, N, D = 2, 4, 16, 8


def _cases(W):
    rng = np.random.RandomState(10 + W)
    masks = (rng.rand(B, N) < 0.6).astype(np.float64)
    masks[0, N // W:2 * N // W] = 0   # a shard with no key of sequence 0
    masks[1] = 0                      # a sequence with no token at all
    cases = {}
    for fn in ("ring_attention", "ulysses_attention", "ring_masked_attention",
               "ulysses_masked_attention"):
        case = {"fn": fn, **{k: rng.randn(B, H, N, D) for k in ("q", "k", "v", "w")}}
        if "masked" in fn:
            case["mask"] = masks
        cases[fn] = case
    return cases


def _local(case):
    """The plain local attention at float64 and its gradients."""
    q, k, v = (torch.tensor(case[n], requires_grad=True) for n in ("q", "k", "v"))
    if "mask" in case:
        qkv = torch.cat([t.transpose(1, 2).reshape(B, N, H * D) for t in (q, k, v)], -1)
        out = masked_attention_qkv_plain(qkv, torch.tensor(case["mask"]), H, D ** -0.5)
        out = out.reshape(B, N, H, D).transpose(1, 2)
    else:
        p = torch.softmax(q @ k.transpose(-1, -2) * D ** -0.5, dim=-1)
        out = p @ v
    (out * torch.tensor(case["w"])).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in (q, k, v)]


def _jax(cases, mesh):
    """JAX's output and q, k, v gradients of every case, in one compile."""
    names = list(cases)

    def one(case, q, k, v, w, mask):
        fn = getattr(jring, case["fn"])

        def loss(q, k, v):
            out = fn(q, k, v, mask, mesh) if mask is not None else fn(q, k, v, mesh)
            return jnp.sum(out * w), out

        (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(q, k, v)
        return out, grads

    def run(arrays):
        return {n: one(cases[n], *arrays[n]) for n in names}

    arrays = {n: tuple(jnp.asarray(cases[n][k]) for k in ("q", "k", "v", "w"))
              + (jnp.asarray(cases[n]["mask"]) if "mask" in cases[n] else None,)
              for n in names}
    res = jax.jit(run)(arrays)
    return {n: (np.asarray(o), [np.asarray(g) for g in gs]) for n, (o, gs) in res.items()}


@pytest.mark.parametrize("W", [2, 4])
def test_ring_and_ulysses_match_local_and_jax(x64, W, tmp_path):
    cases = _cases(W)
    launch = start_ranks("ring", W, tmp_path, {"cases": cases})
    mesh = Mesh(np.asarray(jax.devices()[:W]), ("seq",))
    ref = _jax(cases, mesh)
    local = {name: _local(case) for name, case in cases.items()}
    got = finish(launch, timeout=120)
    for name, case in cases.items():
        fp32 = name.startswith("ring")
        tol = dict(rtol=1e-5, atol=1e-6) if fp32 else dict(rtol=1e-12, atol=1e-12)
        mean = [sum(got[r][name]["grads"][n] for r in range(W)).numpy() / W
                for n in ("q", "k", "v")]
        for r in range(W):  # every rank gets the whole output
            y = got[r][name]["y"].numpy()
            np.testing.assert_allclose(y, local[name][0], rtol=1e-12, atol=1e-12,
                                       err_msg=name)
            np.testing.assert_allclose(y, ref[name][0], err_msg=name, **tol)
        for n, g, g_local, g_jax in zip("qkv", mean, local[name][1], ref[name][1]):
            assert np.isfinite(g).all()
            np.testing.assert_allclose(g, g_local, rtol=1e-10, atol=1e-12, err_msg=name + n)
            np.testing.assert_allclose(g, g_jax, err_msg=name + n, **tol)
        if "mask" in case:  # the empty sequence's rows are zeros
            assert not got[0][name]["y"][1].any()
    # the divisibility errors: JAX's messages
    seq_mesh = Mesh(np.asarray(jax.devices()[:W]), ("seq",))
    for key, fn, shape in (("divisibility", jring.ring_attention, (1, 4, 129, 4)),
                           ("heads", jring.ulysses_attention, (1, 3, 8 * W, 4))):
        with pytest.raises(ValueError) as err:
            fn(*(jnp.zeros(shape),) * 3, seq_mesh)
        for r in range(W):
            assert got[r][key] == str(err.value), key


@pytest.mark.parametrize("W", [2, 4])
def test_seq_sharded_fusion_block(x64, W, tmp_path):
    params, fusion = fusion_inputs(W)
    launch = start_ranks("fusion_parallel", W, tmp_path, {"fusion": fusion, "axis": "seq"})
    ref = jax_fusion_loss(params, fusion,
                          seq_mesh=Mesh(np.asarray(jax.devices()[:W]), ("seq",)))
    loss, grads = local_fusion(fusion)
    got = finish(launch, timeout=120)
    for r in range(W):
        np.testing.assert_allclose(got[r]["loss"], loss, rtol=1e-12)
        np.testing.assert_allclose(got[r]["loss"], ref, rtol=1e-5)
    for k, g in grads.items():
        mean = sum(got[r]["grads"][k] for r in range(W)) / W
        np.testing.assert_allclose(mean.numpy(), g.numpy(), rtol=1e-10, atol=1e-12, err_msg=k)
