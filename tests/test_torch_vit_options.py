"""The backbone's training options against the JAX package at float64: the
remat policies, attention dropout, and remat with dropout.

* ``TPU.REMAT_POLICY`` ``dots``, ``names`` and ``attn_out``, each with
  ``REMAT_SKIP_LAST`` 0 and 1, on the tiny config (depth 2, width 96): one
  ``build_train_step`` step against JAX's step with the same policy (loss
  rtol 1e-7, each parameter's change within 1e-7 of that tensor's largest:
  the JAX step's fp32 rounding points, as tests/test_torch_train_step.py),
  and against the port's step without remat from the same weights, bit for
  bit (the same ops on the same inputs; a recompute repeats them exactly).
* Attention dropout (``attn_drop_rate`` 0.25): the two packages draw from
  different streams, so each is held to the statistics. In a training
  forward the first block's attention weights are the eval forward's with a
  share of zeros within 4 sigma of the rate and the survivors scaled by
  1/(1 - rate) (rtol 1e-12); the rollout is the chain of the dropped weights;
  the attention output is the dropped weights times v (1e-12); K1's
  function is not called in training and is called once a block in eval.
  JAX's ``_attention_core`` gives the same statistics.
* Remat with dropout and attention dropout (and drop path), under every
  policy and with ``REMAT_SKIP_LAST``: loss and gradients equal those of
  the same forward without remat from the same generator seed, bit for bit,
  and the generator ends where it ends without remat.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from editor_tpu.config import Config as JaxConfig
from editor_tpu.engine import build_train_step as jax_build_train_step
from editor_tpu.engine import make_train_state
from editor_tpu.losses import make_loss as jax_make_loss
from editor_tpu.models import vit as jax_vit
from editor_tpu.models.editor import EditorConfig as JaxEditorConfig
from editor_tpu.models.vit import ViTConfig as JaxViTConfig
from editor_tpu.solver import make_optimizer as jax_make_optimizer
from editor_tpu.solver import make_scheduler as jax_make_scheduler
from editor_tpu_torch import ops
from editor_tpu_torch.config import Config
from editor_tpu_torch.engine.train import build_train_step
from editor_tpu_torch.losses import make_loss
from editor_tpu_torch.models import vit as port_vit
from editor_tpu_torch.models.editor import EditorConfig, vit_tiny_test_config
from editor_tpu_torch.models.init import editor_init
from editor_tpu_torch.solver import make_optimizer, make_scheduler
from editor_tpu_torch.utils.jax_weights import state_dict_from_jax
from tests.torch_parity import port_editor, to_numpy_tree, x64  # noqa: F401

MODS = ("RGB", "NI", "TI")


def _jax_cfg(**vit_kw):
    vit = JaxViTConfig(img_size=(64, 32), patch_size=16, stride_size=(16, 16),
                       embed_dim=96, depth=2, num_heads=4, mlp_ratio=2.0, camera=4,
                       drop_path_rate=0.0, **vit_kw)
    return JaxEditorConfig(num_classes=4, vit=vit, head_keep=2, frequency_keep=3,
                           use_pallas=False)


def _port_step(model):
    tcfg = Config()
    return build_train_step(model, make_optimizer(tcfg, model), make_loss(tcfg, 4),
                            make_scheduler(tcfg), tcfg.SOLVER.BASE_LR,
                            compute_dtype=torch.float64)


@pytest.mark.parametrize("skip", [0, 1])
@pytest.mark.parametrize("policy", ["dots", "names", "attn_out"])
def test_remat_policy_step_matches_jax_and_no_remat(x64, policy, skip):
    jcfg = _jax_cfg(remat=True, remat_policy=policy, remat_skip_last=skip)
    cfg = JaxConfig()
    from editor_tpu.models.editor import editor_init as jax_editor_init
    params, _ = jax.jit(lambda k: jax_editor_init(k, jcfg))(jax.random.PRNGKey(0))
    opt = jax_make_optimizer(cfg, params)
    state = make_train_state(jax.random.PRNGKey(0), jcfg, opt)
    state = jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float64) if x.dtype == jnp.float32 else x, state)
    step = jax_build_train_step(jcfg, opt, jax_make_loss(cfg, 4), jax_make_scheduler(cfg),
                                cfg.SOLVER.BASE_LR, compute_dtype=jnp.float64, donate=False)
    rng = np.random.RandomState(1)
    batch = {m: rng.randn(8, 64, 32, 3) for m in MODS}
    batch["pid"] = np.array([0, 0, 1, 1, 2, 2, 3, 3])
    batch["camid"] = np.arange(8) % 4
    params0, mstate0 = to_numpy_tree(state.params), to_numpy_tree(state.model_state)
    model = port_editor(jcfg, params0, mstate0)
    plain = port_editor(dataclasses.replace(jcfg, vit=dataclasses.replace(jcfg.vit, remat=False)),
                        params0, mstate0)
    assert model.cfg.vit.remat and model.cfg.vit.remat_policy == policy
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = _port_step(model)(tbatch, 1)
    got_plain = _port_step(plain)(tbatch, 1)
    state, ref = step(state, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(1))

    assert float(got["loss"]) == float(got_plain["loss"])
    for (name, p), q in zip(model.named_parameters(), plain.parameters()):
        assert torch.equal(p, q), name
    np.testing.assert_allclose(float(got["loss"]), float(ref["loss"]), rtol=1e-7)
    ref_sd = state_dict_from_jax(to_numpy_tree(state.params),
                                 to_numpy_tree(state.model_state), jcfg)
    sd0 = state_dict_from_jax(params0, mstate0, jcfg)
    got_sd = model.state_dict()
    for name, _ in model.named_parameters():
        d_got = got_sd[name].numpy() - sd0[name].numpy()
        d_ref = ref_sd[name].numpy() - sd0[name].numpy()
        np.testing.assert_allclose(d_got, d_ref, rtol=0,
                                   atol=max(1e-7 * np.abs(d_ref).max(), 1e-15), err_msg=name)


def _probe_kernel_path(monkeypatch):
    """Record K1's function calls and every probs stack the rollout reads."""
    calls, stacks = [], []
    attn_fn, chain = ops.attention_qkv_fn, ops.rollout_chain

    def attention_qkv_fn(*args):
        calls.append(None)
        return attn_fn(*args)

    def rollout_chain(probs):
        stacks.append(probs.clone())
        return chain(probs)

    monkeypatch.setattr(ops, "attention_qkv_fn", attention_qkv_fn)
    monkeypatch.setattr(ops, "rollout_chain", rollout_chain)
    return calls, stacks


def test_attention_dropout_statistics(x64, monkeypatch):
    rate = 0.25
    cfg = vit_tiny_test_config(img_size=(64, 32), patch_size=16, stride_size=(16, 16),
                               drop_path_rate=0.0, attn_drop_rate=rate)
    vit = port_vit.VisionTransformer(cfg, device="cpu")
    with torch.no_grad():
        for p in vit.parameters():
            p.normal_(0.0, 0.2, generator=torch.Generator().manual_seed(p.numel()))
    vit = vit.double()
    x = torch.from_numpy(np.random.RandomState(0).randn(64, 64, 32, 3))
    calls, stacks = _probe_kernel_path(monkeypatch)
    _, roll_eval = vit(x)
    assert len(calls) == cfg.depth
    _, roll = vit(x, training=True, generator=torch.Generator().manual_seed(3))
    assert len(calls) == cfg.depth  # none in training: the plain attention
    eval_probs, probs = stacks
    ref, got = eval_probs[0], probs[0]  # block 0 sees the same input in both
    n = got.numel()
    assert not bool((ref == 0).any())
    share = float((got == 0).double().mean())
    assert abs(share - rate) <= 4 * np.sqrt(rate * (1 - rate) / n), share
    kept = got != 0
    np.testing.assert_allclose(got[kept].numpy(), (ref[kept] / (1 - rate)).numpy(), rtol=1e-12)
    torch.testing.assert_close(roll, ops.rollout_from_probs_plain(probs), rtol=0, atol=0)
    assert not torch.allclose(roll, roll_eval)

    # the output is the dropped weights times v
    qkv = vit.blocks[0].attn.qkv(vit.blocks[0].norm1(vit.embed(x)))
    gen = torch.Generator().manual_seed(5)
    out, dropped = port_vit._attention_dropped(qkv, cfg.num_heads, cfg.scale, rate, gen)
    B, N, C3 = qkv.shape
    v = qkv.reshape(B, N, 3, cfg.num_heads, -1)[:, :, 2].transpose(1, 2)
    want = torch.matmul(dropped, v).transpose(1, 2).reshape(B, N, C3 // 3)
    torch.testing.assert_close(out, want, rtol=1e-12, atol=1e-12)

    # JAX's attention dropout: the same statistics from its own stream
    jcfg = JaxViTConfig(img_size=(64, 32), patch_size=16, stride_size=(16, 16),
                        embed_dim=96, depth=2, num_heads=4, mlp_ratio=2.0,
                        attn_drop_rate=rate, drop_rate=0.0)
    p = {"proj": {"w": jnp.eye(96, dtype=jnp.float64), "b": jnp.zeros(96, jnp.float64)}}
    jqkv = jnp.asarray(qkv.detach().numpy())
    _, jref = jax_vit._attention_core(p, jqkv, jcfg, False, None)
    _, jgot = jax_vit._attention_core(p, jqkv, jcfg, True, jax.random.PRNGKey(4))
    jref, jgot = np.asarray(jref), np.asarray(jgot)
    np.testing.assert_allclose(jref, ref.numpy(), rtol=1e-12)
    jshare = float((jgot == 0).mean())
    assert abs(jshare - rate) <= 4 * np.sqrt(rate * (1 - rate) / jgot.size), jshare
    np.testing.assert_allclose(jgot[jgot != 0], jref[jgot != 0] / (1 - rate), rtol=1e-12)


def _train_grads(remat: bool, policy: str, skip: int):
    rng = np.random.RandomState(0)
    imgs = {m: torch.from_numpy(rng.randn(4, 64, 32, 3)) for m in MODS}
    vit = vit_tiny_test_config(img_size=(64, 32), patch_size=16, stride_size=(16, 16),
                               camera=4, drop_path_rate=0.1, drop_rate=0.1,
                               attn_drop_rate=0.1, remat=remat, remat_policy=policy,
                               remat_skip_last=skip)
    model = editor_init(EditorConfig(num_classes=6, vit=vit, head_keep=2, frequency_keep=3),
                        seed=0, device="cpu").double()
    gen = torch.Generator().manual_seed(7)
    out = model(imgs, torch.tensor([0, 1, 2, 3]), training=True,
                labels=torch.tensor([0, 0, 1, 1]), generator=gen)
    loss = out.score.square().sum() + out.cls4t.sum() + out.aux_loss
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    return loss.detach(), grads, gen.get_state()


@pytest.mark.parametrize("skip", [0, 1])
@pytest.mark.parametrize("policy", list(port_vit.REMAT_POLICIES))
def test_remat_with_dropout_equals_no_remat(policy, skip):
    loss0, grads0, state0 = _train_grads(False, "block", 0)
    loss, grads, state = _train_grads(True, policy, skip)
    assert torch.equal(loss, loss0)
    assert grads.keys() == grads0.keys()
    for name, g in grads.items():
        assert torch.equal(g, grads0[name]), name
    assert torch.equal(state, state0)


def test_unknown_remat_policy_raises():
    vit = vit_tiny_test_config(img_size=(64, 32), patch_size=16, stride_size=(16, 16),
                               remat=True, remat_policy="everything")
    model = editor_init(EditorConfig(num_classes=6, vit=vit), seed=0, device="cpu")
    imgs = {m: torch.zeros(2, 64, 32, 3) for m in MODS}
    with pytest.raises(ValueError, match="remat policy"):
        model(imgs, training=True, labels=torch.tensor([0, 1]),
              generator=torch.Generator())
