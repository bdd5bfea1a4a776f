"""The port's train step against the JAX ``build_train_step`` at float64, and
the device default of the port's entry points.

Two SGD steps on the tiny config (depth 2, width 96), B = 8 (4 ids x 2),
``drop_path_rate=0``, no augmentation, from the same weights and batch; then
the same with ``grad_accum=2``. Compared after each step: loss, acc and lr;
after the second: every parameter (through ``state_dict_from_jax``), the BN
running stats and the OCFR centers.

Tolerances. The JAX step at f64 still rounds through fp32 where its
functions say so whatever the input dtype: the drop-path branch
(vit.py:302-303, also at rate 0), the BCC and OCFR losses and centers
(sfts.py:68, ocfr.py:54-64), the aux loss (editor.py:366), the schedule's lr
(schedule.py:42) and, with grad_accum, the loss metric (train.py:176). The
port rounds at the same points, but the fp32 sums run in another order, so:
loss rtol 1e-7 (measured <= 4e-8); lr rtol 1e-6; the OCFR centers rtol 1e-6 /
atol 1e-7; each parameter's change over the two steps within 1e-7 of that
tensor's largest change (measured <= 2.4e-8; biases whose gradient is zero
by symmetry, e.g. the reduce heads' in front of the fused BN, move by ~1e-20
and are held to atol 1e-15); the BN running stats (entries of order
0.01-1) rtol 1e-7 / atol 1e-8 (measured <= 7e-10).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from editor_tpu.config import Config as JaxConfig
from editor_tpu.engine import build_train_step as jax_build_train_step
from editor_tpu.engine import make_train_state
from editor_tpu.losses import make_loss as jax_make_loss
from editor_tpu.models.editor import EditorConfig as JaxEditorConfig
from editor_tpu.models.vit import ViTConfig as JaxViTConfig
from editor_tpu.solver import make_optimizer as jax_make_optimizer
from editor_tpu.solver import make_scheduler as jax_make_scheduler
from editor_tpu_torch.config import Config
from editor_tpu_torch.engine.train import build_train_step
from editor_tpu_torch.losses import make_loss
from editor_tpu_torch.models.editor import Editor, EditorConfig, vit_tiny_test_config
from editor_tpu_torch.models.init import editor_init
from editor_tpu_torch.solver import make_optimizer, make_scheduler
from editor_tpu_torch.utils.jax_weights import state_dict_from_jax
from tests.torch_parity import port_editor, to_numpy_tree, x64  # noqa: F401

B = 8


def _setup(grad_accum):
    vit = JaxViTConfig(img_size=(64, 32), patch_size=16, stride_size=(16, 16),
                       embed_dim=96, depth=2, num_heads=4, mlp_ratio=2.0, camera=4,
                       drop_path_rate=0.0)
    jcfg = JaxEditorConfig(num_classes=4, vit=vit, head_keep=2, frequency_keep=3,
                           use_pallas=False)
    cfg = JaxConfig()
    from editor_tpu.models.editor import editor_init as jax_editor_init
    params, _ = jax_editor_init(jax.random.PRNGKey(0), jcfg)
    opt = jax_make_optimizer(cfg, params)
    state = make_train_state(jax.random.PRNGKey(0), jcfg, opt)
    state = jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float64) if x.dtype == jnp.float32 else x, state)
    step = jax_build_train_step(jcfg, opt, jax_make_loss(cfg, 4), jax_make_scheduler(cfg),
                                cfg.SOLVER.BASE_LR, compute_dtype=jnp.float64, donate=False,
                                grad_accum=grad_accum)
    rng = np.random.RandomState(1)
    batch = {m: rng.randn(B, 64, 32, 3) for m in ("RGB", "NI", "TI")}
    # 4 ids x 2; with grad_accum=2 each microbatch holds 2 ids x 2
    batch["pid"] = np.array([0, 0, 1, 1, 2, 2, 3, 3])
    batch["camid"] = np.arange(B) % 4
    return jcfg, state, step, batch


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_two_train_steps_match_jax(x64, grad_accum):
    jcfg, state, step, batch = _setup(grad_accum)
    params0 = to_numpy_tree(state.params)
    mstate0 = to_numpy_tree(state.model_state)
    model = port_editor(jcfg, params0, mstate0)
    tcfg = Config()
    tstep = build_train_step(model, make_optimizer(tcfg, model), make_loss(tcfg, 4),
                             make_scheduler(tcfg), tcfg.SOLVER.BASE_LR,
                             compute_dtype=torch.float64, grad_accum=grad_accum)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    for epoch in (1, 2):
        state, ref = step(state, jbatch, jnp.asarray(epoch))
        got = tstep(tbatch, epoch)
        np.testing.assert_allclose(float(got["loss"]), float(ref["loss"]), rtol=1e-7)
        assert float(got["acc"]) == float(ref["acc"])
        np.testing.assert_allclose(got["lr"], float(ref["lr"]), rtol=1e-6)

    ref_sd = state_dict_from_jax(to_numpy_tree(state.params),
                                 to_numpy_tree(state.model_state), jcfg)
    sd0 = state_dict_from_jax(params0, mstate0, jcfg)
    got_sd = model.state_dict()
    for name, _ in model.named_parameters():
        start = sd0[name].numpy()
        d_got, d_ref = got_sd[name].numpy() - start, ref_sd[name].numpy() - start
        np.testing.assert_allclose(d_got, d_ref, rtol=0,
                                   atol=max(1e-7 * np.abs(d_ref).max(), 1e-15), err_msg=name)
    for name in ("FUSE_BN", "BACKBONE_BN"):
        for stat in ("running_mean", "running_var"):
            key = f"{name}.{stat}"
            assert not np.allclose(got_sd[key].numpy(), sd0[key].numpy())  # moved
            np.testing.assert_allclose(got_sd[key].numpy(), ref_sd[key].numpy(), rtol=1e-7,
                                       atol=1e-8, err_msg=key)
    for mod in ("RGB", "NIR", "TIR"):
        key = f"FUSE_block.memory_cls.{mod}_centers"
        np.testing.assert_allclose(got_sd[key].numpy(), ref_sd[key].numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=key)
    assert int(model.FUSE_BN.num_batches_tracked) == 2 * grad_accum


def _tiny_port_cfg():
    vit = vit_tiny_test_config(img_size=(64, 32), patch_size=16, stride_size=(16, 16),
                               camera=4)
    return EditorConfig(num_classes=10, vit=vit, head_keep=2, frequency_keep=3)


def test_entry_points_default_to_cuda(monkeypatch):
    """Editor and editor_init build on the card unless asked for the CPU;
    without a card and without a device they raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _tiny_port_cfg()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        editor_init(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Editor(cfg)
    model = editor_init(cfg, device="cpu")
    assert next(model.parameters()).device.type == "cpu"


def test_train_step_on_cpu_runs_augment_drop_path_and_learns():
    """The step with its defaults around it: uint8 images through the
    augment, drop path 0.1, fp32 compute on the CPU; the loss on one fixed
    batch goes down over a few steps at the post-warmup lr."""
    from editor_tpu_torch.data.transforms import make_train_augment

    cfg = _tiny_port_cfg()
    model = editor_init(cfg, seed=0, device="cpu")
    tcfg = Config()
    step = build_train_step(model, make_optimizer(tcfg, model), make_loss(tcfg, 10),
                            make_scheduler(tcfg), 0.01, compute_dtype=torch.float32,
                            augment=make_train_augment(tcfg.INPUT), seed=3)
    gen = torch.Generator().manual_seed(4)
    batch = {m: torch.randint(0, 256, (8, 64, 32, 3), generator=gen, dtype=torch.uint8)
             for m in ("RGB", "NI", "TI")}
    batch["pid"] = torch.tensor([0, 0, 1, 1, 2, 2, 3, 3])
    batch["camid"] = torch.arange(8) % 4
    losses = [float(step(batch, 15)["loss"]) for _ in range(6)]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-2:]) < np.mean(losses[:2]), losses
