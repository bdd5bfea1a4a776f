"""JAX oracles and shared inputs of the port's data-parallel step tests
(``tests/test_torch_dp_step.py``, ``tests/test_torch_dp_ddp.py``,
``tests/test_torch_dp_loop.py``): the tiny config and batch of
``tests/test_torch_train_step.py`` (depth 2, width 96, B = 8 as 4 ids x 2,
drop path 0, no augmentation) at float64, JAX's mesh and DDP steps on the
first W of the conftest's 8 virtual CPU devices (each built and compiled
once a process; the DDP step once for all five reducers), and the comparison at ``test_torch_train_step.py``'s
tolerances.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from editor_tpu.config import Config as JaxConfig
from editor_tpu.engine import build_train_step as jax_build_train_step
from editor_tpu.engine import make_train_state
from editor_tpu.engine.train import fsdp_state_shardings as jax_fsdp_state_shardings
from editor_tpu.losses import make_loss as jax_make_loss
from editor_tpu.models.editor import EditorConfig as JaxEditorConfig
from editor_tpu.models.editor import editor_init as jax_editor_init
from editor_tpu.models.vit import ViTConfig as JaxViTConfig
from editor_tpu.parallel.compression import Reducer
from editor_tpu.parallel.compression import make_reducer as jax_make_reducer
from editor_tpu.parallel.ddp import DDPState, build_ddp_train_step
from editor_tpu.parallel.mesh import make_mesh as jax_make_mesh
from editor_tpu.parallel.mesh import shard_batch as jax_shard_batch
from editor_tpu.solver import make_optimizer as jax_make_optimizer
from editor_tpu.solver import make_scheduler as jax_make_scheduler
from editor_tpu_torch.utils.jax_weights import state_dict_from_jax
from tests.torch_parity import to_numpy_tree, torch_editor_config

B = 8
REDUCERS = ("allreduce", "fp16", "bf16", "int8", "powersgd")


def tiny_jax_config():
    """The JAX EditorConfig of these tests (depth 2, width 96, drop path 0)."""
    vit = JaxViTConfig(img_size=(64, 32), patch_size=16, stride_size=(16, 16),
                       embed_dim=96, depth=2, num_heads=4, mlp_ratio=2.0, camera=4,
                       drop_path_rate=0.0)
    return JaxEditorConfig(num_classes=4, vit=vit, head_keep=2, frequency_keep=3,
                           use_pallas=False)


@functools.lru_cache(maxsize=None)
def jax_setup():
    """(JAX EditorConfig, Config, optimizer, float64 train state), made once
    a process."""
    jcfg = tiny_jax_config()
    cfg = JaxConfig()
    params, _ = jax_editor_init(jax.random.PRNGKey(0), jcfg)
    opt = jax_make_optimizer(cfg, params)
    state = make_train_state(jax.random.PRNGKey(0), jcfg, opt)
    state = jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float64) if x.dtype == jnp.float32 else x, state)
    return jcfg, cfg, opt, state


def make_batch(cross_shard: bool = False):
    rng = np.random.RandomState(1)
    batch = {m: rng.randn(B, 64, 32, 3) for m in ("RGB", "NI", "TI")}
    batch["pid"] = np.array([0, 0, 1, 1, 2, 2, 3, 3])
    batch["camid"] = np.arange(B) % 4
    if cross_shard:  # identity 2 (rank 1's rows) a near copy of identity 0 (rank 0's)
        for m in ("RGB", "NI", "TI"):
            batch[m][4:6] = batch[m][0:2] + 0.01 * rng.randn(2, 64, 32, 3)
    return batch


@functools.lru_cache(maxsize=None)
def jax_global_step(W, grad_accum):
    """JAX's mesh step, built (and compiled at its first call) once a module."""
    jcfg, cfg, opt, _ = jax_setup()
    mesh = jax_make_mesh(data=W, model=1, devices=jax.devices()[:W])
    return mesh, jax_build_train_step(jcfg, opt, jax_make_loss(cfg, 4),
                                      jax_make_scheduler(cfg), cfg.SOLVER.BASE_LR,
                                      compute_dtype=jnp.float64, mesh=mesh, donate=False,
                                      grad_accum=grad_accum)


@functools.lru_cache(maxsize=None)
def jax_fsdp_step(W, grad_accum):
    """JAX's FSDP step (``state_shardings=fsdp_state_shardings``,
    ``gather_params_compute=True``) and its state layout, built once a
    module."""
    jcfg, cfg, opt, state = jax_setup()
    mesh = jax_make_mesh(data=W, model=1, devices=jax.devices()[:W])
    shardings = jax_fsdp_state_shardings(state, mesh)
    return mesh, shardings, jax_build_train_step(
        jcfg, opt, jax_make_loss(cfg, 4), jax_make_scheduler(cfg), cfg.SOLVER.BASE_LR,
        compute_dtype=jnp.float64, mesh=mesh, donate=False, grad_accum=grad_accum,
        state_shardings=shardings, gather_params_compute=True)


def jax_fsdp(state, batch, W, grad_accum=1, steps=2):
    """JAX's FSDP run: (losses, the sharded train state after it, mesh)."""
    mesh, shardings, step = jax_fsdp_step(W, grad_accum)
    state = jax.tree_util.tree_map(jax.device_put, state, shardings)
    feed = jax_shard_batch(mesh, {k: jnp.asarray(v) for k, v in batch.items()})
    losses = []
    for epoch in range(1, steps + 1):
        state, m = step(state, feed, jnp.asarray(epoch))
        losses.append(float(m["loss"]))
    return losses, state, mesh


def device_shards(leaf, mesh):
    """A JAX array's block on each device of the mesh's data axis, in
    order."""
    order = {d: i for i, d in enumerate(mesh.devices.flat)}
    out = [None] * len(order)
    for sh in leaf.addressable_shards:
        out[order[sh.device]] = np.asarray(sh.data)
    return out


def switch_reducer():
    """JAX's five reducers (``REDUCERS``) behind one selector in the state
    (``which``), so that one ``build_ddp_train_step`` compile serves them
    all: each branch of a ``lax.switch`` is the JAX reducer's own
    ``reduce``; the stateless ones pass PowerSGD's state (``ps``) through."""
    reds = [jax_make_reducer(name, rank=4) for name in REDUCERS]
    ps = reds[-1]

    def branch(red):
        def f(grads, ps_state, axis_name):
            if red is ps:
                return red.reduce(grads, ps_state, axis_name)
            return red.reduce(grads, (), axis_name)[0], ps_state
        return f

    def init(template):
        return {"which": jnp.int32(0), "ps": ps.init(template)}

    def reduce(grads, state, axis_name):
        out, new_ps = lax.switch(state["which"],
                                 [functools.partial(branch(r), axis_name=axis_name)
                                  for r in reds], grads, state["ps"])
        return out, {"which": state["which"], "ps": new_ps}

    return Reducer(init, reduce, "switch")


@functools.lru_cache(maxsize=None)
def jax_ddp_step(W):
    """JAX's DDP step over ``switch_reducer``, built once a module."""
    jcfg, cfg, opt, _ = jax_setup()
    mesh = jax_make_mesh(data=W, model=1, devices=jax.devices()[:W])
    red = switch_reducer()
    return mesh, red, build_ddp_train_step(jcfg, opt, jax_make_loss(cfg, 4),
                                           jax_make_scheduler(cfg), cfg.SOLVER.BASE_LR, mesh,
                                           reducer=red, compute_dtype=jnp.float64)


def jax_global(state, batch, W, grad_accum=1, steps=2):
    mesh, step = jax_global_step(W, grad_accum)
    feed = jax_shard_batch(mesh, {k: jnp.asarray(v) for k, v in batch.items()})
    losses = []
    for epoch in range(1, steps + 1):
        state, m = step(state, feed, jnp.asarray(epoch))
        losses.append(float(m["loss"]))
    return losses, state


def jax_ddp(state, batch, W, name, steps=2):
    """JAX's DDP step with reducer ``name``: (losses, train state after
    each step, PowerSGD's initial state)."""
    mesh, red, step = jax_ddp_step(W)
    comm0 = dict(red.init(state.params), which=jnp.int32(REDUCERS.index(name)))
    dd = DDPState(train=state, comm=comm0)
    feed = jax_shard_batch(mesh, {k: jnp.asarray(v) for k, v in batch.items()})
    losses, states = [], []
    for epoch in range(1, steps + 1):
        dd, m = step(dd, feed, jnp.asarray(epoch))
        losses.append(float(m["loss"]))
        states.append(dd.train)
    return losses, states, comm0["ps"]


def port_inputs(jcfg, state, batch, **kw):
    sd = state_dict_from_jax(to_numpy_tree(state.params), to_numpy_tree(state.model_state),
                             jcfg)
    return dict(ecfg=torch_editor_config(jcfg), sd=sd, batch=batch, steps=2, **kw)


def jax_state_dict(jcfg, state):
    return state_dict_from_jax(to_numpy_tree(state.params), to_numpy_tree(state.model_state),
                               jcfg)


def close_to_jax(got, ref_losses, ref_sd, sd0, param_tol=1e-7, what="", sd=None):
    """The port's run ``got`` against a JAX run: losses and the final state
    (or ``sd``), at test_torch_train_step.py's tolerances. Returns whether
    it held."""
    try:
        np.testing.assert_allclose(got["loss"], ref_losses, rtol=1e-7)
        sd = got["sd"] if sd is None else sd
        for name, start in sd0.items():
            if name.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(sd[name].numpy(), ref_sd[name].numpy(), rtol=1e-7,
                                           atol=1e-8, err_msg=name)
            elif name.endswith("_centers"):
                np.testing.assert_allclose(sd[name].numpy(), ref_sd[name].numpy(), rtol=1e-6,
                                           atol=1e-7, err_msg=name)
            elif sd[name].is_floating_point() and "FREQ_INDEX" not in name:
                d_got = sd[name].numpy() - start.numpy()
                d_ref = ref_sd[name].numpy() - start.numpy()
                np.testing.assert_allclose(
                    d_got, d_ref, rtol=0, err_msg=f"{what} {name}",
                    atol=max(param_tol * np.abs(d_ref).max(), 1e-15))
    except AssertionError:
        return False
    return True
