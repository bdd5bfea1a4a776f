"""Shared helpers for the PyTorch port's parity tests (tests/test_torch_*.py).

Both packages get the same inputs, made with numpy from a seed; the JAX
package is the oracle and runs on the CPU through its plain XLA paths.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from editor_tpu_torch.tools._bench import ulp_of_max  # noqa: F401  (re-exported)

# Where top-k decides the result the comparison runs at float64: at f32 the
# rollout's per-head top-k has near-ties that 1e-7 noise can flip.
RTOL_F64, ATOL_F64 = 1e-9, 1e-12
# f32 ops: both sides accumulate in fp32 in different orders
RTOL_F32, ATOL_F32 = 1e-5, 1e-6


def tolerances(dtype) -> dict:
    if np.dtype(dtype) == np.float64:
        return dict(rtol=RTOL_F64, atol=ATOL_F64)
    return dict(rtol=RTOL_F32, atol=ATOL_F32)


@pytest.fixture(scope="module")
def x64(request):
    """JAX float64 for the module; restored afterwards."""
    jax.config.update("jax_enable_x64", True)
    request.addfinalizer(lambda: jax.config.update("jax_enable_x64", False))


def to_numpy_tree(tree, dtype=None):
    def conv(x):
        a = np.asarray(x)
        return a.astype(dtype) if dtype is not None and a.dtype.kind == "f" else a
    return jax.tree_util.tree_map(conv, tree)


def torch_vit_config(jcfg):
    """The port's ViTConfig with the same fields as a JAX ViTConfig."""
    import dataclasses

    from editor_tpu_torch.models.vit import ViTConfig
    return ViTConfig(**dataclasses.asdict(jcfg))


def torch_editor_config(jcfg, **overrides):
    import dataclasses

    from editor_tpu_torch.models.editor import EditorConfig
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    fields["vit"] = torch_vit_config(jcfg.vit)
    fields.update(overrides)
    return EditorConfig(**fields)


def jax_editor(jcfg, seed: int = 0, dtype=np.float64):
    """JAX ``editor_init`` params and state as numpy trees of ``dtype``."""
    from editor_tpu.models.editor import editor_init
    params, state = editor_init(jax.random.PRNGKey(seed), jcfg)
    return to_numpy_tree(params, dtype), to_numpy_tree(state, dtype)


def port_editor(jcfg, params_np, state_np, dtype=torch.float64, **overrides):
    """The port's Editor loaded (strictly) with the JAX weights."""
    from editor_tpu_torch.models.editor import Editor
    from editor_tpu_torch.utils.jax_weights import state_dict_from_jax
    model = Editor(torch_editor_config(jcfg, **overrides), device="cpu").to(dtype)
    model.load_state_dict(state_dict_from_jax(params_np, state_np, jcfg), strict=True)
    return model


def bf16_pair(a):
    """The same bf16 values for both sides (each side rounds to nearest even):
    a JAX array and a torch tensor."""
    import jax.numpy as jnp

    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(np.asarray(a, np.float32)).bfloat16()


def assert_close(got, ref, dtype=np.float64, **tol):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), **(tol or tolerances(dtype)))


@pytest.fixture(scope="module")
def jax_native_private(tmp_path_factory):
    """The JAX package's native libraries built anew into a directory of this
    module's own (``EDITOR_TPU_NATIVE_CACHE``): its loader compiles straight
    into the shared package directory, where another test process building
    at the same moment could hand this one a half-written file."""
    import editor_tpu.native as jax_native

    mp = pytest.MonkeyPatch()
    mp.setenv("EDITOR_TPU_NATIVE_CACHE", str(tmp_path_factory.mktemp("jax_native")))
    for name, value in (("_LIB", None), ("_BUILD_FAILED", False), ("_CODEC_LIB", None),
                        ("_CODEC_FAILED", False)):
        mp.setattr(jax_native, name, value)
    yield jax_native
    mp.undo()
