"""Shared helpers for the CNN zoo's parity tests (tests/test_torch_zoo*.py).

The JAX zoo's parameter shapes come from ``jax.eval_shape`` of its ``init``
(no PRNG draws); the build order is read inside the trace, where the tree
still has its insertion order (JAX's flattening sorts dict keys). Weights
are numpy arrays drawn from a seed onto those shapes, every BatchNorm tensor
at random (running mean N(0, 0.5), variance U(0.5, 2), weight U(0.5, 1.5),
bias N(0, 0.2)), so a swapped mean/var or weight/bias shows. JAX's ``apply``
runs under ``jax.jit``; the port gets the same arrays through
``state_dict_from_jax_zoo`` and runs on one thread.
"""

from __future__ import annotations

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from editor_tpu.models.zoo import MODEL_FACTORY as JAX_FACTORY

# input sizes of the fixed- or minimum-size architectures
# (tests/test_zoo_golden.py:28-35); every other entry runs at 64x32
HW = {
    "squeezenet1_0": (64, 64), "squeezenet1_0_fc512": (64, 64), "squeezenet1_1": (64, 64),
    "xception": (128, 64), "inceptionv4": (160, 96), "inceptionresnetv2": (160, 96),
    "nasnsetmobile": (96, 96), "mudeep": (256, 128), "hacnn": (160, 64), "pcb_p6": (96, 32),
    "cal": (128, 64),
}

# JAX leaf name -> the port's
TORCH_LEAF = {"w": "weight", "b": "bias", "mean": "running_mean", "var": "running_var"}


def _ordered_map(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree, keeping dict insertion order."""
    if isinstance(tree, dict):
        return {k: _ordered_map(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_ordered_map(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


# one entry for each code path, in the three forward-parity files
FORWARD_NAMES = {
    "resnet": ["resnet18", "resnext50_32x4d", "resnet50_fc512", "resnet50_ibn_a",
               "resnet50_ibn_b", "pcb_p4", "resnet50mid", "se_resnet50_fc512",
               "se_resnext50_32x4d", "densenet121_fc512"],
    "light": ["inceptionv4", "inceptionresnetv2", "xception", "nasnsetmobile",
              "mobilenetv2_x1_4", "shufflenet", "squeezenet1_0_fc512", "squeezenet1_1",
              "shufflenet_v2_x0_5"],
    "reid": ["osnet_x0_25", "osnet_ibn_x1_0", "osnet_ain_x0_25", "mudeep", "hacnn", "mlfn",
             "cal"],
}


@functools.lru_cache(maxsize=None)
def jax_template(name: str, nc: int):
    """The JAX zoo module and its parameter tree of ``jax.ShapeDtypeStruct``s
    in build order (cached: the structure and forward tests of a file share
    one trace)."""
    mod = JAX_FACTORY[name](nc)
    box = {}

    def init(key):
        p = mod.init(key)
        box["tree"] = _ordered_map(lambda path, t: jax.ShapeDtypeStruct(t.shape, t.dtype), p)
        return p

    jax.eval_shape(init, jax.random.PRNGKey(0))
    return mod, box["tree"]


def torch_kind_shape(path, shape):
    """A JAX leaf's (torch leaf name, shape in the torch layout)."""
    leaf = path[-1]
    shape = tuple(shape)
    if len(shape) == 4:
        shape = ((shape[3], shape[2], shape[0], shape[1]) if leaf == "w"
                 else (shape[0], shape[3], shape[1], shape[2]))
    elif len(shape) == 2 and leaf == "w":
        shape = shape[::-1]
    return TORCH_LEAF.get(leaf, leaf), shape


def ordered_structure(name: str, nc: int):
    """(the port's slot stream, JAX's ordered leaves in the torch layout):
    (leaf name, shape) each, for the same class count."""
    from editor_tpu.utils.zoo_import import ordered_leaf_paths
    from editor_tpu_torch.models.zoo import build_empty
    from editor_tpu_torch.utils.zoo_import import module_slots

    _, template = jax_template(name, nc)
    want = [torch_kind_shape(path, leaf.shape) for path, leaf in ordered_leaf_paths(template)]
    got = [(key.rpartition(".")[2], tuple(t.shape))
           for key, t in module_slots(build_empty(name, nc))]
    return got, want


def draw_params(template, seed: int = 0):
    """numpy float64 weights on the template's shapes, in its order."""
    rng = np.random.default_rng(seed)

    def draw(path, t):
        leaf, shape = path[-1], tuple(t.shape)
        if leaf == "mean":
            return rng.normal(0.0, 0.5, shape)
        if leaf == "var":
            return rng.uniform(0.5, 2.0, shape)
        if leaf == "b":
            return rng.normal(0.0, 0.2, shape)
        if leaf == "w" and len(shape) == 4:
            return rng.normal(0.0, (2.0 / (shape[0] * shape[1] * shape[2])) ** 0.5, shape)
        if leaf == "w" and len(shape) == 2:
            bound = shape[0] ** -0.5
            return rng.uniform(-bound, bound, shape)
        if leaf == "w":
            return rng.uniform(0.5, 1.5, shape)
        return rng.uniform(0.0, 1.0, shape)  # MuDeep's fusion weights

    return _ordered_map(draw, template)


def images(name: str, batch: int, seed: int = 1) -> np.ndarray:
    """NHWC float64 images at the entry's test size."""
    h, w = HW.get(name, (64, 32))
    return np.random.RandomState(seed).randn(batch, h, w, 3)


def jax_forward(mod, params, x_nhwc: np.ndarray) -> np.ndarray:
    """JAX's ``apply`` under ``jax.jit``, compiled without LLVM's expensive
    passes (a third less compile time here, the same run time)."""
    p = _ordered_map(lambda path, a: jnp.asarray(a), params)
    x = jnp.asarray(x_nhwc)
    compiled = jax.jit(mod.apply).lower(p, x).compile(
        compiler_options={"xla_llvm_disable_expensive_passes": True})
    return np.asarray(compiled(p, x))


@contextlib.contextmanager
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def port_forward(module, x_nhwc: np.ndarray) -> np.ndarray:
    with one_thread(), torch.no_grad():
        x = torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2)))
        return module(x).numpy()


def port_module(name: str, nc: int, state_dict) -> torch.nn.Module:
    """The port's entry at float64 on the CPU with ``state_dict`` loaded
    strictly."""
    from editor_tpu_torch.models.zoo import build_empty

    m = build_empty(name, nc).to_empty(device="cpu").double().eval()
    m.load_state_dict(state_dict, strict=True)
    return m


def max_rel_err(got: np.ndarray, ref: np.ndarray) -> float:
    """Largest absolute difference over the reference's largest magnitude."""
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


# f64 parity: the reference goldens saw <= 5e-15; CAL's sign-sqrt of
# near-zero BAP entries conditions its comparison (~1e-8)
TOL = 1e-12
TOL_BY_NAME = {"cal": 1e-8}


# the heaviest CPU forwards run one image (the others two, so a forward
# that mixed the batch's rows would show)
ONE_IMAGE = ("xception", "inceptionv4", "inceptionresnetv2", "nasnsetmobile")


def forward_parity(name: str, nc: int = 7) -> float:
    """The port's logits against JAX's at f64 on the same seeded weights and
    images (B = 2, ``ONE_IMAGE`` B = 1): the largest difference over the
    largest JAX logit. The weights reach the port through ``state_dict_from_jax_zoo``
    given the entry's name (its class count inferred)."""
    from editor_tpu_torch.utils.zoo_import import state_dict_from_jax_zoo

    mod, template = jax_template(name, nc)
    params = draw_params(template, seed=0)
    x = images(name, 1 if name in ONE_IMAGE else 2)
    ref = jax_forward(mod, params, x)
    got = port_forward(port_module(name, nc, state_dict_from_jax_zoo(name, params)), x)
    assert np.isfinite(ref).all()
    return max_rel_err(got, ref)
