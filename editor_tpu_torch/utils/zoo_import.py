"""Weights for the CNN zoo's modules: torch checkpoints by position, and the
JAX zoo's parameters (``editor_tpu/utils/zoo_import.py``).

A torch ``state_dict`` iterates in registration order (depth first, a
module's parameters before its buffers), which every zoo module shares with
the reference's models and with the JAX DSL's build order. So the importer
needs no per-architecture table: it groups the checkpoint's tensors by
module, emits each in canonical slot order (BatchNorm as running_mean,
running_var, weight, bias; ``num_batches_tracked`` dropped) and zips them
one to one onto the module's own slots in the same order. A reference or
torchreid checkpoint loads whatever names the port's modules carry; the
port's own ``state_dict`` also loads with ``load_state_dict(strict=True)``.

A slot is every parameter and buffer of the module but
``num_batches_tracked`` and the frozen zero biases of ``BatchNorm(bias=
False)`` (CAL's), which JAX models as bias-free BNs. Any count or shape
divergence raises ``ValueError``.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Iterator, List, Mapping, Sequence, Tuple

import numpy as np
import torch
from torch import nn

__all__ = ["frozen_bias_keys", "load_torch_zoo_state", "module_slots", "ordered_leaf_paths",
           "state_dict_from_jax_zoo"]

Path = Tuple[Any, ...]


def ordered_leaf_paths(tree: Any, path: Path = ()) -> Iterator[Tuple[Path, Any]]:
    """(path, leaf) of a JAX zoo parameter tree in build order: dict
    insertion order, not the sorted order of JAX's pytree flattening."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from ordered_leaf_paths(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from ordered_leaf_paths(v, path + (i,))
    elif tree is not None:
        yield path, tree


def _group_by_module(keys: Sequence[str]) -> List[Tuple[str, List[str]]]:
    """Consecutive keys that share a module prefix."""
    groups: List[Tuple[str, List[str]]] = []
    for key in keys:
        prefix, _, leaf = key.rpartition(".")
        if groups and groups[-1][0] == prefix:
            groups[-1][1].append(leaf)
        else:
            groups.append((prefix, [leaf]))
    return groups


def _canonical_stream(state: Mapping[str, Any]) -> List[Tuple[str, Any]]:
    """(key, value) in slot order: BatchNorm's four in JAX's order (mean,
    var, weight, bias; torch registers weight and bias first),
    ``num_batches_tracked`` dropped."""
    out = []
    for prefix, leaves in _group_by_module(list(state)):
        full = lambda leaf: f"{prefix}.{leaf}" if prefix else leaf  # noqa: E731
        if "running_mean" in leaves:
            order = [lf for lf in ("running_mean", "running_var", "weight", "bias")
                     if lf in leaves]
        else:
            order = [lf for lf in leaves if lf != "num_batches_tracked"]
        out += [(full(lf), state[full(lf)]) for lf in order]
    return out


def frozen_bias_keys(module: nn.Module) -> set:
    """The state_dict keys of the module's frozen BN biases (no slot)."""
    from editor_tpu_torch.models.zoo.common import BatchNorm

    return {f"{name}.bias" if name else "bias" for name, m in module.named_modules()
            if isinstance(m, BatchNorm) and m.frozen_bias}


def module_slots(module: nn.Module) -> List[Tuple[str, torch.Tensor]]:
    """The module's own slots (its parameters and buffers themselves) in
    canonical order."""
    frozen = frozen_bias_keys(module)
    state = {k: v for k, v in module.state_dict(keep_vars=True).items() if k not in frozen}
    return _canonical_stream(state)


@torch.no_grad()
def load_torch_zoo_state(module: nn.Module, state_dict: Mapping[str, Any],
                         skip_keys: Sequence[str] = ()) -> nn.Module:
    """Copy a torch zoo checkpoint (tensors or numpy arrays) into ``module``
    by position and return it; values take the module's dtype and device.

    Storage-aliased duplicates are dropped, the later key kept: CAL
    registers its backbone twice (``base`` and the per-stage ``base_1..5``
    views, reference cal.py:276-295), and the later registration follows
    the build order. ``skip_keys`` drops tensors without a slot: the frozen
    zero BN biases (``bias.requires_grad_(False)``, cal.py:263), which are
    set to zero here."""
    drop = set(skip_keys)
    seen: Dict[Tuple[int, Tuple[int, ...]], str] = {}
    for k, v in state_dict.items():
        if isinstance(v, torch.Tensor):
            sig = (v.data_ptr(), tuple(v.shape))
            if sig in seen:
                drop.add(seen[sig])
            seen[sig] = k
    state = {k: v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
             for k, v in state_dict.items() if k not in drop}
    slots = module_slots(module)
    stream = _canonical_stream(state)
    if len(slots) != len(stream):
        raise ValueError(f"leaf count mismatch: module has {len(slots)} slots, "
                         f"state_dict provides {len(stream)} tensors")
    for (name, slot), (tname, t) in zip(slots, stream):
        if tuple(slot.shape) != tuple(t.shape):
            raise ValueError(
                f"shape mismatch at {name} (ours {tuple(slot.shape)}) vs torch {tname!r} "
                f"({tuple(t.shape)}) — build/registration order diverged")
    for (_, slot), (_, t) in zip(slots, stream):
        slot.copy_(t)
    own = module.state_dict(keep_vars=True)
    for key in frozen_bias_keys(module):
        own[key].zero_()
    return module


def _to_torch_layout(key: str, a: np.ndarray) -> np.ndarray:
    """JAX zoo layout -> torch: HWIO -> OIHW, ``[in, out]`` -> ``[out, in]``,
    a bare NHWC parameter (MuDeep's a1..a4) -> NCHW; vectors as they are."""
    leaf = key.rpartition(".")[2]
    if a.ndim == 4:
        return a.transpose(3, 2, 0, 1) if leaf == "weight" else a.transpose(0, 3, 1, 2)
    if a.ndim == 2 and leaf == "weight":
        return a.T
    return a


def _infer_num_classes(name: str, leaves) -> int:
    """The class count that makes ``name``'s slots fit ``leaves``: built
    with one class, the classifiers' slots hold 1 where the leaves hold it."""
    from editor_tpu_torch.models.zoo import build_empty

    found = set()
    for (key, slot), (_, leaf) in zip(module_slots(build_empty(name, 1)), leaves):
        a = _to_torch_layout(key, np.asarray(leaf))
        if a.shape != tuple(slot.shape) and a.ndim == slot.dim():
            found |= {n for s, n in zip(slot.shape, a.shape) if s == 1 and n != 1}
    if len(found) > 1:
        raise ValueError(f"{name}: the parameters fit no single class count ({sorted(found)})")
    return found.pop() if found else 1


def state_dict_from_jax_zoo(name_or_module, params: Any) -> "OrderedDict[str, torch.Tensor]":
    """The state_dict that makes the port's zoo module compute what the JAX
    zoo computes with ``params`` (its parameter tree, as numpy arrays or
    anything ``np.asarray`` takes), in the arrays' dtype. The leaves are
    walked in build order (``ordered_leaf_paths``) and put in the torch
    layout; ``num_batches_tracked`` and the frozen BN biases, which JAX does
    not hold, come out 0. Given a name, the module is built on ``meta``
    with the class count the parameters imply. Needs no JAX."""
    leaves = list(ordered_leaf_paths(params))
    if isinstance(name_or_module, nn.Module):
        module = name_or_module
    else:
        from editor_tpu_torch.models.zoo import build_empty

        module = build_empty(name_or_module, _infer_num_classes(name_or_module, leaves))
    slots = module_slots(module)
    if len(slots) != len(leaves):
        raise ValueError(f"leaf count mismatch: module has {len(slots)} slots, "
                         f"params provide {len(leaves)} leaves")
    filled = {}
    for (key, slot), (path, leaf) in zip(slots, leaves):
        a = _to_torch_layout(key, np.asarray(leaf))
        if a.shape != tuple(slot.shape):
            raise ValueError(f"shape mismatch at {key} (ours {tuple(slot.shape)}) vs JAX "
                             f"{'/'.join(map(str, path))} ({a.shape})")
        filled[key] = torch.from_numpy(np.ascontiguousarray(a))
    dtype = next(iter(filled.values())).dtype if filled else torch.float32
    out = OrderedDict()
    for key, t in module.state_dict().items():
        if key in filled:
            out[key] = filled[key]
        else:  # num_batches_tracked, frozen biases
            out[key] = torch.zeros(t.shape, dtype=t.dtype if not t.is_floating_point() else dtype)
    return out
