"""Weight bridge: JAX EDITOR params/state (as numpy) -> the port's state_dict.

The same mapping as ``editor_tpu.utils.torch_convert.export_editor_to_torch``
without importing JAX: Linear weights [in, out] become torch's [out, in],
the HWIO patch conv becomes OIHW, the depth-stacked block parameters become
``blocks.{i}.*``, BN running stats and OCFR centers come from the state, and
the constant Haar filter buffers are added. Arrays keep their dtype. A
``(params, state)`` taken after JAX train steps maps the same way, so the
tests compare the two packages' parameters, BN running stats and OCFR
centers after a step through it (``num_batches_tracked``, which JAX does not
keep, comes out 0).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _a(x) -> np.ndarray:
    return np.asarray(x)


def _vit_entries(p: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    sd = {
        "cls_token": _a(p["cls_token"]),
        "pos_embed": _a(p["pos_embed"]),
        "patch_embed.proj.weight": _a(p["patch_embed"]["proj"]["w"]).transpose(3, 2, 0, 1),
        "patch_embed.proj.bias": _a(p["patch_embed"]["proj"]["b"]),
        "norm.weight": _a(p["norm"]["w"]),
        "norm.bias": _a(p["norm"]["b"]),
        "fc.weight": _a(p["fc"]["w"]).T,
        "fc.bias": _a(p["fc"]["b"]),
    }
    if "sie_embed" in p:
        sd["sie_embed"] = _a(p["sie_embed"])
    b = p["blocks"]
    for i in range(_a(b["norm1"]["w"]).shape[0]):
        pre = f"blocks.{i}."
        for ln in ("norm1", "norm2"):
            sd[pre + ln + ".weight"] = _a(b[ln]["w"])[i]
            sd[pre + ln + ".bias"] = _a(b[ln]["b"])[i]
        for group, names in (("attn", ("qkv", "proj")), ("mlp", ("fc1", "fc2"))):
            for name in names:
                lin = b[group][name]
                sd[f"{pre}{group}.{name}.weight"] = _a(lin["w"])[i].T
                if "b" in lin:
                    sd[f"{pre}{group}.{name}.bias"] = _a(lin["b"])[i]
    return sd


def state_dict_from_jax(params: Mapping[str, Any], state: Mapping[str, Any],
                        ecfg) -> Dict[str, torch.Tensor]:
    """JAX ``editor_init``-layout params and state (nested dicts of arrays)
    -> a state_dict that :class:`~editor_tpu_torch.models.editor.Editor`
    loads with ``strict=True``."""
    if "moe_mlp" in params["FUSE_block"]:
        raise NotImplementedError("the MoE fusion MLP is not ported")
    sd = {f"BACKBONE.base.{k}": v for k, v in _vit_entries(params["BACKBONE"]).items()}

    fb = params["FUSE_block"]

    def put_ln(name):
        sd[f"FUSE_block.{name}.weight"] = _a(fb[name]["w"])
        sd[f"FUSE_block.{name}.bias"] = _a(fb[name]["b"])

    def put_linears(name, subs):
        for sub in subs:
            sd[f"FUSE_block.{name}.{sub}.weight"] = _a(fb[name][sub]["w"]).T

    for mod in ("R", "N", "T"):
        put_ln(f"norm{mod}")
        put_ln(f"norm{mod}_")
        put_linears(f"attn{mod}", ("qkv", "proj"))
        put_linears(f"mlp{mod}", ("fc1", "fc2"))
    put_ln("norm1")
    put_linears("attn1", ("qkv", "proj"))
    put_ln("norm2")
    put_linears("mlp", ("fc1", "fc2"))
    put_ln("out_norm")

    for name in ("RGB_REDUCE", "NIR_REDUCE", "TIR_REDUCE"):
        sd[f"{name}.weight"] = _a(params[name]["w"]).T
        if "b" in params[name]:
            sd[f"{name}.bias"] = _a(params[name]["b"])
    heads = ["FUSE_HEAD", "BACKBONE_HEAD"]
    bns = ["FUSE_BN", "BACKBONE_BN"]
    if getattr(ecfg, "al", False) and "AL_HEAD" in params:
        heads.append("AL_HEAD")
        bns.append("AL_BN")
    for name in heads:
        sd[f"{name}.weight"] = _a(params[name]["w"]).T
    for name in bns:
        sd[f"{name}.weight"] = _a(params[name]["w"])
        sd[f"{name}.bias"] = _a(params[name]["b"])
        sd[f"{name}.running_mean"] = _a(state["bn"][name]["mean"])
        sd[f"{name}.running_var"] = _a(state["bn"][name]["var"])
        sd[f"{name}.num_batches_tracked"] = np.asarray(0, np.int64)

    for ours, theirs in (("rgb", "RGB"), ("nir", "NIR"), ("tir", "TIR")):
        if ours in state.get("ocfr", {}):
            sd[f"FUSE_block.memory_cls.{theirs}_centers"] = _a(state["ocfr"][ours])

    # constant Haar taps: f32(1/sqrt(2)) in the params' dtype
    dt = _a(params["BACKBONE"]["cls_token"]).dtype
    s = np.float32(1.0 / np.sqrt(2.0)).astype(dt)
    lo, hi = np.array([s, s], dt), np.array([s, -s], dt)
    for mod, (g0, g1) in (("DWT", ("h0", "h1")), ("IDWT", ("g0", "g1"))):
        for name, taps in ((g0, lo), (g1, hi)):
            sd[f"FREQ_INDEX.{mod}.{name}_col"] = taps.reshape(1, 1, 2, 1)
            sd[f"FREQ_INDEX.{mod}.{name}_row"] = taps.reshape(1, 1, 1, 2)

    # np.array(order="C") copies and keeps 0-d arrays 0-d (num_batches_tracked
    # is a scalar buffer in torch; the JAX exporter's ascontiguousarray makes
    # it shape [1], which torch's loader also accepts)
    return {k: torch.from_numpy(np.array(v, order="C")) for k, v in sd.items()}
