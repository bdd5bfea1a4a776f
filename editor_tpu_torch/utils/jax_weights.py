"""Weight bridge: JAX EDITOR params/state (as numpy) -> the port's state_dict.

The same mapping as ``editor_tpu.utils.torch_convert.export_editor_to_torch``
without importing JAX: Linear weights [in, out] become torch's [out, in],
the HWIO patch conv becomes OIHW, the depth-stacked block parameters become
``blocks.{i}.*``, BN running stats and OCFR centers come from the state, and
the constant Haar filter buffers are added. Arrays keep their dtype. A
``(params, state)`` taken after JAX train steps maps the same way, so the
tests compare the two packages' parameters, BN running stats and OCFR
centers after a step through it (``num_batches_tracked``, which JAX does not
keep, comes out 0). ``jax_tree_from_state_dict`` maps back, for the JAX
package's ``.npz`` weight files (``utils/checkpoint.save_params_npz``).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

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


def _t(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _vit_tree(sd: Mapping[str, torch.Tensor], pre: str) -> Dict[str, Any]:
    def lin(name):
        out = {"w": _t(sd[f"{name}.weight"]).T}
        if f"{name}.bias" in sd:
            out["b"] = _t(sd[f"{name}.bias"])
        return out

    def ln(name):
        return {"w": _t(sd[f"{name}.weight"]), "b": _t(sd[f"{name}.bias"])}

    p: Dict[str, Any] = {
        "cls_token": _t(sd[pre + "cls_token"]),
        "pos_embed": _t(sd[pre + "pos_embed"]),
        "patch_embed": {"proj": {"w": _t(sd[pre + "patch_embed.proj.weight"]).transpose(2, 3, 1, 0),
                                 "b": _t(sd[pre + "patch_embed.proj.bias"])}},
        "norm": ln(pre + "norm"),
        "fc": lin(pre + "fc"),
    }
    if pre + "sie_embed" in sd:
        p["sie_embed"] = _t(sd[pre + "sie_embed"])
    depth = 1 + max(int(k[len(pre) + 7:].split(".")[0]) for k in sd if k.startswith(pre + "blocks."))
    blocks = [{"norm1": ln(f"{pre}blocks.{i}.norm1"), "norm2": ln(f"{pre}blocks.{i}.norm2"),
               "attn": {n: lin(f"{pre}blocks.{i}.attn.{n}") for n in ("qkv", "proj")},
               "mlp": {n: lin(f"{pre}blocks.{i}.mlp.{n}") for n in ("fc1", "fc2")}}
              for i in range(depth)]

    def stack(*leaves):
        if isinstance(leaves[0], dict):
            return {k: stack(*(leaf[k] for leaf in leaves)) for k in leaves[0]}
        return np.stack(leaves)

    p["blocks"] = stack(*blocks)
    return p


def jax_tree_from_state_dict(sd: Mapping[str, torch.Tensor], ecfg) -> Tuple[dict, dict]:
    """The inverse of :func:`state_dict_from_jax`: the port's state_dict ->
    JAX ``editor_init``-layout (params, state) as nested dicts of numpy
    arrays (``num_batches_tracked`` and the constant Haar buffers, which JAX
    does not keep, are dropped)."""
    params: Dict[str, Any] = {"BACKBONE": _vit_tree(sd, "BACKBONE.base.")}

    def ln(name):
        return {"w": _t(sd[f"{name}.weight"]), "b": _t(sd[f"{name}.bias"])}

    def nobias(name, subs):
        return {sub: {"w": _t(sd[f"{name}.{sub}.weight"]).T} for sub in subs}

    fb: Dict[str, Any] = {}
    for mod in ("R", "N", "T"):
        fb[f"norm{mod}"] = ln(f"FUSE_block.norm{mod}")
        fb[f"norm{mod}_"] = ln(f"FUSE_block.norm{mod}_")
        fb[f"attn{mod}"] = nobias(f"FUSE_block.attn{mod}", ("qkv", "proj"))
        fb[f"mlp{mod}"] = nobias(f"FUSE_block.mlp{mod}", ("fc1", "fc2"))
    fb["norm1"] = ln("FUSE_block.norm1")
    fb["attn1"] = nobias("FUSE_block.attn1", ("qkv", "proj"))
    fb["norm2"] = ln("FUSE_block.norm2")
    fb["mlp"] = nobias("FUSE_block.mlp", ("fc1", "fc2"))
    fb["out_norm"] = ln("FUSE_block.out_norm")
    params["FUSE_block"] = fb

    for name in ("RGB_REDUCE", "NIR_REDUCE", "TIR_REDUCE"):
        params[name] = {"w": _t(sd[f"{name}.weight"]).T}
        if f"{name}.bias" in sd:
            params[name]["b"] = _t(sd[f"{name}.bias"])
    heads, bns = ["FUSE_HEAD", "BACKBONE_HEAD"], ["FUSE_BN", "BACKBONE_BN"]
    if getattr(ecfg, "al", False) and "AL_HEAD.weight" in sd:
        heads.append("AL_HEAD")
        bns.append("AL_BN")
    for name in heads:
        params[name] = {"w": _t(sd[f"{name}.weight"]).T}
    bn_state = {}
    for name in bns:
        params[name] = ln(name)
        bn_state[name] = {"mean": _t(sd[f"{name}.running_mean"]),
                          "var": _t(sd[f"{name}.running_var"])}
    ocfr = {ours: _t(sd[f"FUSE_block.memory_cls.{theirs}_centers"])
            for ours, theirs in (("rgb", "RGB"), ("nir", "NIR"), ("tir", "TIR"))}
    return params, {"ocfr": ocfr, "bn": bn_state}
