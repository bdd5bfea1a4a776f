"""The port's ``utils/debug.py`` and ``utils/profiling.py`` against the JAX
package's.

* ``nonfinite_leaves``, ``assert_tree_finite`` and ``summarize_tree`` give
  JAX's strings, exactly, for the same nested tree (dicts, an
  ``OrderedDict``, lists, tuples, a namedtuple, None): the port's leaves are
  tensors (fp32, fp64, bf16, int), JAX's the same values as arrays.
* ``checked_update`` sweeps on JAX's cadence (the same call raises);
  ``benchmark`` and ``flops_per_second`` return JAX's keys; ``sync`` and
  ``monitored_barrier`` without a group return at once (0.0).
* ``cost_analysis``: a Linear/conv stack counts exactly 2 M N K per product
  (the convolution's too); each kernel wrapper counts its shape formula once
  on the CPU, where it runs its plain version, and that equals the plain
  version's own count; a tiny EDITOR eval forward counts the same with
  ``use_pallas=True`` (through the wrappers) as with ``use_pallas=False``
  (within 1%; they are equal); per-layer counts feed ``balance_stages`` as
  JAX's ``cost_analysis`` feeds its own.
* ``trace`` writes a Chrome trace naming the annotated range and the ops.
"""

import collections
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from editor_tpu.utils import debug as JDBG
from editor_tpu_torch.utils import debug as DBG
from editor_tpu_torch.utils import profiling as PROF

Pair = collections.namedtuple("Pair", ["first", "second"])


def _trees():
    """(the port's tree, JAX's tree): the same structure and values."""
    rng = np.random.RandomState(0)
    a, b, c = rng.randn(3), rng.randn(2, 2).astype(np.float32), rng.randn(4)
    c[1] = np.nan
    d = np.array([1.0, np.inf], np.float32)
    e = rng.randn(2, 3).astype(np.float32)
    ints = np.arange(4)

    def build(conv, bf16):
        return {"z": {"b": [conv(b), None, (conv(c),)], "a": conv(a)},
                "od": collections.OrderedDict([("y", conv(d)), ("x", conv(ints))]),
                "pair": Pair(conv(e), bf16),
                "m": conv(a[:2])}

    bf = np.asarray(torch.tensor([0.5, 1.5]).bfloat16().float())
    port = build(torch.from_numpy, torch.tensor([0.5, 1.5]).bfloat16())
    ref = build(jnp.asarray, jnp.asarray(bf))
    return port, ref


def test_nonfinite_leaves_and_summary_equal_jax():
    port, ref = _trees()
    assert DBG.nonfinite_leaves(port) == JDBG.nonfinite_leaves(ref)
    assert DBG.nonfinite_leaves(port) == ["['od']['y']", "['z']['b'][2][0]"]
    for n in (3, 20):
        assert DBG.summarize_tree(port, max_leaves=n) == JDBG.summarize_tree(ref, max_leaves=n)
    with pytest.raises(FloatingPointError) as got:
        DBG.assert_tree_finite(port, "state")
    with pytest.raises(FloatingPointError) as want:
        JDBG.assert_tree_finite(ref, "state")
    assert str(got.value) == str(want.value)
    good = {"a": torch.ones(3), "b": {"c": torch.zeros(2)}}
    assert DBG.nonfinite_leaves(good) == []
    DBG.assert_tree_finite(torch.nn.Linear(2, 2))  # a module sweeps its state_dict


def test_checked_update_cadence_equals_jax():
    """A step whose state turns NaN at its third call: with check_every=2
    both packages raise at the fourth call, not before."""
    def run(pkg, zeros, nan):
        calls = {"n": 0}

        def step(state, x):
            calls["n"] += 1
            return (state * nan if calls["n"] >= 3 else state + x), {"loss": x}

        wrapped = pkg.checked_update(step, check_every=2)
        s = zeros
        for i in range(1, 6):
            try:
                s, _ = wrapped(s, 1.0)
            except FloatingPointError:
                return i
        return None

    got = run(DBG, torch.zeros(2), float("nan"))
    assert got == run(JDBG, jnp.zeros(2), float("nan")) == 4


def test_debug_switches_and_barrier_without_a_group():
    DBG.enable_nan_checks(True)
    try:
        assert torch.is_anomaly_enabled()
    finally:
        DBG.enable_nan_checks(False)
    assert not torch.is_anomaly_enabled()
    assert DBG.monitored_barrier(1.0) == 0.0


def test_benchmark_and_flops_per_second_keys():
    a = torch.ones(64, 64)
    t = PROF.benchmark(torch.matmul, a, a, iters=3)
    assert set(t) == {"mean_s", "p50_s", "min_s", "iters"} and t["min_s"] > 0
    f = PROF.flops_per_second(torch.matmul, a, a, iters=2)
    assert set(f) == {"mean_s", "p50_s", "min_s", "iters", "flops", "tflops_per_s"}
    assert f["flops"] == 2 * 64 ** 3 and f["tflops_per_s"] > 0
    PROF.sync({"x": [a, (a, None)]})


def test_cost_analysis_of_a_linear_conv_stack_is_exact():
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Conv2d(3, 8, 3), torch.nn.ReLU(), torch.nn.Flatten(),
                              torch.nn.Linear(8 * 6 * 6, 10), torch.nn.Linear(10, 4, bias=False))
    x = torch.randn(2, 3, 8, 8)
    want = 2 * 2 * 8 * 6 * 6 * 3 * 3 * 3 + 2 * 2 * 288 * 10 + 2 * 2 * 10 * 4
    assert PROF.cost_analysis(net, x) == {"flops": float(want)}


def test_each_kernel_wrapper_counts_its_shape_formula_once():
    """On the CPU a wrapper runs its plain version: counted once, from its
    shapes, which is what the plain version's own products count."""
    from editor_tpu_torch import ops

    B, N, H, D = 2, 17, 2, 16
    C = H * D
    gen = torch.Generator().manual_seed(1)
    qkv = torch.randn(B, N, 3 * C, generator=gen)
    g = torch.randn(B, N, C, generator=gen)
    mask = torch.ones(B, N)
    cost = lambda f, *a: PROF.cost_analysis(f, *a)["flops"]  # noqa: E731
    fwd, bwd = 4.0 * B * N * N * C, 10.0 * B * N * N * C
    assert cost(ops.attention_qkv, qkv, H, 0.25) == fwd
    assert cost(ops.attention_qkv_plain, qkv, H, 0.25, False) == fwd
    assert cost(ops.masked_attention_qkv, qkv, mask, H, 0.25) == fwd
    assert cost(ops.masked_attention_qkv_plain, qkv, mask, H, 0.25) == fwd
    assert cost(ops.masked_attention_tiled, qkv, mask, H, 0.25, -65504.0, 17) == fwd
    assert cost(ops.attention_qkv_bwd, qkv, g, H, 0.25) == bwd
    assert cost(ops.masked_attention_qkv_bwd, qkv, mask, g, H, 0.25) == bwd
    probs = torch.rand(3, B, H, N, N, generator=gen)
    assert cost(ops.rollout_chain, probs) == cost(ops.rollout_from_probs_plain, probs) \
        == 2.0 * 2 * B * H * N * N
    x, w = torch.randn(5, 4, C, generator=gen), torch.randn(24, C, generator=gen)
    ln = (torch.ones(C), torch.zeros(C))
    assert cost(ops.ln_matmul, x, w, None, *ln) == cost(ops.ln_matmul_plain, x, w, None, *ln) \
        == 2.0 * 20 * C * 24
    # outside a count nothing changes: the wrappers still run and count no launch
    assert all(fn.launches == 0 for fn in ops.KERNEL_WRAPPERS)


def test_eval_forward_costs_the_same_through_the_kernels_and_the_plain_ops():
    from editor_tpu_torch.engine.evaluate import build_eval_step
    from editor_tpu_torch.models.editor import Editor, EditorConfig, vit_tiny_test_config
    from editor_tpu_torch.models.init import editor_init

    vit = vit_tiny_test_config(img_size=(64, 32), patch_size=16, stride_size=(16, 16), camera=4)
    cfg = EditorConfig(num_classes=10, vit=vit, head_keep=2, frequency_keep=3)
    model = editor_init(cfg, seed=0, device="cpu")
    plain = Editor(dataclasses.replace(cfg, use_pallas=False), device="cpu")
    plain.load_state_dict(model.state_dict(), strict=True)
    gen = torch.Generator().manual_seed(2)
    batch = {m: torch.randn(2, 64, 32, 3, generator=gen) for m in ("RGB", "NI", "TI")}
    batch["camid"] = torch.tensor([0, 3])
    kern = PROF.cost_analysis(build_eval_step(model, torch.float32), batch)["flops"]
    ref = PROF.cost_analysis(build_eval_step(plain, torch.float32), batch)["flops"]
    assert ref > 0 and abs(kern - ref) <= 0.01 * ref
    assert kern == ref


def test_layer_costs_feed_balance_stages_as_in_jax():
    from editor_tpu.parallel.pipeline import balance_stages as jax_balance

    from editor_tpu_torch.parallel.pipeline import balance_stages

    widths = [8, 64, 16, 16, 96, 8, 32, 8]
    x = torch.randn(4, 32)
    costs = [PROF.cost_analysis(torch.nn.Linear(32, w * 4), x)["flops"] for w in widths]
    assert costs == [2.0 * 4 * 32 * w * 4 for w in widths]
    for stages in (2, 3, 4):
        assert balance_stages(costs, stages) == list(jax_balance(costs, stages))


def test_trace_writes_a_chrome_trace_with_the_annotation(tmp_path):
    a = torch.randn(32, 32)
    with PROF.trace(str(tmp_path / "tr")):
        with PROF.annotate("editor-span"):
            (a @ a).sum()
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "editor-span" in names and any(str(n).startswith("aten::mm") for n in names)
