"""T1-T6, the design-variant kernels of ``editor_tpu_torch/tools/``: the
port's plain versions against the JAX tools' TPU kernel bodies and XLA
oracles, and the wrappers' CPU path.

* bf16 against the TPU bodies themselves, loaded from ``tools/bench_*.py``
  by file path and run through ``pl.pallas_call(..., interpret=True)`` with
  the scripts' BlockSpecs, on the same bf16 inputs. Both sides round at the
  same points and sum in fp32 in different orders, so an element may land one
  bf16 step away: the limit is one bf16 ulp of the output's largest
  magnitude (as in ``tests/test_torch_tiled_ops.py``). The scripts' own
  probs variants cannot run (``_headgrid_kernel`` and ``_attn_layer_kernel``
  take their probs refs as keyword-only arguments, which ``pallas_call``
  passes positionally); the tests pass them by keyword.
* f64 against the XLA oracles where one exists (T1, T2 against
  ``_xla_attention_qkv``; T3 against an LN -> matmul -> ``_xla_attention_qkv``
  -> matmul composition; T4 ``f32`` and ``rows`` against
  ``rollout_from_probs``): rtol 1e-9, the two differ only in summation order.
* T6 is K3/K5 walking g sequences a block: on a CPU tensor every group runs
  the same plain version, held against ``_qkv_masked_full_kernel`` and
  ``_qkv_masked_full_bwd_kernel`` in interpret mode at the script's groups
  (and by ``tests/test_torch_t6.py`` with its wrong forms).
"""

import functools
import importlib
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from editor_tpu.ops.rollout import rollout_from_probs
from editor_tpu_torch import ops
from editor_tpu_torch.tools import (_bench, bench_attn, bench_attn2, bench_attn_layer,
                                    bench_full_kernel, bench_rollout, bench_rollout2)
from tests.torch_parity import assert_close, bf16_pair, ulp_of_max, x64  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
jax_fa = importlib.import_module("editor_tpu.ops.fused_attention")
jax_ma = importlib.import_module("editor_tpu.ops.masked_attention")

H, D = 2, 16
C = H * D
SCALE = D ** -0.5
FILL = -65504.0


@functools.cache
def tool(name: str):
    """A JAX script of ``tools/``, loaded by file path (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}",
                                                  REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _assert_within_ulp(got: torch.Tensor, ref: np.ndarray) -> None:
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=ulp_of_max(ref))


def _randn(seed, *shape):
    return np.random.RandomState(seed).randn(*shape)


# ---------------------------------------------------------------------------
# T1: headgrid_attn
# ---------------------------------------------------------------------------

def _interpret_headgrid(q, k, v, g, hps, with_probs):
    """``_headgrid_kernel`` with the BlockSpecs of ``headgrid_attn``."""
    import jax.experimental.pallas as pl

    B, N, Cq = q.shape
    Dh = D * hps
    spec = pl.BlockSpec((g, N, Dh), lambda i, h: (i, 0, h))
    body = functools.partial(tool("bench_attn")._headgrid_kernel, scale=SCALE,
                             with_probs=with_probs, heads_per_step=hps)
    if not with_probs:
        return pl.pallas_call(body, out_shape=jax.ShapeDtypeStruct((B, N, Cq), q.dtype),
                              grid=(B // g, H // hps), in_specs=[spec] * 3, out_specs=spec,
                              interpret=True)(q, k, v), None

    def kernel(q_ref, k_ref, v_ref, o_ref, pp_ref, pc_ref):
        body(q_ref, k_ref, v_ref, o_ref, pp_ref=pp_ref, pc_ref=pc_ref)

    out, pp, pc = pl.pallas_call(
        kernel,
        out_shape=(jax.ShapeDtypeStruct((B, N, Cq), q.dtype),
                   jax.ShapeDtypeStruct((B, H, N, N - 1), q.dtype),
                   jax.ShapeDtypeStruct((B, H, N), q.dtype)),
        grid=(B // g, H // hps), in_specs=[spec] * 3,
        out_specs=(spec, pl.BlockSpec((g, hps, N, N - 1), lambda i, h: (i, h, 0, 0)),
                   pl.BlockSpec((g, hps, N), lambda i, h: (i, h, 0))),
        interpret=True)(q, k, v)
    return out, jnp.concatenate([pc[..., None], pp], axis=-1)


@pytest.mark.parametrize("N", [9, 17, 33])
def test_headgrid_plain_matches_xla_f64(x64, N):
    qkv = _randn(N, 3, N, 3 * C)
    ref_out, (pp, pc) = jax_fa._xla_attention_qkv(jnp.asarray(qkv), H, SCALE, True)
    q, k, v = torch.from_numpy(qkv).split(C, -1)
    out, probs = bench_attn.headgrid_attn_plain(q, k, v, H, SCALE, True)
    assert_close(out, ref_out)
    assert_close(probs, np.concatenate([np.asarray(pc)[..., None], np.asarray(pp)], -1))


@pytest.mark.parametrize("hps, with_probs", [(1, False), (1, True), (2, False), (2, True)])
def test_headgrid_plain_matches_tpu_kernel_bf16(hps, with_probs):
    B, N, g = 4, 17, 2
    (jq, tq), (jk, tk), (jv, tv) = (bf16_pair(_randn(s, B, N, C)) for s in (1, 2, 3))
    ref_out, ref_probs = _interpret_headgrid(jq, jk, jv, g, hps, with_probs)
    got = bench_attn.headgrid_attn_plain(tq, tk, tv, H, SCALE, with_probs)
    out, probs = got if with_probs else (got, None)
    assert out.dtype == torch.bfloat16
    _assert_within_ulp(out, _np(ref_out))
    if with_probs:
        _assert_within_ulp(probs, _np(ref_probs))


def test_headgrid_wrapper_on_cpu_is_plain():
    B, N = 3, 9
    qkv = torch.from_numpy(_randn(4, B, N, 3 * C)).bfloat16()
    q, k, v = qkv.split(C, -1)  # column views, as the kernel takes them
    before = bench_attn.headgrid_attn.launches
    probs = torch.empty(B, H, N, N, dtype=qkv.dtype)
    out, got_probs = bench_attn.headgrid_attn(q, k, v, H, SCALE, 2, 2, probs)
    ref_out, ref_probs = bench_attn.headgrid_attn_plain(q, k, v, H, SCALE, True)
    assert got_probs is probs
    assert torch.equal(out, ref_out) and torch.equal(probs, ref_probs)
    out2, none = bench_attn.headgrid_attn(q.contiguous(), k.contiguous(), v.contiguous(), H,
                                          SCALE)
    assert none is None and torch.equal(out2, ref_out)
    assert bench_attn.headgrid_attn.launches == before  # no kernel on the CPU
    with pytest.raises(ValueError):
        bench_attn.headgrid_attn(q, k, v, H, SCALE, hps=3)
    with pytest.raises(ValueError):
        bench_attn.headgrid_attn(q, k[:, 1:], v, H, SCALE)
    with pytest.raises(ValueError):
        bench_attn.headgrid_attn(q, k, v, H, SCALE, probs_out=torch.empty(B, H, N, N - 1))


# ---------------------------------------------------------------------------
# T2: nomax_attn
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N", [9, 33])
def test_nomax_plain_matches_xla_f64(x64, N):
    qkv = _randn(10 + N, 3, N, 3 * C)
    ref = jax_fa._xla_attention_qkv(jnp.asarray(qkv), H, SCALE, False)
    assert_close(bench_attn2.nomax_attn_plain(torch.from_numpy(qkv), H, SCALE), ref)


@pytest.mark.parametrize("g", [1, 2])
def test_nomax_plain_matches_tpu_kernel_bf16(g):
    import jax.experimental.pallas as pl

    B, N = 4, 17
    jq, tq = bf16_pair(_randn(11, B, N, 3 * C))
    ref = pl.pallas_call(
        functools.partial(tool("bench_attn2")._kernel_nomax, scale=SCALE, H=H, D=D),
        out_shape=jax.ShapeDtypeStruct((B, N, C), jq.dtype), grid=(B // g,),
        in_specs=[pl.BlockSpec((g, N, 3 * C), lambda i: (i, 0, 0))],
        out_specs=pl.BlockSpec((g, N, C), lambda i: (i, 0, 0)), interpret=True)(jq)
    got = bench_attn2.nomax_attn_plain(tq, H, SCALE)
    assert got.dtype == torch.bfloat16
    _assert_within_ulp(got, _np(ref))


def test_nomax_wrapper_on_cpu_is_plain():
    qkv = torch.from_numpy(_randn(12, 2, 9, 3 * C)).bfloat16()
    before = bench_attn2.nomax_attn.launches
    assert torch.equal(bench_attn2.nomax_attn(qkv, H, SCALE, 2),
                       bench_attn2.nomax_attn_plain(qkv, H, SCALE))
    assert bench_attn2.nomax_attn.launches == before
    with pytest.raises(ValueError):
        bench_attn2.nomax_attn(qkv[..., 1:], H, SCALE)


# ---------------------------------------------------------------------------
# T3: attn_layer
# ---------------------------------------------------------------------------

def _layer_inputs(B, N, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, N, C) * 0.5, rng.rand(C) + 0.5, rng.randn(C) * 0.1,
            rng.randn(C, 3 * C) * 0.2, rng.randn(3 * C) * 0.02, rng.randn(C, C) * 0.2,
            rng.randn(C) * 0.02)


def _composed_f64(x, lnw, lnb, wqkv, bqkv, wp, bp, with_probs):
    """The math of ``composed`` (tools/bench_attn_layer.py:132-141), a closure
    of its ``main``, at f64 with the XLA attention."""
    x = jnp.asarray(x)
    mu = jnp.mean(x, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(x - mu), axis=-1, keepdims=True)
    y = (x - mu) * jax.lax.rsqrt(var + 1e-6) * lnw + lnb
    qkv = y @ wqkv + bqkv
    out, (pp, pc) = jax_fa._xla_attention_qkv(qkv, H, SCALE, True)
    out = out @ wp + bp
    return (out, jnp.concatenate([pc[..., None], pp], -1)) if with_probs else out


@pytest.mark.parametrize("N", [9, 17])
def test_attn_layer_plain_matches_composed_f64(x64, N):
    ins = _layer_inputs(3, N, N)
    ref_out, ref_probs = _composed_f64(*ins, True)
    out, probs = bench_attn_layer.attn_layer_plain(*(torch.from_numpy(a) for a in ins), H,
                                                   SCALE, 1e-6, True)
    assert_close(out, ref_out)
    assert_close(probs, ref_probs)


@pytest.mark.parametrize("with_probs", [False, True])
def test_attn_layer_plain_matches_tpu_kernel_bf16(with_probs):
    import jax.experimental.pallas as pl

    B, N, g = 4, 17, 2
    pairs = [bf16_pair(a) for a in _layer_inputs(B, N, 20)]
    jin, tin = [p[0] for p in pairs], [p[1] for p in pairs]
    body = functools.partial(tool("bench_attn_layer")._attn_layer_kernel, scale=SCALE, H=H,
                             D=D, eps=1e-6, with_probs=with_probs)
    in_specs = [pl.BlockSpec((g, N, C), lambda i: (i, 0, 0)),
                pl.BlockSpec((C,), lambda i: (0,)), pl.BlockSpec((C,), lambda i: (0,)),
                pl.BlockSpec((C, 3 * C), lambda i: (0, 0)),
                pl.BlockSpec((3 * C,), lambda i: (0,)),
                pl.BlockSpec((C, C), lambda i: (0, 0)), pl.BlockSpec((C,), lambda i: (0,))]
    out_spec = pl.BlockSpec((g, N, C), lambda i: (i, 0, 0))
    if with_probs:
        def kernel(*refs):
            body(*refs[:8], pp_ref=refs[8], pc_ref=refs[9])

        out, pp, pc = pl.pallas_call(
            kernel,
            out_shape=(jax.ShapeDtypeStruct((B, N, C), jnp.bfloat16),
                       jax.ShapeDtypeStruct((B, H, N, N - 1), jnp.bfloat16),
                       jax.ShapeDtypeStruct((B, H, N), jnp.bfloat16)),
            grid=(B // g,), in_specs=in_specs,
            out_specs=(out_spec, pl.BlockSpec((g, H, N, N - 1), lambda i: (i, 0, 0, 0)),
                       pl.BlockSpec((g, H, N), lambda i: (i, 0, 0))),
            interpret=True)(*jin)
        ref_probs = jnp.concatenate([pc[..., None], pp], axis=-1)
    else:
        out = pl.pallas_call(body, out_shape=jax.ShapeDtypeStruct((B, N, C), jnp.bfloat16),
                             grid=(B // g,), in_specs=in_specs, out_specs=out_spec,
                             interpret=True)(*jin)
    got = bench_attn_layer.attn_layer_plain(*tin, H, SCALE, 1e-6, with_probs)
    if with_probs:
        got, probs = got
        _assert_within_ulp(probs, _np(ref_probs))
    assert got.dtype == torch.bfloat16
    _assert_within_ulp(got, _np(out))


def test_attn_layer_wrapper_on_cpu_is_plain():
    ins = [torch.from_numpy(a).bfloat16() for a in _layer_inputs(2, 9, 21)]
    before = bench_attn_layer.attn_layer.launches
    probs = torch.empty(2, H, 9, 9, dtype=torch.bfloat16)
    out, got_probs = bench_attn_layer.attn_layer(*ins, H, SCALE, 1e-6, 2, probs)
    ref_out, ref_probs = bench_attn_layer.attn_layer_plain(*ins, H, SCALE, 1e-6, True)
    assert got_probs is probs and torch.equal(out, ref_out) and torch.equal(probs, ref_probs)
    assert bench_attn_layer.attn_layer.launches == before
    with pytest.raises(ValueError, match="wqkv"):
        bench_attn_layer.attn_layer(ins[0], ins[1], ins[2], ins[3].t(), *ins[4:], H, SCALE)


# ---------------------------------------------------------------------------
# T4 and T5: chain, chain_multi
# ---------------------------------------------------------------------------

def _split_maps(L, B, N, seed):
    """Uniform random pp [L, B, H, N, N-1] and pc [L, B, H, N] in bf16 (as the
    JAX scripts make them) and the full maps cat(pc, pp) for the port."""
    rng = np.random.RandomState(seed)
    (jpp, _), (jpc, _) = bf16_pair(rng.rand(L, B, H, N, N - 1)), bf16_pair(rng.rand(L, B, H, N))
    full = jnp.concatenate([jpc[..., None], jpp], axis=-1)
    return jpp, jpc, torch.from_numpy(np.array(full.astype(jnp.float32))).bfloat16()


def _interpret_chain(kernel, pp, pc, g, layers, **kw):
    """A chain body of tools/bench_rollout{,2}.py with the BlockSpecs of its
    caller: ``layers`` layers (1 for ``variant_kernel``) of g pairs per grid
    step."""
    import jax.experimental.pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    L, B, Hh, N, P = pp.shape
    Z, S = B * Hh, L // layers
    out = pl.pallas_call(
        functools.partial(kernel, **kw),
        out_shape=jax.ShapeDtypeStruct((Z, 1, P), jnp.float32), grid=(Z // g, S),
        in_specs=[pl.BlockSpec((layers, g, N, P), lambda i, s: (S - 1 - s, i, 0, 0)),
                  pl.BlockSpec((layers, g, N), lambda i, s: (S - 1 - s, i, 0))],
        out_specs=pl.BlockSpec((g, 1, P), lambda i, s: (i, 0, 0)),
        scratch_shapes=[pltpu.VMEM((g, 1), jnp.float32)], interpret=True,
    )(pp.reshape(L, Z, N, P), pc.reshape(L, Z, N))
    return np.asarray(out).reshape(B, Hh, P)


@pytest.mark.parametrize("how", ["f32", "rows"])
def test_chain_plain_matches_rollout_f64(x64, how):
    maps = np.random.RandomState(30).rand(4, 2, H, 9, 9)
    maps /= maps.sum(-1, keepdims=True)
    ref = rollout_from_probs(jnp.asarray(maps))
    assert_close(bench_rollout.chain_plain(torch.from_numpy(maps), how), ref)


def _assert_same_rounding(got: torch.Tensor, other: torch.Tensor, ref: np.ndarray) -> None:
    """``got`` rounds where the TPU body ``ref`` rounds and ``other`` (the
    chain with the other operand rounding) does not: the one-ulp limit is
    wider than the gap between the two chains, so also ``got`` is at least
    ten times nearer ``ref`` and off it by more than 8 fp32 ulps on at most
    5% of the outputs, ``other`` on at least half."""
    ref_t = torch.from_numpy(np.array(ref, np.float32))
    e_got, e_other = _bench.rel_err(got, ref_t), _bench.rel_err(other, ref_t)
    assert e_got * 10 <= e_other, (e_got, e_other)
    assert _bench.mismatch_share(got, ref_t) <= 0.05
    assert _bench.mismatch_share(other, ref_t) >= 0.5


@pytest.mark.parametrize("how, tpu_how", [("f32", "f32dot"), ("bf16", "bf16dot"),
                                          ("rows", "vpu")])
def test_chain_plain_matches_tpu_kernel(how, tpu_how):
    pp, pc, full = _split_maps(3, 2, 17, 31)
    ref = _interpret_chain(tool("bench_rollout").variant_kernel, pp, pc, 2, 1, how=tpu_how)
    got = bench_rollout.chain_plain(full, how)
    assert got.dtype == torch.float32
    _assert_within_ulp(got, ref)
    _assert_same_rounding(got, bench_rollout.chain_plain(full, "f32" if how == "bf16" else "bf16"),
                          ref)


def test_chain_bf16_rounds_the_patch_operand():
    """``bf16`` differs from ``f32`` by the rounding of v[n >= 1] alone: at
    f64 maps with bf16-exact values the two chains differ, and the cls
    column of every step keeps the unrounded v."""
    _, _, full = _split_maps(3, 2, 9, 32)
    f32 = bench_rollout.chain_plain(full.double(), "f32")
    b16 = bench_rollout.chain_plain(full.double(), "bf16")
    assert not torch.equal(f32, b16)
    assert float(((b16 - f32).abs() / f32.abs().max()).max()) < 2 ** -6


@pytest.mark.parametrize("T", [2, 3])
def test_chain_multi_plain_matches_tpu_kernel(T):
    pp, pc, full = _split_maps(6, 2, 17, 33 + T)
    ref = _interpret_chain(tool("bench_rollout2").multi_kernel, pp, pc, 2, T, T=T)
    got = bench_rollout2.chain_multi_plain(full)
    _assert_within_ulp(got, ref)
    _assert_same_rounding(got, bench_rollout.chain_plain(full, "f32"), ref)


def test_chain_wrappers_on_cpu_are_plain():
    _, _, full = _split_maps(3, 2, 9, 34)
    before = (bench_rollout.chain.launches, bench_rollout2.chain_multi.launches)
    for how in bench_rollout.HOWS:
        for g in bench_rollout.PAIRS:
            assert torch.equal(bench_rollout.chain(full, how, g),
                               bench_rollout.chain_plain(full, how))
    for T in bench_rollout2.MAPS_IN_FLIGHT:
        assert torch.equal(bench_rollout2.chain_multi(full, T, 2),
                           bench_rollout2.chain_multi_plain(full))
    assert (bench_rollout.chain.launches, bench_rollout2.chain_multi.launches) == before
    with pytest.raises(ValueError, match="how"):
        bench_rollout.chain(full, "f16")
    with pytest.raises(ValueError, match="pairs"):
        bench_rollout.chain(full, "f32", 8)
    with pytest.raises(ValueError, match="flight"):
        bench_rollout2.chain_multi(full, 5)
    with pytest.raises(ValueError):
        bench_rollout.chain(full[0])


# ---------------------------------------------------------------------------
# T6: masked_full, masked_full_bwd (K3/K5 walking g sequences a block)
# ---------------------------------------------------------------------------

def _interpret_full(kernel, g, qkv, mask, gout=None):
    """``_qkv_masked_full_kernel`` / ``_qkv_masked_full_bwd_kernel`` with the
    BlockSpecs of tools/bench_full_kernel.py (g sequences per grid step)."""
    import jax.experimental.pallas as pl

    B, N, C3 = qkv.shape
    specs = [pl.BlockSpec((g, N, C3), lambda i: (i, 0, 0)),
             pl.BlockSpec((g, 1, N), lambda i: (i, 0, 0))]
    args = [qkv, mask.astype(qkv.dtype)[:, None, :]]
    width = C3 // 3
    if gout is not None:
        specs.append(pl.BlockSpec((g, N, C3 // 3), lambda i: (i, 0, 0)))
        args.append(gout)
        width = C3
    out = pl.pallas_call(
        functools.partial(kernel, scale=SCALE, H=H, D=D, fill=FILL),
        out_shape=jax.ShapeDtypeStruct((B, N, width), qkv.dtype), grid=(B // g,),
        in_specs=specs, out_specs=pl.BlockSpec((g, N, width), lambda i: (i, 0, 0)),
        interpret=True)(*args)
    return _np(out)


def _full_inputs(B, N, seed):
    rng = np.random.RandomState(seed)
    mask = (rng.rand(B, N) < 0.8).astype(np.float64)
    mask[0, 1:] = 0.0  # a sequence with only its cls token
    mask[:, 0] = 1.0
    return bf16_pair(rng.randn(B, N, 3 * C)), mask, bf16_pair(rng.randn(B, N, C))


@pytest.mark.parametrize("g", [1, 2])
def test_masked_full_plain_matches_tpu_kernel_bf16(g):
    (jq, tq), mask, (jg, tg) = _full_inputs(4, 22, 40 + g)
    tm = torch.from_numpy(mask)
    ref = _interpret_full(jax_ma._qkv_masked_full_kernel, g, jq, jnp.asarray(mask))
    _assert_within_ulp(bench_full_kernel.masked_full_plain(tq, tm, H, SCALE, FILL), ref)
    ref = _interpret_full(jax_ma._qkv_masked_full_bwd_kernel, g, jq, jnp.asarray(mask), jg)
    _assert_within_ulp(bench_full_kernel.masked_full_bwd_plain(tq, tm, tg, H, SCALE, FILL), ref)


GROUPS = (1, 2, 4, 8, 16, 32)  # the JAX tool's groups at its two shapes


def _warp_counts():
    return [(fn.launches, fn.variant_launches) for fn in ops.GROUP_WRAPPERS]


def test_masked_full_every_warp_count_runs_the_plain_version_on_cpu():
    """T6 at every group of the JAX tool (and K6 at every group of its
    sweep) runs the plain version on CPU tensors and counts nothing; T6
    refuses g = 0, K3's and K5's own launch."""
    (_, tq), mask, (_, tg) = _full_inputs(3, 22, 50)
    tm = torch.from_numpy(mask)
    before = _warp_counts()
    ref = bench_full_kernel.masked_full_plain(tq, tm, H, SCALE, FILL)
    ref_bwd = bench_full_kernel.masked_full_bwd_plain(tq, tm, tg, H, SCALE, FILL)
    for g in GROUPS:
        assert torch.equal(bench_full_kernel.masked_full(tq, tm, H, SCALE, g, FILL), ref)
        assert torch.equal(ops.masked_attention_tiled(tq[:, :11], tm[:, :11], H, SCALE, FILL,
                                                      11, group=g),
                           ops.masked_attention_tiled_plain(tq[:, :11], tm[:, :11], H, SCALE,
                                                            FILL, 11))
        assert torch.equal(bench_full_kernel.masked_full_bwd(tq, tm, tg, H, SCALE, g, FILL),
                           ref_bwd)
    assert _warp_counts() == before  # no kernel on the CPU
    with pytest.raises(ValueError, match="g = 0"):
        bench_full_kernel.masked_full(tq, tm, H, SCALE, 0)
    with pytest.raises(ValueError, match="g = -1"):
        bench_full_kernel.masked_full_bwd(tq, tm, tg, H, SCALE, -1)


@pytest.mark.parametrize("group", [0, 1, 2, 4, 8, 16])
def test_warp_count_decides_which_count_a_launch_joins(group):
    """A K3/K5/K6 launch at the model paths' group 0 counts in ``launches``
    (K3, K5, K6), at any group g >= 1 in ``variant_launches`` (T6 and K6's
    sweep), so a model path that launched a walking block would show."""
    from editor_tpu_torch.ops.masked_attention import count_launch

    saved = _warp_counts()
    try:
        ops.reset_launch_counts()
        for fn in ops.GROUP_WRAPPERS:
            count_launch(fn, group)
        want = (1, 0) if group == 0 else (0, 1)
        assert _warp_counts() == [want] * len(ops.GROUP_WRAPPERS)
        ops.reset_launch_counts()
        assert _warp_counts() == [(0, 0)] * len(ops.GROUP_WRAPPERS)
    finally:
        for fn, (n, v) in zip(ops.GROUP_WRAPPERS, saved):
            fn.launches, fn.variant_launches = n, v
