"""K6 (tiled masked attention), K7 (its VJP), the fusion block's dispatch
between K6/K7 and K3/K5, and K8 (LayerNorm -> matmul -> GELU): the port's
plain versions against the JAX package.

* f64 against the XLA oracles (``_xla_masked_from_qkv`` and ``jax.vjp`` of
  it; ``_xla_ln_matmul`` and ``jax.vjp`` of ``ln_matmul``): rtol 1e-9, the
  two differ only in summation order.
* bf16 against the TPU kernel bodies themselves (``_qkv_masked_kernel``,
  ``_qkv_masked_bwd_kernel``, ``fused_linear._kernel``) run through
  ``pl.pallas_call(..., interpret=True)`` with the BlockSpecs of their
  ``_pallas_*`` callers, on the same bf16 inputs. Both sides round at the
  same points and sum in fp32 in different orders, so an element may land
  one bf16 step away: the limit is one bf16 ulp of the output's largest
  magnitude (2^(floor(log2 max) - 7)).
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from editor_tpu_torch import ops
from editor_tpu_torch.ops import masked_attention as port_ma
from tests.torch_parity import assert_close, x64  # noqa: F401
from tests.torch_parity import bf16_pair as _bf16, ulp_of_max as _ulp_of_max

# ``editor_tpu.ops.masked_attention`` is the function the package re-exports;
# the modules are taken by name
jax_ma = importlib.import_module("editor_tpu.ops.masked_attention")
jax_fl = importlib.import_module("editor_tpu.ops.fused_linear")

H, D = 2, 16
C = H * D
SCALE = D ** -0.5
FILL = -65504.0
TILE = 129
NS = [129, 258, 387]  # 1, 2 and 3 modality tiles


def _qkv(B, N, seed, width=3 * C):
    return np.random.RandomState(seed).randn(B, N, width)


def _mask(B, N, seed, tile=TILE):
    """Each tile's cls token kept, patches kept with probability 0.6, and one
    sequence whose second tile is masked whole but for its cls token."""
    m = np.random.RandomState(seed).rand(B, N) < 0.6
    m[:, ::tile] = True
    if N > tile:
        m[0, tile + 1:2 * tile] = False
    return m.astype(np.float64)


def _interpret_masked(kernel, B, N, tile, *arrays):
    """A TPU kernel body of editor_tpu/ops/masked_attention.py in Pallas
    interpret mode, with the BlockSpecs of ``_pallas_masked_from_qkv`` /
    ``_pallas_masked_qkv_bwd`` (one sequence per grid step)."""
    import jax.experimental.pallas as pl

    qkv, mask = arrays[:2]
    fn = functools.partial(kernel, scale=SCALE, H=H, D=D, fill=FILL, tile=tile,
                           n_tiles=N // tile)
    specs = [pl.BlockSpec((1, N, 3 * C), lambda i: (i, 0, 0)),
             pl.BlockSpec((1, 1, N), lambda i: (i, 0, 0))]
    width = C
    if len(arrays) == 3:  # the backward: g in, dqkv out
        specs.append(pl.BlockSpec((1, N, C), lambda i: (i, 0, 0)))
        width = 3 * C
    out = pl.pallas_call(fn, out_shape=jax.ShapeDtypeStruct((B, N, width), qkv.dtype),
                         grid=(B,), in_specs=specs,
                         out_specs=pl.BlockSpec((1, N, width), lambda i: (i, 0, 0)),
                         interpret=True)(qkv, mask.astype(qkv.dtype)[:, None, :],
                                         *arrays[2:])
    return np.asarray(out.astype(jnp.float32))


# ---------------------------------------------------------------------------
# K6 / K7 at f64 against the XLA oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N", NS)
def test_tiled_plain_matches_xla_f64(x64, N):
    qkv, mask = _qkv(3, N, N), _mask(3, N, N + 1)
    ref = np.asarray(jax_ma._xla_masked_from_qkv(jnp.asarray(qkv), jnp.asarray(mask), H,
                                                 SCALE, FILL))
    got = ops.masked_attention_tiled_plain(torch.from_numpy(qkv), torch.from_numpy(mask),
                                           H, SCALE, FILL, TILE)
    assert_close(got, ref)
    dead = torch.from_numpy(mask) == 0
    assert dead.any() and torch.count_nonzero(got[dead]) == 0


@pytest.mark.parametrize("N", NS)
def test_tiled_bwd_plain_matches_jax_vjp_f64(x64, N):
    qkv, mask = _qkv(3, N, N + 2), _mask(3, N, N + 3)
    g = np.random.RandomState(N + 4).randn(3, N, C)
    _, vjp = jax.vjp(lambda t: jax_ma._xla_masked_from_qkv(t, jnp.asarray(mask), H, SCALE,
                                                           FILL), jnp.asarray(qkv))
    (ref,) = vjp(jnp.asarray(g))
    got = ops.masked_attention_tiled_bwd_plain(torch.from_numpy(qkv), torch.from_numpy(mask),
                                               torch.from_numpy(g), H, SCALE, FILL, TILE)
    assert_close(got, ref)
    # masked query rows get no dq, masked keys of every row no dk and dv
    dead = torch.from_numpy(mask) == 0
    assert torch.count_nonzero(got[..., :C][dead]) == 0
    assert torch.count_nonzero(got[..., C:][dead]) == 0
    # every cls key of every tile gets a gradient
    assert (got[:, ::TILE, C:] != 0).all()


# ---------------------------------------------------------------------------
# K6 / K7 at bf16 against the TPU kernel bodies (Pallas interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N", NS)
def test_tiled_plain_matches_tpu_kernel_bf16(N):
    B = 2
    (jq, tq), mask = _bf16(_qkv(B, N, 10 + N)), _mask(B, N, 11 + N)
    ref = _interpret_masked(jax_ma._qkv_masked_kernel, B, N, TILE, jq, jnp.asarray(mask))
    got = ops.masked_attention_tiled_plain(tq, torch.from_numpy(mask), H, SCALE, FILL, TILE)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=_ulp_of_max(ref))


@pytest.mark.parametrize("N", NS)
def test_tiled_bwd_plain_matches_tpu_kernel_bf16(N):
    B = 2
    (jq, tq), mask = _bf16(_qkv(B, N, 20 + N)), _mask(B, N, 21 + N)
    jg, tg = _bf16(np.random.RandomState(22 + N).randn(B, N, C))
    ref = _interpret_masked(jax_ma._qkv_masked_bwd_kernel, B, N, TILE, jq, jnp.asarray(mask),
                            jg)
    got = ops.masked_attention_tiled_bwd_plain(tq, torch.from_numpy(mask), tg, H, SCALE,
                                               FILL, TILE)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=_ulp_of_max(ref))


def test_tiled_and_full_plain_differ_in_bf16_rounding():
    """K6 keeps the cls exps in fp32 and K3 rounds every weight: at bf16 the
    two plain versions (hence the two kernels) give different results on the
    same input, which is why the uncompacted tail must take K6."""
    (_, tq), mask = _bf16(_qkv(2, 258, 30)), torch.from_numpy(_mask(2, 258, 31))
    tiled = ops.masked_attention_tiled_plain(tq, mask, H, SCALE, FILL, TILE)
    full = ops.masked_attention_qkv_plain(tq, mask, H, SCALE, FILL)
    assert not torch.equal(tiled, full)
    assert float((tiled.float() - full.float()).abs().max()) < 0.05


# ---------------------------------------------------------------------------
# the autograd Function and the dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N", [129, 387])
def test_tiled_fn_matches_autograd_of_plain(x64, N):
    qkv, mask = torch.from_numpy(_qkv(2, N, 40 + N)), torch.from_numpy(_mask(2, N, 41 + N))
    g = torch.from_numpy(np.random.RandomState(42 + N).randn(2, N, C))
    t1, t2 = qkv.clone().requires_grad_(), qkv.clone().requires_grad_()
    mt = mask.clone().requires_grad_()
    out = ops.masked_attention_tiled_fn(t1, mt, H, SCALE, FILL, TILE)
    ref = ops.masked_attention_tiled_plain(t2, mask, H, SCALE, FILL, TILE)
    assert_close(out, ref.detach().numpy())
    (d1,) = torch.autograd.grad(out, t1, g)
    (d2,) = torch.autograd.grad(ref, t2, g)
    assert_close(d1, d2.numpy())
    assert mt.grad is None
    assert [fn.launches for fn in ops.KERNEL_WRAPPERS] == [0] * len(ops.KERNEL_WRAPPERS)


@pytest.mark.parametrize("N, tile, route", [
    (129, 129, "tiled"), (258, 129, "tiled"), (387, 129, "tiled"),  # uncompacted tail
    (88, 88, "full"), (264, 88, "full"),                             # compact tail
    (9, 9, "full"), (27, 9, "full"),                                 # tiny test grids
    (129, 0, "full"), (130, 129, "full"), (600, 600, "plain"), (645, 129, "tiled")])
def test_masked_attention_route(N, tile, route):
    """The JAX rule (masked_attention.py:505-514): tileable = tile and N %
    tile == 0 and (tile - 1) % 128 == 0 takes the tiled kernels; else N <=
    512 the full-logits kernels; else the plain (XLA) path."""
    assert ops.masked_attention_route(N, tile) == route


@pytest.mark.parametrize("N, tile, fwd, bwd", [
    (129, 129, "masked_attention_tiled", "masked_attention_tiled_bwd"),
    (387, 129, "masked_attention_tiled", "masked_attention_tiled_bwd"),
    (258, 129, "masked_attention_tiled", "masked_attention_tiled_bwd"),
    (88, 88, "masked_attention_qkv", "masked_attention_qkv_bwd"),
    (264, 88, "masked_attention_qkv", "masked_attention_qkv_bwd")])
def test_dispatch_reaches_the_kernel_wrappers(monkeypatch, N, tile, fwd, bwd):
    """The CUDA branch without a card: the wrappers the dispatch calls are
    recorded (standing in for their kernels), forward and backward."""
    called = []
    names = ("masked_attention_tiled", "masked_attention_tiled_bwd",
             "masked_attention_qkv", "masked_attention_qkv_bwd")
    for name in names:
        real = getattr(port_ma, name)

        def record(*args, _name=name, _real=real):
            called.append(_name)
            return _real(*args)
        monkeypatch.setattr(port_ma, name, record)
    qkv = torch.from_numpy(_qkv(2, N, N)).requires_grad_()
    mask = torch.from_numpy(_mask(2, N, N + 1, tile))
    out = ops.masked_attention_from_qkv(qkv, mask, H, SCALE, FILL, tile)
    out.sum().backward()
    assert called == [fwd, bwd]
    called.clear()
    ops.masked_attention_from_qkv(qkv, mask, H, SCALE, FILL, tile, use_kernels=False)
    assert called == []


@pytest.mark.parametrize("N, tile", [(258, 129), (264, 88)])
def test_dispatch_on_cpu_runs_the_routed_plain_version_bf16(N, tile):
    (_, tq), mask = _bf16(_qkv(2, N, 50 + N)), torch.from_numpy(_mask(2, N, 51 + N, tile))
    got = ops.masked_attention_from_qkv(tq, mask, H, SCALE, FILL, tile)
    if tile == TILE:
        want = ops.masked_attention_tiled_plain(tq, mask, H, SCALE, FILL, tile)
    else:
        want = ops.masked_attention_qkv_plain(tq, mask, H, SCALE, FILL)
    assert torch.equal(got, want)
    assert torch.equal(ops.masked_attention_from_qkv(tq, mask, H, SCALE, FILL, tile,
                                                     use_kernels=False),
                       ops.masked_attention_qkv_plain(tq, mask, H, SCALE, FILL))


def test_tiled_wrappers_check_their_arguments():
    qkv, mask = torch.from_numpy(_qkv(2, 258, 1)), torch.from_numpy(_mask(2, 258, 2))
    before = ops.masked_attention_tiled.launches
    assert torch.equal(ops.masked_attention_tiled(qkv, mask.bool(), H, SCALE, FILL, TILE),
                       ops.masked_attention_tiled_plain(qkv, mask, H, SCALE, FILL, TILE))
    assert ops.masked_attention_tiled.launches == before  # no kernel on the CPU
    with pytest.raises(ValueError, match="tiles"):
        ops.masked_attention_tiled(qkv, mask, H, SCALE, FILL, 100)
    with pytest.raises(ValueError, match="mask"):
        ops.masked_attention_tiled_bwd(qkv, mask[:, 1:], qkv[..., :C], H, SCALE, FILL, TILE)
    with pytest.raises(ValueError, match="tile"):
        ops.masked_attention_tiled_fn(qkv, mask, H, SCALE, FILL, 0)


# ---------------------------------------------------------------------------
# K8: LayerNorm -> matmul + bias -> GELU
# ---------------------------------------------------------------------------

def _ln_inputs(T, Cin, O, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(T, Cin) * 2.0 + 0.5, rng.randn(O, Cin) * 0.1, rng.randn(O) * 0.1,
            1.0 + 0.1 * rng.randn(Cin), 0.1 * rng.randn(Cin))


@pytest.mark.parametrize("act", ["", "gelu"])
def test_ln_matmul_plain_matches_xla_f64(x64, act):
    # 70 rows: not a multiple of any row tile; a [2, 35, C] batch shape
    x, w, b, gm, bt = _ln_inputs(70, 96, 80, 60)
    ref = jax_fl._xla_ln_matmul(jnp.asarray(x).reshape(2, 35, 96), jnp.asarray(w.T),
                                jnp.asarray(b), jnp.asarray(gm), jnp.asarray(bt), 1e-6, act)
    t = [torch.from_numpy(a) for a in (x, w, b, gm, bt)]
    got = ops.ln_matmul(t[0].reshape(2, 35, 96), *t[1:], eps=1e-6, act=act)
    assert got.shape == (2, 35, 80)
    assert_close(got, ref)
    # without the bias: the JAX op with a zero bias
    nob = ops.ln_matmul_plain(t[0], t[1], None, t[3], t[4], 1e-6, act)
    ref0 = jax_fl._xla_ln_matmul(jnp.asarray(x), jnp.asarray(w.T), jnp.zeros(80),
                                 jnp.asarray(gm), jnp.asarray(bt), 1e-6, act)
    assert_close(nob, ref0)


@pytest.mark.parametrize("act", ["", "gelu"])
def test_ln_matmul_plain_matches_tpu_kernel_bf16(act):
    """``fused_linear._kernel`` in interpret mode with ``_pallas_ln_matmul``'s
    BlockSpecs (its row tile for T = 264 is 88)."""
    import jax.experimental.pallas as pl

    T, Cin, O = 264, 96, 384
    x, w, b, gm, bt = _ln_inputs(T, Cin, O, 61)
    jx, tx = _bf16(x)
    jw, tw = _bf16(w.T)
    R = jax_fl._pick_rows(T)
    assert T % R == 0
    f32 = [jnp.asarray(a, jnp.float32) for a in (b, gm, bt)]
    ref = pl.pallas_call(
        functools.partial(jax_fl._kernel, eps=1e-6, act=act),
        out_shape=jax.ShapeDtypeStruct((T, O), jnp.bfloat16), grid=(T // R,),
        in_specs=[pl.BlockSpec((R, Cin), lambda i: (i, 0)),
                  pl.BlockSpec((Cin, O), lambda i: (0, 0)),
                  pl.BlockSpec((O,), lambda i: (0,)),
                  pl.BlockSpec((Cin,), lambda i: (0,)),
                  pl.BlockSpec((Cin,), lambda i: (0,))],
        out_specs=pl.BlockSpec((R, O), lambda i: (i, 0)), interpret=True)(jx, jw, *f32)
    ref = np.asarray(ref.astype(jnp.float32))
    got = ops.ln_matmul_plain(tx, tw.t(), *(torch.from_numpy(a).float() for a in (b, gm, bt)),
                              eps=1e-6, act=act)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=_ulp_of_max(ref))


@pytest.mark.parametrize("act", ["", "gelu"])
def test_ln_matmul_fn_grad_matches_jax_vjp_f64(x64, act):
    x, w, b, gm, bt = _ln_inputs(21, 48, 32, 62)
    gout = np.random.RandomState(63).randn(21, 32)
    args = [jnp.asarray(a) for a in (x, w.T, b, gm, bt)]
    ref_out, vjp = jax.vjp(lambda *a: jax_fl.ln_matmul(*a, eps=1e-6, act=act), *args)
    refs = vjp(jnp.asarray(gout))
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, w, b, gm, bt)]
    out = ops.ln_matmul_fn(*ts, 1e-6, act)
    assert_close(out, ref_out)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(gout))
    for got, ref, name in zip(grads, refs, ("x", "w", "b", "gamma", "beta")):
        ref = np.asarray(ref)
        assert_close(got, ref.T if name == "w" else ref)
    # a gradient for x alone, and no bias
    tx = torch.from_numpy(x).requires_grad_()
    out = ops.ln_matmul_fn(tx, *(torch.from_numpy(a) for a in (w,)), None,
                           torch.from_numpy(gm), torch.from_numpy(bt), 1e-6, act)
    (gx,) = torch.autograd.grad(out, tx, torch.from_numpy(gout))
    assert gx.shape == tx.shape and torch.isfinite(gx).all()


def test_ln_matmul_wrapper_on_cpu_is_plain():
    x, w, b, gm, bt = (torch.from_numpy(a).float() for a in _ln_inputs(10, 32, 16, 64))
    before = ops.ln_matmul.launches
    assert torch.equal(ops.ln_matmul(x, w, b, gm, bt, act="gelu"),
                       ops.ln_matmul_plain(x, w, b, gm, bt, act="gelu"))
    assert ops.ln_matmul.launches == before
    with pytest.raises(ValueError, match="act"):
        ops.ln_matmul(x, w, b, gm, bt, act="relu")
    with pytest.raises(ValueError, match="weight"):
        ops.ln_matmul(x, w.t(), b, gm, bt)
