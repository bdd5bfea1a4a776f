"""T6 (``bench_full_kernel.masked_full`` and ``masked_full_bwd``): K3 and K5
walking g sequences a block, at the JAX tool's groups.

The JAX tool (``tools/bench_full_kernel.py``) runs K3's and K5's TPU bodies,
``_qkv_masked_full_kernel`` and ``_qkv_masked_full_bwd_kernel``, with g
sequences per grid step: 4, 8, 16 and 32 at N = 88, 1, 2 and 4 at N = 264.
The port runs K3's and K5's tensor-core kernels with each block walking g
sequences; each pair is computed as K3's and K5's own blocks compute it, so
on the card T6 equals K3 and K5 at ``group=0`` bit for bit (chip_smoke phase
7), and it is held to the plain versions in the TPU bodies' forms
(``masked_full_plain``, ``masked_full_bwd_plain``) by K3's and K5's share
tests. Here, on the CPU, the same share tests hold those plain versions to
the TPU bodies themselves, run through ``pl.pallas_call(...,
interpret=True)`` with the JAX tool's BlockSpecs at its groups (B = 8, N =
88 at g 4 and 8; B = 4, N = 264 at g 1, 2 and 4; H = 2, D = 16), and show
that they fail the wrong forms they exist to catch:

* forward: the unrounded form (the plain version on fp32 inputs, rounded
  once) and the XLA form (``masked_attention_qkv_plain``: normalised,
  re-masked weights rounded), over all elements;
* backward: the unrounded form over all elements, and the cls-kept form
  (K7's, ``masked_attention_tiled_bwd_plain`` with tile 88) over the dk and
  dv of the rows m % 88 == 0.

The CPU wrappers run the plain versions at every group and count nothing;
a negative group is refused, and T6 refuses g = 0 (K3's and K5's own launch).
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
from editor_tpu_torch.tools import _bench, bench_full_kernel
from tests.torch_parity import bf16_pair as _bf16

jax_ma = importlib.import_module("editor_tpu.ops.masked_attention")

H, D = 2, 16
C = H * D
SCALE = D ** -0.5
FILL = -65504.0
CLS = 88  # chip_smoke.K5_CLS_ROWS: the compact tail's cls tokens
SHARE_TOL = 0.005  # chip_smoke.SHARE_TOL
# (B, N, g): the JAX tool's groups at its two token counts
CASES = [(8, 88, 4), (8, 88, 8), (4, 264, 1), (4, 264, 2), (4, 264, 4)]
IDS = [f"B{b}-N{n}-g{g}" for b, n, g in CASES]


def _tool_body(kernel, g, qkv, mask, gout=None):
    """A TPU body of the JAX tool in Pallas interpret mode, with its
    BlockSpecs: g sequences per grid step (tools/bench_full_kernel.py:54,
    :72)."""
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
    return torch.from_numpy(np.array(out.astype(jnp.float32)))


@functools.lru_cache(maxsize=None)
def _inputs(B, N):
    """Seeded bf16 qkv and cotangent, and chip_smoke phase 2's masks: rand <
    0.5 with every cls token (m % 88 == 0) kept and sequence 0 masked but
    for its cls token."""
    rng = np.random.RandomState(B + N)
    jq, tq = _bf16(rng.randn(B, N, 3 * C))
    jg, tg = _bf16(rng.randn(B, N, C))
    m = rng.rand(B, N) < 0.5
    m[:, ::CLS] = True
    m[0, 1:] = False
    mask = m.astype(np.float32)
    return jq, tq, jg, tg, mask


@functools.lru_cache(maxsize=None)
def _case(B, N, g):
    """(qkv, mask, g_out as torch tensors, the forward and backward TPU
    bodies' outputs at group g as fp32 tensors)."""
    jq, tq, jg, tg, mask = _inputs(B, N)
    jm = jnp.asarray(mask)
    fwd = _tool_body(jax_ma._qkv_masked_full_kernel, g, jq, jm)
    bwd = _tool_body(jax_ma._qkv_masked_full_bwd_kernel, g, jq, jm, jg)
    return tq, torch.from_numpy(mask), tg, fwd, bwd


def _cls_rows(t):
    """The dk and dv of the rows m % 88 == 0."""
    return t[:, ::CLS, C:]


@pytest.mark.parametrize("B, N, g", CASES, ids=IDS)
def test_forward_plain_passes_the_share_test_against_tpu_body(B, N, g):
    qkv, mask, _, ref, _ = _case(B, N, g)
    got = bench_full_kernel.masked_full_plain(qkv, mask, H, SCALE, FILL)
    assert got.dtype == torch.bfloat16
    share = _bench.bf16_off_share(got, ref)
    assert share <= SHARE_TOL, share
    assert torch.count_nonzero(got[mask == 0]) == 0
    assert torch.count_nonzero(ref[mask == 0]) == 0


@pytest.mark.parametrize("B, N, g", CASES, ids=IDS)
def test_forward_unrounded_form_fails_the_share_test(B, N, g):
    qkv, mask, _, ref, _ = _case(B, N, g)
    unrounded = bench_full_kernel.masked_full_plain(qkv.float(), mask, H, SCALE,
                                                    FILL).bfloat16()
    share = _bench.bf16_off_share(unrounded, ref)
    assert share > SHARE_TOL, share


@pytest.mark.parametrize("B, N, g", CASES, ids=IDS)
def test_forward_xla_form_fails_the_share_test(B, N, g):
    qkv, mask, _, ref, _ = _case(B, N, g)
    xla = ops.masked_attention_qkv_plain(qkv, mask, H, SCALE, FILL)
    share = _bench.bf16_off_share(xla, ref)
    assert share > SHARE_TOL, share


@pytest.mark.parametrize("B, N, g", CASES, ids=IDS)
def test_backward_plain_passes_the_share_tests_against_tpu_body(B, N, g):
    qkv, mask, g_out, _, ref = _case(B, N, g)
    got = bench_full_kernel.masked_full_bwd_plain(qkv, mask, g_out, H, SCALE, FILL)
    assert got.dtype == torch.bfloat16
    share = _bench.bf16_off_share(got, ref)
    cls = _bench.bf16_off_share(_cls_rows(got), _cls_rows(ref))
    assert share <= SHARE_TOL and cls <= SHARE_TOL, (share, cls)
    assert torch.count_nonzero(got[mask == 0]) == 0


@pytest.mark.parametrize("B, N, g", CASES, ids=IDS)
def test_backward_unrounded_form_fails_the_share_test(B, N, g):
    qkv, mask, g_out, _, ref = _case(B, N, g)
    unrounded = bench_full_kernel.masked_full_bwd_plain(qkv.float(), mask, g_out.float(), H,
                                                        SCALE, FILL).bfloat16()
    share = _bench.bf16_off_share(unrounded, ref)
    assert share > SHARE_TOL, share


@pytest.mark.parametrize("B, N, g", CASES, ids=IDS)
def test_backward_cls_kept_form_fails_the_cls_row_test(B, N, g):
    """K7's form keeps the keys m % 88 == 0 in fp32: off the TPU body in more
    than the limit over those rows' dk and dv."""
    qkv, mask, g_out, _, ref = _case(B, N, g)
    cls_kept = ops.masked_attention_tiled_bwd_plain(qkv, mask, g_out, H, SCALE, FILL, CLS)
    cls = _bench.bf16_off_share(_cls_rows(cls_kept), _cls_rows(ref))
    assert cls > SHARE_TOL, cls


@pytest.mark.parametrize("N", [1, 17, 88, 128, 129, 264, 320, 321, 512])
@pytest.mark.parametrize("B", [1, 3, 6, 128, 384])
def test_full_group_is_the_jax_packages(B, N):
    """The groups chip_smoke and the sweep call the JAX package's are
    ``_full_group``'s, forward and backward."""
    assert bench_full_kernel.full_group(N, B) == jax_ma._full_group(N, B)
    assert bench_full_kernel.full_group(N, B, bwd=True) == jax_ma._full_group(N, B, bwd=True)


def _counts():
    return [(fn.launches, fn.variant_launches) for fn in ops.GROUP_WRAPPERS]


@pytest.mark.parametrize("group", [0, 1, 2, 3, 8, 32])
def test_cpu_wrappers_run_the_plain_versions_at_every_group(group):
    """On CPU tensors K3, K5 and K6 run their plain versions at any group
    (a B that g does not divide too), and T6 at any g >= 1; nothing is
    counted."""
    _, tq, _, tg, mask = _inputs(8, 88)
    qkv, g_out, m = tq[:5], tg[:5], torch.from_numpy(mask[:5])
    before = _counts()
    assert torch.equal(ops.masked_attention_qkv(qkv, m, H, SCALE, FILL, group=group),
                       ops.masked_attention_qkv_plain(qkv, m, H, SCALE, FILL))
    assert torch.equal(ops.masked_attention_qkv_bwd(qkv, m, g_out, H, SCALE, FILL, group=group),
                       ops.masked_attention_qkv_bwd_plain(qkv, m, g_out, H, SCALE, FILL))
    assert torch.equal(ops.masked_attention_tiled(qkv, m, H, SCALE, FILL, 22, group=group),
                       ops.masked_attention_tiled_plain(qkv, m, H, SCALE, FILL, 22))
    if group:
        assert torch.equal(bench_full_kernel.masked_full(qkv, m, H, SCALE, group, FILL),
                           bench_full_kernel.masked_full_plain(qkv, m, H, SCALE, FILL))
        assert torch.equal(bench_full_kernel.masked_full_bwd(qkv, m, g_out, H, SCALE, group,
                                                             FILL),
                           bench_full_kernel.masked_full_bwd_plain(qkv, m, g_out, H, SCALE,
                                                                   FILL))
    assert _counts() == before


@pytest.mark.parametrize("group", [-1, -8])
def test_negative_group_is_refused(group):
    _, tq, _, tg, mask = _inputs(8, 88)
    m = torch.from_numpy(mask)
    with pytest.raises(ValueError, match="group"):
        ops.masked_attention_qkv(tq, m, H, SCALE, FILL, group=group)
    with pytest.raises(ValueError, match="group"):
        ops.masked_attention_qkv_bwd(tq, m, tg, H, SCALE, FILL, group=group)
    with pytest.raises(ValueError, match="group"):
        ops.masked_attention_tiled(tq, m, H, SCALE, FILL, 22, group=group)
    with pytest.raises(ValueError, match="group"):
        port_ma.check_group(group)


@pytest.mark.parametrize("g", [0, -2])
def test_t6_refuses_fewer_than_one_sequence_a_block(g):
    """g = 0 is K3's and K5's own launch, which counts in ``launches``: T6
    takes g >= 1."""
    _, tq, _, tg, mask = _inputs(8, 88)
    m = torch.from_numpy(mask)
    with pytest.raises(ValueError, match="g = "):
        bench_full_kernel.masked_full(tq, m, H, SCALE, g)
    with pytest.raises(ValueError, match="g = "):
        bench_full_kernel.masked_full_bwd(tq, m, tg, H, SCALE, g)
