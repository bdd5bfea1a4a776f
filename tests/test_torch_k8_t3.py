"""K8 (``ln_matmul``) and T3 (``attn_layer``): their plain versions against
the TPU kernel bodies, with a check that can tell the bodies' rounding.

Both CUDA kernels run their products on one tensor-core GEMM body
(``csrc/ln_gemm_mma.cuh``; T3's attention on K1's forward body) and round
where the TPU bodies do: K8 (``fused_linear._kernel``) y = LN(x) rounded to
bf16, the product summed in fp32, + bias and the erf-GELU in fp32, one
rounding; T3 (``_attn_layer_kernel``) y rounded, qkv rounded, the patch keys'
probabilities rounded before p.v and the cls key's kept in fp32, each head's
output rounded, the projection + bias rounded once. On the card each kernel
is held to its plain version by the share of elements more than one bf16
ulp away (``_bench.bf16_off_share``, at most 0.5%; chip_smoke phases 2 and
7). Here, on the CPU, the same share test holds the plain versions to the
TPU bodies themselves, run through ``pl.pallas_call(..., interpret=True)``
with the JAX package's BlockSpecs (K8: ``_pallas_ln_matmul``'s row tile; T3:
the JAX tool's grid at its groups g = 2 and 4, probs refs by keyword), and
it must fail the wrong forms it exists to catch:

* K8: y left in fp32 (13% off on chip_smoke's inputs); the product rounded
  before the bias (``_xla_ln_matmul``'s form) and the GELU applied to a
  bf16-rounded pre-activation are under the limit on those inputs (weights
  x 0.02: pre-activations of ~0.7 and biases of 0.02 seldom move an output
  by more than an ulp), so they are read on "wide" inputs (weights x 0.05,
  biases x 0.3: pre-activations of ~1.9, biases comparable), where they are
  2.5-6.5% and ~4% off;
* T3: qkv left in fp32, the attention's output left in fp32, the cls key's
  probability rounded (``bench_attn_layer.WRONG_FORMS``), each several %
  off at the flagship width on the JAX script's inputs.
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
import torch.nn.functional as F

from editor_tpu_torch import ops
from editor_tpu_torch.ops._checks import GEMM_MAX_C
from editor_tpu_torch.ops.fused_linear import check_k8_shape, f32_param
from editor_tpu_torch.tools import _bench, bench_attn_layer
from tests.torch_parity import bf16_pair as _bf16

REPO = Path(__file__).resolve().parent.parent
jax_fl = importlib.import_module("editor_tpu.ops.fused_linear")
SHARE_TOL = 0.005  # chip_smoke.SHARE_TOL
EPS = 1e-6


def _np(a) -> torch.Tensor:
    return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32)))


# ---------------------------------------------------------------------------
# K8
# ---------------------------------------------------------------------------

# (weight scale at C = 768, bias scale): chip_smoke's flagship inputs and the
# wide ones; at another C the weight scale goes with 1 / sqrt(C), so that the
# pre-activations keep their size
K8_KINDS = {"flagship": (0.02, 0.02), "wide": (0.05, 0.3)}


@functools.lru_cache(maxsize=None)
def _k8_inputs(T, Cin, O, kind):
    """Seeded inputs as chip_smoke makes them: x randn x 2 (bf16), the weight
    [O, C] and bias at the kind's scales, gamma 1 + 0.1 randn, beta 0.1
    randn (fp32); the weight rounded to bf16 as the wrapper casts it."""
    ws, bs = K8_KINDS[kind]
    ws *= (768 / Cin) ** 0.5
    rng = np.random.RandomState(T + O + (kind == "wide"))
    jx, tx = _bf16(rng.randn(T, Cin) * 2.0)
    jw, tw = _bf16(rng.randn(O, Cin) * ws)
    b, gm, bt = (rng.randn(O) * bs, 1.0 + 0.1 * rng.randn(Cin), 0.1 * rng.randn(Cin))
    return (jx, jw), (tx, tw.float(), *(torch.from_numpy(a).float() for a in (b, gm, bt)))


@functools.lru_cache(maxsize=None)
def _k8_body(T, Cin, O, kind, act):
    """``fused_linear._kernel`` in interpret mode with ``_pallas_ln_matmul``'s
    BlockSpecs: out [T, O] fp32."""
    import jax.experimental.pallas as pl

    (jx, jw), (_, _, b, gm, bt) = _k8_inputs(T, Cin, O, kind)
    R = jax_fl._pick_rows(T)
    assert T % R == 0
    f32 = [jnp.asarray(t.numpy(), jnp.float32) for t in (b, gm, bt)]
    out = pl.pallas_call(
        functools.partial(jax_fl._kernel, eps=EPS, act=act),
        out_shape=jax.ShapeDtypeStruct((T, O), jnp.bfloat16), grid=(T // R,),
        in_specs=[pl.BlockSpec((R, Cin), lambda i: (i, 0)),
                  pl.BlockSpec((Cin, O), lambda i: (0, 0)),
                  pl.BlockSpec((O,), lambda i: (0,)),
                  pl.BlockSpec((Cin,), lambda i: (0,)),
                  pl.BlockSpec((Cin,), lambda i: (0,))],
        out_specs=pl.BlockSpec((R, O), lambda i: (i, 0)), interpret=True)(jx, jw.T, *f32)
    return _np(out)


def _k8_form(form, T, Cin, O, kind, act):
    """K8's output in a wrong form, composed from the plain version:
    ``y_fp32`` (the LayerNorm's output not rounded: the plain version on
    fp32 x), ``product_rounded`` (the product rounded before the bias, as
    ``_xla_ln_matmul``), ``gelu_on_bf16`` (the GELU of the rounded
    pre-activation). chip_smoke composes the same three."""
    _, (x, w, b, gm, bt) = _k8_inputs(T, Cin, O, kind)
    if form == "y_fp32":
        return ops.ln_matmul_plain(x.float(), w, b, gm, bt, EPS, act).bfloat16()
    if form == "product_rounded":
        out = ops.ln_matmul_plain(x, w, None, gm, bt, EPS, "").float() + b
        return (F.gelu(out) if act else out).bfloat16()
    return F.gelu(ops.ln_matmul_plain(x, w, b, gm, bt, EPS, "").float()).bfloat16()


# T = 264: _pallas_ln_matmul's row tile is 88; C = 768 the backbone's, 128 narrow
K8_SHAPES = [(264, 768, 384), (264, 128, 256)]


@pytest.mark.parametrize("kind", list(K8_KINDS))
@pytest.mark.parametrize("act", ["", "gelu"])
@pytest.mark.parametrize("T, Cin, O", K8_SHAPES)
def test_k8_plain_passes_share_test(T, Cin, O, act, kind):
    _, ins = _k8_inputs(T, Cin, O, kind)
    got = ops.ln_matmul_plain(*ins, EPS, act)
    assert got.dtype == torch.bfloat16
    assert _bench.bf16_off_share(got, _k8_body(T, Cin, O, kind, act)) <= SHARE_TOL


@pytest.mark.parametrize("form, kind, act", [
    ("y_fp32", "flagship", ""), ("y_fp32", "flagship", "gelu"), ("y_fp32", "wide", "gelu"),
    ("product_rounded", "wide", ""), ("product_rounded", "wide", "gelu"),
    ("gelu_on_bf16", "wide", "gelu")])
@pytest.mark.parametrize("T, Cin, O", K8_SHAPES)
def test_k8_wrong_forms_fail_the_share_test(T, Cin, O, form, kind, act):
    share = _bench.bf16_off_share(_k8_form(form, T, Cin, O, kind, act),
                                  _k8_body(T, Cin, O, kind, act))
    assert share > SHARE_TOL, share


def test_k8_forms_not_told_apart_on_flagship_inputs():
    """Why two of K8's wrong forms are read on the wide inputs: on
    chip_smoke's flagship-like ones the product rounded before the bias sits
    at the limit (within 2x either side of it) and the GELU of a rounded
    pre-activation far under it."""
    T, Cin, O = K8_SHAPES[0]
    ref = _k8_body(T, Cin, O, "flagship", "gelu")
    rounded = _bench.bf16_off_share(
        _k8_form("product_rounded", T, Cin, O, "flagship", "gelu"), ref)
    assert SHARE_TOL / 2 < rounded < 2 * SHARE_TOL
    gelu = _bench.bf16_off_share(_k8_form("gelu_on_bf16", T, Cin, O, "flagship", "gelu"), ref)
    assert gelu < SHARE_TOL / 5


def test_check_k8_shape():
    """The shapes K8's CUDA kernel takes, checked without a card: C and O
    multiples of 16, C up to GEMM_MAX_C (a lane's share of a row in
    registers in the LayerNorm pre-pass)."""
    for C, O in ((768, 2304), (768, 3072), (16, 16), (GEMM_MAX_C, 256), (1024, 512)):
        check_k8_shape(C, O)
    for C, O in ((760, 2304), (768, 2300), (GEMM_MAX_C + 16, 256), (0, 16), (16, 8)):
        with pytest.raises(ValueError, match="multiples of 16"):
            check_k8_shape(C, O)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k8_fp32_params_are_16_byte_aligned(dtype):
    """K8 reads gamma and beta with 16-byte loads: the wrapper hands the
    kernel fp32 copies whose base is 16-byte aligned, also where the caller
    passes a view at a 4-byte offset, with the values unchanged."""
    base = torch.arange(41, dtype=dtype)
    for t in (base, base[1:], base[3:40]):
        got = f32_param(t, t.device)
        assert got.dtype == torch.float32 and got.is_contiguous()
        assert got.data_ptr() % 16 == 0
        assert torch.equal(got, t.float())
    assert base.float()[1:].data_ptr() % 16  # an fp32 view at offset 1 is misaligned


def test_k8_wrapper_on_cpu_runs_plain_beyond_the_kernel_shapes():
    """On CPU tensors the wrapper runs the plain version, also at a C the
    kernel refuses, and counts no launch."""
    rng = np.random.RandomState(3)
    x, w, b, gm, bt = (torch.from_numpy(a).float() for a in (
        rng.randn(5, 40), rng.randn(24, 40), rng.randn(24), rng.randn(40), rng.randn(40)))
    before = ops.ln_matmul.launches
    assert torch.equal(ops.ln_matmul(x, w, b, gm, bt, act="gelu"),
                       ops.ln_matmul_plain(x, w, b, gm, bt, act="gelu"))
    assert ops.ln_matmul.launches == before


# ---------------------------------------------------------------------------
# T3
# ---------------------------------------------------------------------------

@functools.cache
def _tool(name: str):
    """A JAX script of ``tools/``, loaded by file path (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}",
                                                  REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def _layer_inputs(B, N, C, wscale):
    """The JAX script's inputs (x randn x 0.5, LN weight rand + 0.5, LN bias
    randn x 0.1, weights randn x wscale, biases randn x 0.02), bf16, as
    (jax arrays, torch tensors)."""
    rng = np.random.RandomState(B * N + C)
    arrays = (rng.randn(B, N, C) * 0.5, rng.rand(C) + 0.5, rng.randn(C) * 0.1,
              rng.randn(C, 3 * C) * wscale, rng.randn(3 * C) * 0.02,
              rng.randn(C, C) * wscale, rng.randn(C) * 0.02)
    pairs = [_bf16(a) for a in arrays]
    return tuple(p[0] for p in pairs), tuple(p[1] for p in pairs)


@functools.lru_cache(maxsize=None)
def _t3_body(B, N, C, H, wscale, g):
    """``_attn_layer_kernel`` with probs in interpret mode with the JAX
    tool's BlockSpecs (grid B / g): (out [B, N, C], probs [B, H, N, N]) fp32."""
    import jax.experimental.pallas as pl

    jin, _ = _layer_inputs(B, N, C, wscale)
    body = functools.partial(_tool("bench_attn_layer")._attn_layer_kernel,
                             scale=(C // H) ** -0.5, H=H, D=C // H, eps=EPS, with_probs=True)

    def kernel(*refs):
        body(*refs[:8], pp_ref=refs[8], pc_ref=refs[9])

    out, pp, pc = pl.pallas_call(
        kernel,
        out_shape=(jax.ShapeDtypeStruct((B, N, C), jnp.bfloat16),
                   jax.ShapeDtypeStruct((B, H, N, N - 1), jnp.bfloat16),
                   jax.ShapeDtypeStruct((B, H, N), jnp.bfloat16)),
        grid=(B // g,),
        in_specs=[pl.BlockSpec((g, N, C), lambda i: (i, 0, 0)),
                  pl.BlockSpec((C,), lambda i: (0,)), pl.BlockSpec((C,), lambda i: (0,)),
                  pl.BlockSpec((C, 3 * C), lambda i: (0, 0)),
                  pl.BlockSpec((3 * C,), lambda i: (0,)),
                  pl.BlockSpec((C, C), lambda i: (0, 0)), pl.BlockSpec((C,), lambda i: (0,))],
        out_specs=(pl.BlockSpec((g, N, C), lambda i: (i, 0, 0)),
                   pl.BlockSpec((g, H, N, N - 1), lambda i: (i, 0, 0, 0)),
                   pl.BlockSpec((g, H, N), lambda i: (i, 0, 0))),
        interpret=True)(*jin)
    return _np(out), _np(jnp.concatenate([pc[..., None], pp], axis=-1))


# (B, N, C, H, weight scale): the flagship width at 129 tokens (the JAX
# script's weights x 0.03) and a narrow one (x 0.2, so that the logits are
# not all ~0)
T3_SHAPES = [(4, 129, 768, 12, 0.03), (4, 17, 32, 2, 0.2)]
FLAGSHIP, NARROW = T3_SHAPES


def _body_qkv(B, N, C, H, ws, g):
    """The TPU body's own qkv (its first stage, the same jnp ops on the same
    [g, N, C] blocks), as a bf16 tensor."""
    jin, _ = _layer_inputs(B, N, C, ws)
    x, lnw, lnb, wqkv, bqkv = jin[:5]

    @jax.jit
    def stage(xb):
        xf = xb.astype(jnp.float32)
        mu = jnp.mean(xf, axis=-1, keepdims=True)
        var = jnp.mean(jnp.square(xf - mu), axis=-1, keepdims=True)
        y = ((xf - mu) * jax.lax.rsqrt(var + EPS) * lnw.astype(jnp.float32)
             + lnb.astype(jnp.float32)).astype(xb.dtype)
        qkv = jax.lax.dot_general(y, wqkv, (((2,), (0,)), ((), ())),
                                  preferred_element_type=jnp.float32)
        return (qkv + bqkv.astype(jnp.float32)).astype(xb.dtype)

    return _np(jnp.concatenate([stage(x[i:i + g]) for i in range(0, B, g)])).bfloat16()


@pytest.mark.parametrize("g", [2, 4])
@pytest.mark.parametrize("B, N, C, H, ws", T3_SHAPES)
def test_t3_plain_stages_pass_share_test(B, N, C, H, ws, g):
    """The plain version's attention and projection stages on the TPU body's
    own qkv give the body's output (share test), and its probs pass end to
    end; at the narrow width its output passes end to end too."""
    ref_out, ref_probs = _t3_body(B, N, C, H, ws, g)
    _, tin = _layer_inputs(B, N, C, ws)
    scale = (C // H) ** -0.5
    att = ops.attention_qkv_tpu_plain(_body_qkv(B, N, C, H, ws, g), H, scale, False)
    assert _bench.bf16_off_share(bench_attn_layer.proj_plain(att, *tin[5:], torch.bfloat16),
                                 ref_out) <= SHARE_TOL
    out, probs = bench_attn_layer.attn_layer_plain(*tin, H, scale, EPS, True)
    assert out.dtype == probs.dtype == torch.bfloat16
    assert _bench.bf16_off_share(probs, ref_probs) <= SHARE_TOL
    torch.testing.assert_close(probs.float().sum(-1), torch.ones(B, H, N), rtol=0, atol=1e-2)
    if (B, N, C, H, ws) == NARROW:
        assert _bench.bf16_off_share(out, ref_out) <= SHARE_TOL


def test_t3_output_is_chaotic_in_the_qkv_sum_order():
    """Why T3's output is held stage by stage: at the flagship width the
    plain version's qkv and the TPU body's differ only by the fp32 order of
    the product's sums (under 0.2% of the elements, one bf16 step each), yet
    the outputs end to end are more than SHARE_TOL apart."""
    B, N, C, H, ws = FLAGSHIP
    _, tin = _layer_inputs(B, N, C, ws)
    qkv = bench_attn_layer.qkv_plain(*tin[:5], EPS)
    body_qkv = _body_qkv(B, N, C, H, ws, 2)
    assert 0 < float((qkv != body_qkv).float().mean()) < 0.002
    assert _bench.bf16_off_share(qkv, body_qkv) <= SHARE_TOL
    out = bench_attn_layer.attn_layer_plain(*tin, H, (C // H) ** -0.5, EPS, False)
    assert _bench.bf16_off_share(out, _t3_body(B, N, C, H, ws, 2)[0]) > SHARE_TOL


@pytest.mark.parametrize("form", list(bench_attn_layer.WRONG_FORMS))
def test_t3_wrong_forms_fail_the_share_test(form):
    """End to end, where the plain version passes (the narrow width)."""
    B, N, C, H, ws = NARROW
    ref_out, _ = _t3_body(B, N, C, H, ws, 2)
    _, tin = _layer_inputs(B, N, C, ws)
    got = bench_attn_layer.attn_layer_form(*tin, H, (C // H) ** -0.5, EPS, form)
    share = _bench.bf16_off_share(got, ref_out)
    assert share > SHARE_TOL, share


@pytest.mark.parametrize("B, N, C, H, ws", T3_SHAPES)
def test_t3_stage_shares(B, N, C, H, ws):
    """chip_smoke's stage-wise reading on the plain stages (the CPU path of
    ``attn_layer_stages``): every stage's share is 0 and every wrong form
    but the cls-rounded one (named where it is not told apart) fails it at
    the stage where it acts."""
    _, tin = _layer_inputs(B, N, C, ws)
    scale = (C // H) ** -0.5
    before = bench_attn_layer.attn_layer.launches
    out, qkv, att = bench_attn_layer.attn_layer_stages(*tin, H, scale, EPS, 2)
    assert bench_attn_layer.attn_layer.launches == before
    assert torch.equal(out, bench_attn_layer.attn_layer_plain(*tin, H, scale, EPS, False))
    shares, wrong = bench_attn_layer.stage_shares(*tin, H, scale, EPS, qkv, att, out)
    assert shares == {"qkv": 0.0, "att": 0.0, "out": 0.0}
    for form in ("y_fp32", "qkv_fp32", "att_fp32"):
        assert wrong[form] > SHARE_TOL, (form, wrong)
    # the cls key's rounding sits at the limit (0.55% at the flagship width,
    # 1.5% at the narrow one): K1's and T1's checks hold it for this body
    assert SHARE_TOL / 2 < wrong["cls_rounded"] < 4 * SHARE_TOL


def test_t3_plain_is_the_forms_with_every_rounding():
    B, N, C, H, ws = NARROW
    _, tin = _layer_inputs(B, N, C, ws)
    plain = bench_attn_layer.attn_layer_plain(*tin, H, 0.25, EPS, False)
    assert torch.equal(plain, bench_attn_layer._attn_layer(*tin, H, 0.25, EPS, False))
    for form in bench_attn_layer.WRONG_FORMS:
        assert not torch.equal(plain, bench_attn_layer.attn_layer_form(*tin, H, 0.25, EPS,
                                                                       form))


def test_check_t3_shape():
    """The shapes T3's CUDA kernel takes, checked without a card: K1's head
    dims (multiples of 16 up to 128), C up to GEMM_MAX_C, N up to 512."""
    check = bench_attn_layer.check_t3_shape
    for N, C, H in ((129, 768, 12), (1, 32, 2), (512, 1536, 12), (200, 48, 3)):
        check(N, C, H)
    refused = {"D = 8": (129, 96, 12), "D = 144": (129, 576, 4),
               "C > GEMM_MAX_C": (129, 1664, 13),
               "N > 512": (513, 768, 12), "N = 0": (0, 768, 12),
               "heads do not split C": (129, 768, 7)}
    for why, (N, C, H) in refused.items():
        with pytest.raises(ValueError, match="attn_layer"):
            check(N, C, H)


def test_t3_weight_bytes():
    """The weight bytes T3's chunks of 144 rows stream through L2 at the
    flagship shape: both matrices (4 C^2 bf16) once per chunk, one chunk a
    sequence at g = 1, 2 a block at g = 2 and 4 at g = 4; below the 48-row
    chunks' 5.4 GB of the first version."""
    wb = 4 * 768 * 768 * 2
    for g in (1, 2, 4):
        assert bench_attn_layer.weight_bytes(384, 129, 768, g) == 384 * wb
    assert bench_attn_layer.weight_bytes(5, 17, 32, 2) == 3 * 4 * 32 * 32 * 2
    assert bench_attn_layer.weight_bytes(3, 200, 64, 2) == (3 + 2) * 4 * 64 * 64 * 2
    assert bench_attn_layer.weight_bytes(384, 129, 768, 1) < 5.4e9


@pytest.mark.parametrize("g", [1, 2, 4])
def test_t3_wrapper_on_cpu_runs_plain_at_any_group(g):
    _, tin = _layer_inputs(4, 17, 32, 0.2)
    before = bench_attn_layer.attn_layer.launches
    out, probs = bench_attn_layer.attn_layer(*tin, 2, 0.25, EPS, g)
    assert probs is None
    assert torch.equal(out, bench_attn_layer.attn_layer_plain(*tin, 2, 0.25, EPS, False))
    assert bench_attn_layer.attn_layer.launches == before
