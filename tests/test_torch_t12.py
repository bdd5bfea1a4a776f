"""T1 (``headgrid_attn``) and T2 (``nomax_attn``): their plain versions
against the TPU kernel bodies, with a check that can tell the bodies'
rounding.

The CUDA kernels (the ``kSplit`` and ``kNoMax`` forms of K1's tensor-core
forward, ``csrc/attention_variants.cu``) round where the TPU bodies
``_headgrid_kernel`` (``_split_softmax_av``) and ``_kernel_nomax`` do: fp32
logits, exp and sum, p normalised before it is rounded, the patch keys' p
rounded to bf16 before p.v, the cls key's p_0 kept in fp32, out rounded
once; T2 without the row max. On the card they are held to their plain
versions by the share of elements more than one bf16 ulp away
(``_bench.bf16_off_share``, at most 0.5%; chip_smoke phase 7). Here, on the
CPU, the same share test holds the plain versions to the TPU bodies
themselves, run through ``pl.pallas_call(..., interpret=True)`` with the
tools' BlockSpecs (probs refs passed by keyword) on the same bf16 inputs, at
H = 12, D = 64, N = 129 and at H = 2, D = 16 with N = 129 and 258 (past K1's
resident 144 keys: the chunked instance's shape), ``hps`` 1 and 2, ``g`` 1
and 2: at most 0.006% of the elements off, and T1's probs within one bf16
ulp each. The test fails the two wrong forms it exists to catch:

* the unrounded form (the plain version on fp32 inputs, rounded once):
  12-13% of the elements off on random-normal inputs;
* the cls-rounded form (``attention_qkv_plain``, the model path's XLA form,
  which rounds p_0 to bf16 too): only 0.44-0.62% on random-normal inputs,
  where p_0 ~ 1/N and its rounding seldom moves an output by more than an
  ulp. So it is read on inputs where the cls key carries most of each row's
  weight (q shares a direction with k_0: p_0 ~ 0.6-0.75) and v_0 is a tenth
  of the other values, so that p_0 v_0 is about the size of the patch keys'
  sum: there the cls-rounded form is 3.1-4.2% off, the unrounded form
  5.9-6.6%, the plain versions at most 0.006%.
"""

import functools
import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from editor_tpu_torch import ops
from editor_tpu_torch.ops import _build
from editor_tpu_torch.ops._checks import rows_stride
from editor_tpu_torch.tools import _bench, bench_attn, bench_attn2
from tests.torch_parity import bf16_pair as _bf16

REPO = Path(__file__).resolve().parent.parent
SHARE_TOL = 0.005  # chip_smoke.SHARE_TOL
B = 2
# (N, H, D): the flagship's heads at 129 tokens, and a narrow width at one
# key chunk and at two (K1's chunked instance)
SHAPES = [(129, 12, 64), (129, 2, 16), (258, 2, 16)]
KINDS = ["randn", "cls"]


@functools.cache
def _tool(name: str):
    """A JAX script of ``tools/``, loaded by file path (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}",
                                                  REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def _qkv(N, H, D, kind):
    """Seeded bf16 qkv [B, N, 3C] as (jax array, torch tensor); ``cls``: made
    cls-heavy by ``bench_attn.cls_heavy``, as chip_smoke's are."""
    x = np.random.RandomState(N + H).randn(B, N, 3 * H * D)
    if kind == "cls":
        x = bench_attn.cls_heavy(torch.from_numpy(x), H).numpy()
    return _bf16(x)


def _np(a) -> torch.Tensor:
    return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32)))


@functools.lru_cache(maxsize=None)
def _headgrid_body(N, H, D, kind, g, hps):
    """``_headgrid_kernel`` with probs in Pallas interpret mode, with
    ``headgrid_attn``'s BlockSpecs: (out [B, N, C], probs [B, H, N, N]) fp32."""
    import jax.experimental.pallas as pl

    jq, _ = _qkv(N, H, D, kind)
    C = H * D
    q, k, v = (jq[..., i * C:(i + 1) * C] for i in range(3))
    spec = pl.BlockSpec((g, N, D * hps), lambda i, h: (i, 0, h))
    body = functools.partial(_tool("bench_attn")._headgrid_kernel, scale=D ** -0.5,
                             with_probs=True, heads_per_step=hps)

    def kernel(q_ref, k_ref, v_ref, o_ref, pp_ref, pc_ref):
        body(q_ref, k_ref, v_ref, o_ref, pp_ref=pp_ref, pc_ref=pc_ref)

    out, pp, pc = pl.pallas_call(
        kernel,
        out_shape=(jax.ShapeDtypeStruct((B, N, C), q.dtype),
                   jax.ShapeDtypeStruct((B, H, N, N - 1), q.dtype),
                   jax.ShapeDtypeStruct((B, H, N), q.dtype)),
        grid=(B // g, H // hps), in_specs=[spec] * 3,
        out_specs=(spec, pl.BlockSpec((g, hps, N, N - 1), lambda i, h: (i, h, 0, 0)),
                   pl.BlockSpec((g, hps, N), lambda i, h: (i, h, 0))),
        interpret=True)(q, k, v)
    return _np(out), _np(jnp.concatenate([pc[..., None], pp], axis=-1))


@functools.lru_cache(maxsize=None)
def _nomax_body(N, H, D, kind, g):
    """``_kernel_nomax`` in Pallas interpret mode with ``nomax_attn``'s
    BlockSpecs: out [B, N, C] fp32."""
    import jax.experimental.pallas as pl

    jq, _ = _qkv(N, H, D, kind)
    C = H * D
    out = pl.pallas_call(
        functools.partial(_tool("bench_attn2")._kernel_nomax, scale=D ** -0.5, H=H, D=D),
        out_shape=jax.ShapeDtypeStruct((B, N, C), jq.dtype), grid=(B // g,),
        in_specs=[pl.BlockSpec((g, N, 3 * C), lambda i: (i, 0, 0))],
        out_specs=pl.BlockSpec((g, N, C), lambda i: (i, 0, 0)), interpret=True)(jq)
    return _np(out)


def _split(N, H, D, kind):
    _, tq = _qkv(N, H, D, kind)
    return tq.split(H * D, -1)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("hps, g", [(1, 1), (1, 2), (2, 1), (2, 2)])
@pytest.mark.parametrize("N, H, D", SHAPES)
def test_headgrid_plain_passes_share_test(N, H, D, hps, g, kind):
    ref_out, ref_probs = _headgrid_body(N, H, D, kind, g, hps)
    out, probs = bench_attn.headgrid_attn_plain(*_split(N, H, D, kind), H, D ** -0.5, True)
    assert out.dtype == probs.dtype == torch.bfloat16
    assert _bench.bf16_off_share(out, ref_out) <= SHARE_TOL
    # every probability within one bf16 ulp of the TPU body's (+1e-6)
    ulps = (probs.float() - ref_probs).abs() / (_bench.bf16_ulp(ref_probs) + 1e-6)
    assert float(ulps.max()) <= 1.0
    torch.testing.assert_close(probs.float().sum(-1), torch.ones(B, H, N), rtol=0, atol=1e-2)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("N, H, D", SHAPES)
def test_nomax_plain_passes_share_test(N, H, D, g, kind):
    _, tq = _qkv(N, H, D, kind)
    out = bench_attn2.nomax_attn_plain(tq, H, D ** -0.5)
    assert out.dtype == torch.bfloat16
    assert _bench.bf16_off_share(out, _nomax_body(N, H, D, kind, g)) <= SHARE_TOL


def _wrong_form(tool, form, N, H, D, kind):
    """T1's or T2's output in a wrong form: ``unrounded`` (the plain version
    on fp32 inputs, rounded once) or ``cls_rounded`` (the XLA form
    ``attention_qkv_plain``, p_0 rounded to bf16 too)."""
    _, tq = _qkv(N, H, D, kind)
    if form == "cls_rounded":
        return ops.attention_qkv_plain(tq, H, D ** -0.5, False)
    if tool == "headgrid":
        q, k, v = (t.float() for t in _split(N, H, D, kind))
        return bench_attn.headgrid_attn_plain(q, k, v, H, D ** -0.5, False).bfloat16()
    return bench_attn2.nomax_attn_plain(tq.float(), H, D ** -0.5).bfloat16()


@pytest.mark.parametrize("form, kind", [("unrounded", "randn"), ("unrounded", "cls"),
                                        ("cls_rounded", "cls")])
@pytest.mark.parametrize("tool", ["headgrid", "nomax"])
@pytest.mark.parametrize("N, H, D", SHAPES)
def test_wrong_forms_fail_the_share_test(N, H, D, tool, form, kind):
    ref = (_headgrid_body(N, H, D, kind, 1, 1)[0] if tool == "headgrid"
           else _nomax_body(N, H, D, kind, 1))
    share = _bench.bf16_off_share(_wrong_form(tool, form, N, H, D, kind), ref)
    assert share > SHARE_TOL, share


def test_cls_rounded_form_is_near_the_limit_on_randn():
    """Why the cls-rounded form is read on the cls-heavy inputs: on
    random-normal ones it is within 2x of the limit at every shape, and under
    it at N = 258."""
    N, H, D = 258, 2, 16
    share = _bench.bf16_off_share(_wrong_form("headgrid", "cls_rounded", N, H, D, "randn"),
                                  _headgrid_body(N, H, D, "randn", 1, 1)[0])
    assert share <= SHARE_TOL < 2 * share


def test_cls_heavy_inputs_give_the_cls_key_most_weight():
    N, H, D = 129, 12, 64
    _, probs = bench_attn.headgrid_attn_plain(*_split(N, H, D, "cls"), H, D ** -0.5, True)
    assert 0.5 < float(probs[..., 0].float().mean()) < 0.9


def test_rows_stride_takes_rows_of_16_bytes():
    """The layout T1's kernel reads with 16-byte copies, checked without a
    card: separate tensors and the column views of a packed qkv pass; a base
    off 16 bytes, a row stride that is not a multiple of 16 bytes, a
    non-unit element stride and sequences not N rows apart are refused."""
    Bq, N, C = 2, 9, 64
    qkv = torch.zeros(Bq, N, 3 * C, dtype=torch.bfloat16)
    assert qkv.data_ptr() % 16 == 0
    assert [rows_stride("t", t, 16) for t in qkv.split(C, -1)] == [3 * C] * 3
    assert rows_stride("t", qkv[..., C:2 * C].contiguous(), 16) == C
    refused = {
        "base 2 bytes past 16": qkv[..., 1:C + 1],
        "row stride of 72 bytes": torch.zeros(Bq, N, 36, dtype=torch.bfloat16),
        "element stride 2": qkv[..., 0:2 * C:2],
        "sequences N + 1 rows apart": torch.zeros(Bq, N + 1, C, dtype=torch.bfloat16)[:, :N],
        "not 3 dims": qkv[0],
    }
    for why, t in refused.items():
        with pytest.raises(ValueError):
            rows_stride(why, t, 16)


def test_cpu_wrappers_run_the_plain_versions_at_any_layout():
    """On CPU tensors the wrappers run the plain versions, also where the
    kernel would refuse the layout, and count no launch."""
    N, H, D = 129, 2, 16
    C = H * D
    _, tq = _qkv(N, H, D, "randn")
    shifted = torch.empty(1 + tq.numel(), dtype=tq.dtype)[1:].view_as(tq).copy_(tq)
    q, k, v = shifted.split(C, -1)  # bases 2 bytes past 16
    before = bench_attn.headgrid_attn.launches, bench_attn2.nomax_attn.launches
    out, _ = bench_attn.headgrid_attn(q, k, v, H, D ** -0.5, 2, 2)
    assert torch.equal(out, bench_attn.headgrid_attn_plain(*tq.split(C, -1), H, D ** -0.5,
                                                           False))
    assert torch.equal(bench_attn2.nomax_attn(shifted, H, D ** -0.5, 2),
                       bench_attn2.nomax_attn_plain(tq, H, D ** -0.5))
    assert (bench_attn.headgrid_attn.launches, bench_attn2.nomax_attn.launches) == before


_C_TYPES = {"void*": _build._P, "int": _build._I, "float": _build._F}


def _c_entries() -> dict:
    """{name: [argtypes]} of every ``extern "C" int`` entry in csrc/*.cu."""
    entries = {}
    for src in sorted(_build.CSRC.glob("*.cu")):
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src.read_text()):
            types = []
            for p in params.split(","):
                p = " ".join(p.split()[:-1]).replace("const ", "").replace(" *", "*")
                types.append(_build.ctypes.POINTER(_build._I) if p == "int*" else _C_TYPES[p])
            entries[name] = types
    return entries


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_signatures_match_the_c_entries(name):
    """ctypes passes each argument as the C entry declares it (a mismatch,
    e.g. a pointer passed as an int, shows only on the card)."""
    entries = _c_entries()
    assert set(entries) == set(_build.SIGNATURES)
    assert entries[name] == _build.SIGNATURES[name]
