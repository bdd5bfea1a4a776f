"""The port's retrieval metrics and re-ranking against the JAX package's,
on the same numpy inputs (JAX x64 on).

CMC is compared exactly: both count 0/1 hits in fp32 and divide by the
number of valid queries. mAP within 1e-6: both average fp32 precisions, the
sums in another order. A distance matrix with ties (duplicate gallery
entries) gives JAX's numbers only through a stable sort; the same matrix
ranked with ties in reverse index order (what an unstable sort may do) gives
other numbers. The MSVR310 rank-list file is compared byte for byte.
Re-ranking: the port's numpy ``k_reciprocal_rerank`` against JAX's numpy one
to 1e-10, and the evaluator with ``reranking=True`` against JAX's with both
packages' ``rerank_auto`` pinned to their numpy implementations (either may
take its native C++ one; native against numpy is held in
``tests/test_torch_native.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import editor_tpu.native
import editor_tpu_torch.native
from editor_tpu.evals import metrics as jax_metrics
from editor_tpu.evals.reranking import k_reciprocal_rerank as jax_rerank
from editor_tpu_torch.evals import metrics
from editor_tpu_torch.evals.reranking import k_reciprocal_rerank
from tests.torch_parity import x64  # noqa: F401


def _ids(rng, Q, G, n_pids=5, n_cams=3):
    return (rng.randint(0, n_pids, Q), rng.randint(0, n_pids, G),
            rng.randint(0, n_cams, Q), rng.randint(0, n_cams, G))


def _same(got, ref):
    np.testing.assert_array_equal(got[0], np.asarray(ref[0]))
    assert abs(got[1] - float(ref[1])) <= 1e-6, (got[1], ref[1])


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("max_rank", [5, 50])
def test_cmc_map_matches_jax(x64, seed, max_rank):
    rng = np.random.RandomState(seed)
    Q, G = 9, 30
    dist = rng.rand(Q, G).astype(np.float32)
    ids = _ids(rng, Q, G)
    _same(metrics.cmc_map(dist, *ids, max_rank=max_rank),
          jax_metrics.cmc_map(dist, *ids, max_rank=max_rank))
    _same(metrics.cmc_map(torch.from_numpy(dist), *[torch.from_numpy(i) for i in ids],
                          max_rank=max_rank),
          jax_metrics.cmc_map(dist, *ids, max_rank=max_rank))
    scenes = (rng.randint(0, 3, Q), rng.randint(0, 3, G))
    _same(metrics.cmc_map_msvr(dist, *ids, *scenes, max_rank=max_rank),
          jax_metrics.cmc_map_msvr(dist, *ids, *scenes, max_rank=max_rank))


def _tied_case():
    """Each query's true match ties in distance with a wrong gallery entry
    placed before it, and a duplicate entry ties at the next distance."""
    q_pids, g_pids = np.array([0, 1, 2]), np.array([9, 0, 8, 1, 7, 2, 2])
    q_cams, g_cams = np.zeros(3, np.int64), np.ones(7, np.int64)
    dist = np.array([[1, 1, 2, 3, 3, 4, 4],
                     [5, 2, 5, 2, 1, 4, 4],
                     [3, 3, 2, 3, 1, 1, 1]], np.float32)
    return dist, q_pids, g_pids, q_cams, g_cams


def _reversed_ties(distmat):
    """An ordering that breaks ties by descending index."""
    G = distmat.shape[1]
    rev = torch.argsort(distmat.flip(1), dim=1, stable=True)
    return G - 1 - rev


def test_tied_distances_need_a_stable_sort(x64, monkeypatch):
    case = _tied_case()
    ref = jax_metrics.cmc_map(*case)
    _same(metrics.cmc_map(*case), ref)
    monkeypatch.setattr(metrics, "rank_order", _reversed_ties)
    cmc, mAP = metrics.cmc_map(*case)
    assert not np.array_equal(cmc, np.asarray(ref[0])) and abs(mAP - ref[1]) > 1e-3


@pytest.mark.parametrize("feat_norm", [True, False])
@pytest.mark.parametrize("msvr", [False, True])
@pytest.mark.parametrize("ids", ["numpy", "tensor"])
def test_evaluator_matches_jax(x64, feat_norm, msvr, ids, tmp_path):
    """``ids`` "tensor": the port's evaluator gets the ids as tensors, as
    ``loop.evaluate`` hands them over (on the device), and keeps them as
    given until ``compute``."""
    rng = np.random.RandomState(4)
    nq, ng, dim = 6, 14, 16
    feats = rng.randn(nq + ng, dim).astype(np.float32)
    feats[nq + 3] = feats[nq + 2]  # a duplicate gallery entry: tied distances
    pids = np.concatenate([np.arange(nq) % 4, np.arange(ng) % 5]).astype(np.int32)
    cams = rng.randint(0, 2, nq + ng).astype(np.int32)
    scenes = rng.randint(0, 3, nq + ng).astype(np.int32)
    paths = {}
    results = []
    for name, cls in (("jax", jax_metrics.R1mAPEvaluator), ("port", metrics.R1mAPEvaluator)):
        paths[name] = str(tmp_path / f"{name}_re.txt")
        ev = cls(nq, max_rank=10, feat_norm=feat_norm, msvr_protocol=msvr,
                 rank_list_path=paths[name] if msvr else None)
        wrap = torch.from_numpy if name == "port" and ids == "tensor" else (lambda a: a)
        for lo in range(0, nq + ng, 7):  # batches of 7, as the loop hands them
            sl = slice(lo, lo + 7)
            ev.update(feats[sl] if name == "jax" else torch.from_numpy(feats[sl]),
                      wrap(pids[sl]), wrap(cams[sl]), wrap(scenes[sl]) if msvr else None)
        results.append(ev.compute())
    ref, got = results
    _same(got, ref)
    np.testing.assert_allclose(got[2], np.asarray(ref[2]), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[3], ref[3])
    np.testing.assert_allclose(got[5].numpy(), np.asarray(ref[5]), rtol=1e-6)
    if msvr:
        with open(paths["jax"], "rb") as a, open(paths["port"], "rb") as b:
            ref_txt, got_txt = a.read(), b.read()
        assert got_txt == ref_txt and got_txt.count(b"\n") == 1 + 2 * nq


def test_rank_list_file_matches_jax(tmp_path):
    """The same distance matrix (with ties) into both writers: the same bytes."""
    rng = np.random.RandomState(5)
    dist = rng.randint(0, 6, (5, 12)).astype(np.float32)
    q_pids, g_pids, q_cams, g_cams = _ids(rng, 5, 12)
    q_sc, g_sc = rng.randint(0, 2, 5), rng.randint(0, 2, 12)
    args = (dist, q_pids, g_pids, q_cams, g_cams, q_sc, g_sc, 4)
    jax_metrics.write_rank_list(str(tmp_path / "a.txt"), *args)
    metrics.write_rank_list(str(tmp_path / "b.txt"), torch.from_numpy(dist), *args[1:])
    assert (tmp_path / "a.txt").read_bytes() == (tmp_path / "b.txt").read_bytes()


@pytest.mark.parametrize("k1,k2", [(20, 6), (50, 15), (4, 1)])
def test_rerank_matches_jax_numpy(k1, k2):
    rng = np.random.RandomState(k1)
    qf, gf = rng.randn(7, 12).astype(np.float32), rng.randn(23, 12).astype(np.float32)
    got = k_reciprocal_rerank(qf, gf, k1=k1, k2=k2, lambda_value=0.3)
    ref = jax_rerank(qf, gf, k1=k1, k2=k2, lambda_value=0.3)
    assert got.shape == (7, 23)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-10)


def test_evaluator_reranking_matches_jax(x64, monkeypatch):
    monkeypatch.setattr(editor_tpu.native, "rerank_auto", jax_rerank)
    monkeypatch.setattr(editor_tpu_torch.native, "rerank_auto", k_reciprocal_rerank)
    rng = np.random.RandomState(6)
    nq, ng = 8, 40
    feats = rng.randn(nq + ng, 24).astype(np.float32)
    pids = np.concatenate([np.arange(nq), np.arange(ng) % 10]).astype(np.int32)
    cams = np.concatenate([np.zeros(nq), np.ones(ng)]).astype(np.int32)
    out = []
    for cls, f in ((jax_metrics.R1mAPEvaluator, feats), (metrics.R1mAPEvaluator,
                                                         torch.from_numpy(feats))):
        ev = cls(nq, reranking=True)
        ev.update(f, pids, cams)
        out.append(ev.compute())
    ref, got = out
    _same(got, ref)
    np.testing.assert_allclose(got[2], np.asarray(ref[2]), rtol=0, atol=1e-6)


def test_euclidean_distmat_matches_jax():
    rng = np.random.RandomState(7)
    qf, gf = rng.randn(5, 33), rng.randn(9, 33)
    got = metrics.euclidean_distmat(torch.from_numpy(qf), torch.from_numpy(gf))
    assert got.dtype == torch.float32  # the fp32 expansion, as JAX
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jax_metrics.euclidean_distmat(jnp.asarray(qf),
                                                                        jnp.asarray(gf))),
                               rtol=1e-5, atol=1e-5)


def test_all_invalid_queries_raise():
    dist = np.zeros((2, 3), np.float32)
    with pytest.raises(RuntimeError, match="absent from gallery"):
        metrics.cmc_map(dist, np.array([0, 1]), np.array([5, 6, 7]), np.zeros(2), np.ones(3))
