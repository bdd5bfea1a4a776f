// Native k-reciprocal re-ranking (Zhong et al., CVPR 2017): the PyTorch
// port's copy of editor_tpu/native/reranking.cpp, unchanged below this
// header.
//
// The re-ranking pass is the CPU-bound hot loop of the eval protocol
// (reference: utils/reranking.py:29-100, invoked from utils/metrics.py:278
// with k1=50, k2=15, lambda=0.3): C++17 + OpenMP, sparse neighbor sets, no
// Python in the loop. Exposed through ctypes (editor_tpu_torch/native/
// __init__.py), built with g++ at first use.
//
// Input: original_dist [n*n] row-major, already column-rescaled and
// transposed like the reference (dist / max(dist, axis=0)).T — the Python
// wrapper prepares it (cheap, vectorized). Output: final [nq * (n-nq)]
// query-gallery distances.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// indices of the k+1 smallest entries of row (ascending by value)
static void topk_ascending(const float* row, int n, int k,
                           std::vector<int32_t>& out) {
  out.resize(n);
  std::iota(out.begin(), out.end(), 0);
  const int kk = std::min(k, n);
  std::partial_sort(out.begin(), out.begin() + kk, out.end(),
                    [row](int32_t a, int32_t b) { return row[a] < row[b]; });
  out.resize(kk);
}

struct SparseRow {
  std::vector<int32_t> idx;
  std::vector<float> val;
};

}  // namespace

extern "C" {

void editor_tpu_k_reciprocal_rerank(const float* original_dist, int32_t n,
                                    int32_t nq, int32_t k1, int32_t k2,
                                    float lambda, float* out) {
  const int half = static_cast<int>(std::lround(k1 / 2.0));

  // forward top-(k1+1) neighbor lists for every row
  std::vector<std::vector<int32_t>> rank_k1(n), rank_half(n), rank_k2(n);
#pragma omp parallel
  {
    std::vector<int32_t> scratch;
#pragma omp for schedule(dynamic, 64)
    for (int i = 0; i < n; ++i) {
      topk_ascending(original_dist + static_cast<size_t>(i) * n, n,
                     std::max({k1 + 1, half + 1, k2}), scratch);
      rank_k1[i].assign(scratch.begin(),
                        scratch.begin() + std::min<int>(k1 + 1, scratch.size()));
      rank_half[i].assign(
          scratch.begin(),
          scratch.begin() + std::min<int>(half + 1, scratch.size()));
      rank_k2[i].assign(scratch.begin(),
                        scratch.begin() + std::min<int>(k2, scratch.size()));
    }
  }

  auto reciprocal = [&](int i, const std::vector<std::vector<int32_t>>& fwd)
      -> std::vector<int32_t> {
    std::vector<int32_t> rset;
    for (int32_t j : fwd[i]) {
      const auto& back = fwd[j];
      if (std::find(back.begin(), back.end(), i) != back.end())
        rset.push_back(j);
    }
    return rset;
  };

  // V: sparse Gaussian-weighted membership rows
  std::vector<SparseRow> V(n);
#pragma omp parallel for schedule(dynamic, 32)
  for (int i = 0; i < n; ++i) {
    std::vector<int32_t> rset = reciprocal(i, rank_k1);
    std::vector<int32_t> expansion = rset;
    for (int32_t cand : rset) {
      std::vector<int32_t> rhalf = reciprocal(cand, rank_half);
      // count overlap with rset
      int overlap = 0;
      for (int32_t q : rhalf)
        if (std::find(rset.begin(), rset.end(), q) != rset.end()) ++overlap;
      if (overlap > (2.0 / 3.0) * rhalf.size())
        expansion.insert(expansion.end(), rhalf.begin(), rhalf.end());
    }
    std::sort(expansion.begin(), expansion.end());
    expansion.erase(std::unique(expansion.begin(), expansion.end()),
                    expansion.end());
    const float* row = original_dist + static_cast<size_t>(i) * n;
    float sum = 0.0f;
    std::vector<float> w(expansion.size());
    for (size_t t = 0; t < expansion.size(); ++t) {
      w[t] = std::exp(-row[expansion[t]]);
      sum += w[t];
    }
    for (float& x : w) x /= sum;
    V[i].idx = std::move(expansion);
    V[i].val = std::move(w);
  }

  // local query expansion: V_qe[i] = mean of V over top-k2 neighbors
  if (k2 != 1) {
    std::vector<SparseRow> Vq(n);
#pragma omp parallel
    {
      std::vector<float> dense(n);
#pragma omp for schedule(dynamic, 32)
      for (int i = 0; i < n; ++i) {
        std::fill(dense.begin(), dense.end(), 0.0f);
        const float inv = 1.0f / rank_k2[i].size();
        for (int32_t j : rank_k2[i])
          for (size_t t = 0; t < V[j].idx.size(); ++t)
            dense[V[j].idx[t]] += V[j].val[t] * inv;
        for (int c = 0; c < n; ++c)
          if (dense[c] != 0.0f) {
            Vq[i].idx.push_back(c);
            Vq[i].val.push_back(dense[c]);
          }
      }
    }
    V.swap(Vq);
  }

  // inverted index: rows with nonzero value per column
  std::vector<std::vector<int32_t>> inv_idx(n);
  std::vector<std::vector<float>> inv_val(n);
  for (int i = 0; i < n; ++i)
    for (size_t t = 0; t < V[i].idx.size(); ++t) {
      inv_idx[V[i].idx[t]].push_back(i);
      inv_val[V[i].idx[t]].push_back(V[i].val[t]);
    }

  const int ng = n - nq;
#pragma omp parallel
  {
    std::vector<float> overlap(n);
#pragma omp for schedule(dynamic, 16)
    for (int i = 0; i < nq; ++i) {
      std::fill(overlap.begin(), overlap.end(), 0.0f);
      for (size_t t = 0; t < V[i].idx.size(); ++t) {
        const int32_t col = V[i].idx[t];
        const float vi = V[i].val[t];
        const auto& rows = inv_idx[col];
        const auto& vals = inv_val[col];
        for (size_t r = 0; r < rows.size(); ++r)
          overlap[rows[r]] += std::min(vi, vals[r]);
      }
      const float* orig = original_dist + static_cast<size_t>(i) * n;
      float* dst = out + static_cast<size_t>(i) * ng;
      for (int g = 0; g < ng; ++g) {
        const int j = nq + g;
        const float jac = 1.0f - overlap[j] / (2.0f - overlap[j]);
        dst[g] = jac * (1.0f - lambda) + orig[j] * lambda;
      }
    }
  }
}

}  // extern "C"
