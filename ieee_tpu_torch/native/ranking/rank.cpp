// Native CMC/mAP evaluation (market1501 protocol).
//
// The port's copy of ieee_tpu/native/ranking/rank.cpp. Role: the reference
// ships a Cython/C extension for ranking
// (torchreid/metrics/rank_cylib/rank_cy.pyx, ">10x" over numpy per
// metrics/rank.py:274-276). This is the same component as portable C++,
// exposed through ctypes. The device path (ops/ranking.py) is the default;
// this library is the independent host-side oracle, taken with
// evaluate_rank(use_cython=True).
//
// Protocol (must match ops/ranking.py bit-for-bit):
//  - per query, sort gallery by distance (stable);
//  - drop gallery entries sharing the query's (pid, camid);
//  - CMC over the compressed kept ranking; queries with no positives are
//    skipped; AP = mean precision at each positive.

#include <algorithm>
#include <cstdint>
#include <numeric>
#include <vector>

extern "C" {

// distmat: num_q * num_g row-major float32
// out_cmc: max_rank floats; out_map: 1 float
// returns number of valid queries (<=0 signals error)
int eval_market1501(const float* distmat, const int64_t* q_pids,
                    const int64_t* g_pids, const int64_t* q_camids,
                    const int64_t* g_camids, int num_q, int num_g,
                    int max_rank, float* out_cmc, float* out_map) {
  if (num_g < max_rank) max_rank = num_g;
  std::vector<double> cmc_acc(max_rank, 0.0);
  double ap_acc = 0.0;
  int num_valid_q = 0;

  std::vector<int> order(num_g);
  for (int q = 0; q < num_q; ++q) {
    const float* row = distmat + static_cast<int64_t>(q) * num_g;
    std::iota(order.begin(), order.end(), 0);
    std::stable_sort(order.begin(), order.end(),
                     [row](int a, int b) { return row[a] < row[b]; });

    const int64_t qp = q_pids[q], qc = q_camids[q];
    int kept = 0, num_rel = 0;
    int first_match = -1;
    double ap = 0.0;
    for (int k = 0; k < num_g; ++k) {
      const int g = order[k];
      if (g_pids[g] == qp && g_camids[g] == qc) continue;  // junk: same cam
      const bool match = g_pids[g] == qp;
      if (match) {
        ++num_rel;
        ap += static_cast<double>(num_rel) / (kept + 1);
        if (first_match < 0) first_match = kept;
      }
      ++kept;
    }
    if (num_rel == 0) continue;  // query id absent from gallery
    ++num_valid_q;
    ap_acc += ap / num_rel;
    if (first_match < max_rank) {
      for (int r = first_match; r < max_rank; ++r) cmc_acc[r] += 1.0;
    }
  }

  if (num_valid_q == 0) return 0;
  for (int r = 0; r < max_rank; ++r)
    out_cmc[r] = static_cast<float>(cmc_acc[r] / num_valid_q);
  *out_map = static_cast<float>(ap_acc / num_valid_q);
  return num_valid_q;
}

}  // extern "C"
