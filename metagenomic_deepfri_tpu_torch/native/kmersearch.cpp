// Built-in homology-search prefilter: shared k-mer counting over an inverted
// index, OpenMP-parallel over queries.
//
// Role: stands in for the external MMseqs2 binary's prefilter stage
// (reference invokes mmseqs via subprocess, mDeepFRI/mmseqs.py:138-187) when
// no mmseqs binary is available. Candidates surviving the k-mer filter are
// rescored with the NW engine (nw.cpp) by the Python driver
// (search/engine.py), which also computes the convertalis-style statistics.
//
// Sequences arrive encoded as indices in [0, n_alpha); tokens >= n_alpha
// (unknown residues) never match. k-mers are ranked by perfect hashing over
// base-n_alpha digits.
//
// Build: python -m metagenomic_deepfri_tpu.native.build

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

inline int64_t pow_int(int64_t base, int32_t exp) {
    int64_t r = 1;
    for (int32_t i = 0; i < exp; ++i) r *= base;
    return r;
}

}  // namespace

extern "C" {

// For each query, report up to max_candidates target ids with the highest
// shared-k-mer counts (>= min_hits). out_cand is (n_queries, max_candidates)
// int32, -1-padded; out_counts parallel array of counts.
void kmer_candidates(const int32_t* tseqs, const int64_t* toffsets,
                     int32_t n_targets,
                     const int32_t* qseqs, const int64_t* qoffsets,
                     int32_t n_queries,
                     int32_t k, int32_t n_alpha,
                     int32_t max_candidates, int32_t min_hits,
                     int32_t threads,
                     int32_t* out_cand, int32_t* out_counts) {
    const int64_t n_buckets = pow_int(n_alpha, k);

    // ---- pass 1: bucket sizes over targets (CSR construction) ----
    std::vector<int64_t> bucket_off(n_buckets + 1, 0);
    auto for_each_kmer = [&](const int32_t* seq, int64_t len, auto&& fn) {
        if (len < k) return;
        int64_t hash = 0;
        int32_t valid = 0;  // length of current run of in-alphabet tokens
        const int64_t top = pow_int(n_alpha, k - 1);
        for (int64_t p = 0; p < len; ++p) {
            int32_t c = seq[p];
            if (c < 0 || c >= n_alpha) {
                valid = 0;
                hash = 0;
                continue;
            }
            hash = (valid >= k) ? (hash - seq[p - k] * top) * n_alpha + c
                                : hash * n_alpha + c;
            if (valid >= k - 1) fn(hash);
            ++valid;
        }
    };

    for (int32_t t = 0; t < n_targets; ++t) {
        const int32_t* seq = tseqs + toffsets[t];
        int64_t len = toffsets[t + 1] - toffsets[t];
        for_each_kmer(seq, len, [&](int64_t h) { ++bucket_off[h + 1]; });
    }
    for (int64_t b = 0; b < n_buckets; ++b) bucket_off[b + 1] += bucket_off[b];
    const int64_t total = bucket_off[n_buckets];

    // ---- pass 2: fill postings (target ids per k-mer) ----
    std::vector<int32_t> postings(total);
    std::vector<int64_t> cursor(bucket_off.begin(), bucket_off.end() - 1);
    for (int32_t t = 0; t < n_targets; ++t) {
        const int32_t* seq = tseqs + toffsets[t];
        int64_t len = toffsets[t + 1] - toffsets[t];
        for_each_kmer(seq, len, [&](int64_t h) {
            postings[cursor[h]++] = t;
        });
    }

    // ---- query scan ----
#ifdef _OPENMP
    omp_set_num_threads(threads > 0 ? threads : 1);
#pragma omp parallel
#endif
    {
        std::vector<int32_t> count(n_targets, 0);
        std::vector<int32_t> touched;
        touched.reserve(4096);
#ifdef _OPENMP
#pragma omp for schedule(dynamic)
#endif
        for (int32_t qi = 0; qi < n_queries; ++qi) {
            const int32_t* seq = qseqs + qoffsets[qi];
            int64_t len = qoffsets[qi + 1] - qoffsets[qi];
            for_each_kmer(seq, len, [&](int64_t h) {
                for (int64_t p = bucket_off[h]; p < bucket_off[h + 1]; ++p) {
                    int32_t t = postings[p];
                    if (count[t] == 0) touched.push_back(t);
                    ++count[t];
                }
            });
            // rank touched targets by count
            std::vector<std::pair<int32_t, int32_t>> ranked;
            ranked.reserve(touched.size());
            for (int32_t t : touched) {
                if (count[t] >= min_hits) ranked.emplace_back(count[t], t);
            }
            int32_t keep = std::min<int64_t>(max_candidates,
                                             (int64_t)ranked.size());
            std::partial_sort(
                ranked.begin(), ranked.begin() + keep, ranked.end(),
                [](auto& a, auto& b) {
                    return a.first != b.first ? a.first > b.first
                                              : a.second < b.second;
                });
            int32_t* cand_row = out_cand + (int64_t)qi * max_candidates;
            int32_t* count_row = out_counts + (int64_t)qi * max_candidates;
            for (int32_t i = 0; i < max_candidates; ++i) {
                if (i < keep) {
                    cand_row[i] = ranked[i].second;
                    count_row[i] = ranked[i].first;
                } else {
                    cand_row[i] = -1;
                    count_row[i] = 0;
                }
            }
            for (int32_t t : touched) count[t] = 0;
            touched.clear();
        }
    }
}

}  // extern "C"
