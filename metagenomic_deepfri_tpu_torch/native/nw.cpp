// Needleman–Wunsch global alignment (Gotoh affine gaps), native engine.
//
// Replaces the reference's pyOpal/Opal SIMD aligner (reference
// mDeepFRI/alignment.py:163-220) for both of its uses:
//   * score-only one-vs-many ranking ("score" mode, best-hit selection)
//   * full alignment with traceback ("full"/"nw" mode) producing an
//     M/I/D alignment string ('I' = gap in query, 'D' = gap in target,
//     consumed by insert_gaps — reference alignment.py:38-62).
//
// Scoring convention: a gap of length k costs gap_open + (k-1)*gap_extend.
// Sequences arrive pre-encoded as alphabet indices; the substitution matrix
// is a dense n_alpha x n_alpha int32 table.
//
// Build: python -m metagenomic_deepfri_tpu.native.build

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>
#include <limits>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr int32_t NEG_INF = std::numeric_limits<int32_t>::min() / 4;

// Traceback flags packed per cell.
constexpr uint8_t H_SRC_MASK = 0x3;  // 0 = diag, 1 = E (query gap), 2 = F
constexpr uint8_t E_EXTEND = 0x4;
constexpr uint8_t F_EXTEND = 0x8;

}  // namespace

extern "C" {

// Full global alignment with traceback.
// out_aln must have room for qlen + tlen chars; returns the score.
int32_t nw_align(const int32_t* q, int32_t qlen,
                 const int32_t* t, int32_t tlen,
                 const int32_t* matrix, int32_t n_alpha,
                 int32_t gap_open, int32_t gap_extend,
                 char* out_aln, int32_t* out_aln_len) {
    const int64_t cols = tlen + 1;
    std::vector<int32_t> H(cols), E(cols);
    std::vector<uint8_t> tb(static_cast<int64_t>(qlen + 1) * cols, 0);

    H[0] = 0;
    E[0] = NEG_INF;
    for (int64_t j = 1; j <= tlen; ++j) {
        E[j] = -gap_open - static_cast<int32_t>(j - 1) * gap_extend;
        H[j] = E[j];
        tb[j] = 1 | (j > 1 ? E_EXTEND : 0);
    }

    std::vector<int32_t> F(cols, NEG_INF);
    for (int32_t i = 1; i <= qlen; ++i) {
        int32_t h_diag = H[0];  // H[i-1][0]
        int32_t f_up = (i == 1) ? 0 : H[0];  // placeholder, fixed below
        // column 0 boundary: gap in target of length i
        int32_t h0 = -gap_open - (i - 1) * gap_extend;
        int32_t f0 = h0;
        H[0] = h0;
        tb[static_cast<int64_t>(i) * cols] = 2 | (i > 1 ? F_EXTEND : 0);
        int32_t e_cur = NEG_INF;
        const int32_t* mrow = matrix + static_cast<int64_t>(q[i - 1]) * n_alpha;
        for (int64_t j = 1; j <= tlen; ++j) {
            // E: gap in query (consume target)
            int32_t e_open = H[j - 1] - gap_open;   // H[i][j-1] (current row)
            int32_t e_ext = e_cur - gap_extend;
            bool e_from_ext = e_ext > e_open;
            e_cur = e_from_ext ? e_ext : e_open;

            // F: gap in target (consume query); F[j] currently holds row i-1
            int32_t f_open = H[j] - gap_open;       // H[i-1][j] (old value)
            int32_t f_ext = F[j] - gap_extend;
            bool f_from_ext = f_ext > f_open;
            int32_t f_cur = f_from_ext ? f_ext : f_open;
            F[j] = f_cur;

            int32_t diag = h_diag + mrow[t[j - 1]];
            h_diag = H[j];

            uint8_t flags = 0;
            int32_t best = diag;
            if (e_cur > best) { best = e_cur; flags = 1; }
            if (f_cur > best) { best = f_cur; flags = 2; }
            if (e_from_ext) flags |= E_EXTEND;
            if (f_from_ext) flags |= F_EXTEND;
            H[j] = best;
            tb[static_cast<int64_t>(i) * cols + j] = flags;
        }
        (void)f_up;
    }

    // traceback
    int32_t score = H[tlen];
    int64_t i = qlen, j = tlen;
    char* w = out_aln;
    int state = 0;  // 0 = H, 1 = E, 2 = F
    while (i > 0 || j > 0) {
        uint8_t flags = tb[i * cols + j];
        if (state == 0) {
            if (i == 0) state = 1;
            else if (j == 0) state = 2;
            else state = flags & H_SRC_MASK;
            if (state == 0) {
                *w++ = 'M';
                --i; --j;
                continue;
            }
        }
        if (state == 1) {
            *w++ = 'I';  // gap in query, target consumed
            if (!(flags & E_EXTEND)) state = 0;
            --j;
        } else {
            *w++ = 'D';  // gap in target, query consumed
            if (!(flags & F_EXTEND)) state = 0;
            --i;
        }
    }
    *out_aln_len = static_cast<int32_t>(w - out_aln);
    std::reverse(out_aln, w);
    return score;
}

// Score-only global alignment, O(tlen) memory.
static int32_t nw_score_one(const int32_t* q, int32_t qlen,
                            const int32_t* t, int32_t tlen,
                            const int32_t* matrix, int32_t n_alpha,
                            int32_t gap_open, int32_t gap_extend) {
    std::vector<int32_t> H(tlen + 1), E(tlen + 1), F(tlen + 1, NEG_INF);
    H[0] = 0;
    E[0] = NEG_INF;
    for (int32_t j = 1; j <= tlen; ++j) {
        E[j] = -gap_open - (j - 1) * gap_extend;
        H[j] = E[j];
    }
    for (int32_t i = 1; i <= qlen; ++i) {
        int32_t h_diag = H[0];
        H[0] = -gap_open - (i - 1) * gap_extend;
        int32_t e_cur = NEG_INF;
        const int32_t* mrow = matrix + static_cast<int64_t>(q[i - 1]) * n_alpha;
        for (int32_t j = 1; j <= tlen; ++j) {
            e_cur = std::max(H[j - 1] - gap_open, e_cur - gap_extend);
            F[j] = std::max(H[j] - gap_open, F[j] - gap_extend);
            int32_t diag = h_diag + mrow[t[j - 1]];
            h_diag = H[j];
            H[j] = std::max(diag, std::max(e_cur, F[j]));
        }
    }
    return H[tlen];
}

// One query vs many targets (concatenated + offsets), OpenMP-parallel.
void nw_score_batch(const int32_t* q, int32_t qlen,
                    const int32_t* targets, const int64_t* offsets,
                    int32_t n_targets,
                    const int32_t* matrix, int32_t n_alpha,
                    int32_t gap_open, int32_t gap_extend,
                    int32_t threads, int32_t* out_scores) {
#ifdef _OPENMP
    omp_set_num_threads(threads > 0 ? threads : 1);
#pragma omp parallel for schedule(dynamic)
#endif
    for (int32_t k = 0; k < n_targets; ++k) {
        const int32_t* t = targets + offsets[k];
        int32_t tlen = static_cast<int32_t>(offsets[k + 1] - offsets[k]);
        out_scores[k] = nw_score_one(q, qlen, t, tlen, matrix, n_alpha,
                                     gap_open, gap_extend);
    }
}

}  // extern "C"
