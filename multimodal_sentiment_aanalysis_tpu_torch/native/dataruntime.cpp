// Native data runtime: host-side hot loops of the data layer.
//
// The reference runs these in per-sample / per-pair Python (feature
// normalization in data/LoadFeatures.py:79-114, the O(n^2) contrastive pair
// loop in dataLoader/DataLoader.py:76-140). Here they are C++ with double
// accumulation, bound through ctypes by native/__init__.py beside this file,
// which builds it with g++ on first use; the numpy versions there (*_plain)
// compute the same results.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Replace NaN/Inf like np.nan_to_num: NaN -> 0, +Inf -> FLT_MAX, -Inf -> -FLT_MAX.
void msa_nan_to_num(float* x, int64_t n) {
    const float big = 3.4028234663852886e+38f;
    for (int64_t i = 0; i < n; ++i) {
        float v = x[i];
        if (std::isnan(v)) {
            x[i] = 0.0f;
        } else if (std::isinf(v)) {
            x[i] = v > 0 ? big : -big;
        }
    }
}

// Dataset-level per-feature (column) z-score with std==0 -> 1 guard
// (reference data/LoadFeatures.py:107-114). x is row-major (n, d).
// Population std; accumulation in double for numpy-parity.
void msa_zscore_columns(float* x, int64_t n, int64_t d) {
    if (n == 0 || d == 0) return;
    std::vector<double> mean(d, 0.0), m2(d, 0.0);
    for (int64_t i = 0; i < n; ++i) {
        const float* row = x + i * d;
        for (int64_t j = 0; j < d; ++j) mean[j] += row[j];
    }
    for (int64_t j = 0; j < d; ++j) mean[j] /= (double)n;
    for (int64_t i = 0; i < n; ++i) {
        const float* row = x + i * d;
        for (int64_t j = 0; j < d; ++j) {
            double c = row[j] - mean[j];
            m2[j] += c * c;
        }
    }
    std::vector<double> inv(d);
    for (int64_t j = 0; j < d; ++j) {
        double std_ = std::sqrt(m2[j] / (double)n);
        inv[j] = std_ == 0.0 ? 1.0 : 1.0 / std_;
    }
    for (int64_t i = 0; i < n; ++i) {
        float* row = x + i * d;
        for (int64_t j = 0; j < d; ++j) {
            row[j] = (float)((row[j] - mean[j]) * inv[j]);
        }
    }
}

// Global z-score then global min-max over the whole array
// (reference data/LoadFeatures.py:130-142 `_normalize`).
void msa_global_norm(float* x, int64_t n) {
    if (n == 0) return;
    double mean = 0.0;
    for (int64_t i = 0; i < n; ++i) mean += x[i];
    mean /= (double)n;
    double m2 = 0.0;
    for (int64_t i = 0; i < n; ++i) {
        double c = x[i] - mean;
        m2 += c * c;
    }
    double std_ = std::sqrt(m2 / (double)n);
    if (std_ == 0.0) std_ = 1.0;
    double lo = 1e300, hi = -1e300;
    for (int64_t i = 0; i < n; ++i) {
        double z = (x[i] - mean) / std_;
        if (z < lo) lo = z;
        if (z > hi) hi = z;
        x[i] = (float)z;
    }
    double range = hi - lo;
    if (range == 0.0) range = 1.0;
    for (int64_t i = 0; i < n; ++i) {
        x[i] = (float)((x[i] - lo) / range);
    }
}

// ---------------------------------------------------------------------------
// balanced contrastive pair builder (reference dataLoader/DataLoader.py:76-140)
// ---------------------------------------------------------------------------

struct SplitMix64 {
    uint64_t s;
    explicit SplitMix64(uint64_t seed) : s(seed) {}
    uint64_t next() {
        uint64_t z = (s += 0x9e3779b97f4a7c15ULL);
        z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
        z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
        return z ^ (z >> 31);
    }
    // uniform integer in [0, bound)
    uint64_t below(uint64_t bound) { return next() % bound; }
};

// Fisher-Yates partial shuffle: pick k distinct elements from v.
static void sample_k(std::vector<int64_t>& v, int64_t k, SplitMix64& rng) {
    int64_t n = (int64_t)v.size();
    for (int64_t i = 0; i < k; ++i) {
        int64_t j = i + (int64_t)rng.below((uint64_t)(n - i));
        std::swap(v[i], v[j]);
    }
    v.resize(k);
}

// Builds balanced positive/negative within-subject pairs.
// Returns number of pairs written (<= cap). out_pairs has 2*cap int32 slots.
// Positive iff arousal AND valence agree; classes balanced by down-sampling;
// per-subject shuffle; subjects lacking either class are skipped.
int64_t msa_build_pairs(
    const int64_t* arousal, const int64_t* valence, const int64_t* subject,
    int64_t n, uint64_t seed, int32_t* out_pairs, float* out_labels,
    int64_t cap) {
    SplitMix64 rng(seed);
    int64_t written = 0;

    // gather per-subject index lists, in order of first appearance of the
    // sorted unique subject ids
    std::vector<int64_t> uniq;
    for (int64_t i = 0; i < n; ++i) {
        bool seen = false;
        for (int64_t u : uniq) {
            if (u == subject[i]) { seen = true; break; }
        }
        if (!seen) uniq.push_back(subject[i]);
    }
    // sort ascending (matches np.unique ordering)
    for (size_t a = 0; a + 1 < uniq.size(); ++a)
        for (size_t b = a + 1; b < uniq.size(); ++b)
            if (uniq[b] < uniq[a]) std::swap(uniq[a], uniq[b]);

    for (int64_t subj : uniq) {
        std::vector<int64_t> idx;
        for (int64_t i = 0; i < n; ++i)
            if (subject[i] == subj) idx.push_back(i);
        int64_t m = (int64_t)idx.size();
        if (m < 2) continue;

        std::vector<int64_t> pos, neg;  // encoded pair ids p*m + q (p<q)
        for (int64_t p = 0; p < m; ++p) {
            for (int64_t q = p + 1; q < m; ++q) {
                int64_t i = idx[p], j = idx[q];
                bool same = arousal[i] == arousal[j] && valence[i] == valence[j];
                (same ? pos : neg).push_back(p * m + q);
            }
        }
        if (pos.empty() || neg.empty()) continue;
        int64_t keep = (int64_t)(pos.size() < neg.size() ? pos.size() : neg.size());
        sample_k(pos, keep, rng);
        sample_k(neg, keep, rng);

        std::vector<int64_t> enc;
        std::vector<float> lab;
        enc.reserve(2 * keep);
        for (int64_t e : pos) { enc.push_back(e); lab.push_back(1.0f); }
        for (int64_t e : neg) { enc.push_back(e); lab.push_back(0.0f); }
        // full shuffle
        for (int64_t i = (int64_t)enc.size() - 1; i > 0; --i) {
            int64_t j = (int64_t)rng.below((uint64_t)(i + 1));
            std::swap(enc[i], enc[j]);
            std::swap(lab[i], lab[j]);
        }
        for (size_t t = 0; t < enc.size() && written < cap; ++t) {
            int64_t p = enc[t] / m, q = enc[t] % m;
            out_pairs[2 * written] = (int32_t)idx[p];
            out_pairs[2 * written + 1] = (int32_t)idx[q];
            out_labels[written] = lab[t];
            ++written;
        }
    }
    return written;
}

}  // extern "C"
