// Threshold incomplete-LU (ILUT) preconditioner.
//
// Native replacement for the reference's ctypes->MKL dcsrilut route
// (reference raleigh/algebra/mkl_wrap.py:279-347): row-wise ILUT(tau, p)
// after Saad, with the same knobs — a drop tolerance relative to the row
// norm and a per-row fill cap — and the same unit-lower/upper factor pair
// applied by two triangular sweeps per right-hand side.  Block solves run
// RHS-contiguous so the inner loops vectorize, with OpenMP over column
// slabs (each slab performs its own full forward+backward sweep; the row
// recurrence is sequential but slabs are independent).
//
// Real double only, matching the reference (dcsrilut has no s/c/z
// variants in its wrapper either).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

typedef int64_t i64;

namespace {

struct Ilut {
    i64 n = 0;
    // input CSR (full pattern, 0-based)
    std::vector<i64> ia, ja;
    std::vector<double> a;
    // factors: strict-lower L (unit diagonal implied), strict-upper U,
    // and the U diagonal
    std::vector<i64> lp, lj, up, uj;
    std::vector<double> lv, uv, d;
    bool factored = false;
};

// binary min-heap over column indices
inline void heap_push(std::vector<i64>& h, i64 v) {
    h.push_back(v);
    size_t c = h.size() - 1;
    while (c > 0) {
        size_t p = (c - 1) / 2;
        if (h[p] <= h[c]) break;
        std::swap(h[p], h[c]);
        c = p;
    }
}

inline i64 heap_pop(std::vector<i64>& h) {
    i64 top = h[0];
    h[0] = h.back();
    h.pop_back();
    size_t p = 0, m = h.size();
    while (true) {
        size_t l = 2 * p + 1, r = l + 1, best = p;
        if (l < m && h[l] < h[best]) best = l;
        if (r < m && h[r] < h[best]) best = r;
        if (best == p) break;
        std::swap(h[p], h[best]);
        p = best;
    }
    return top;
}

}  // namespace

extern "C" {

void* ilut_create(i64 n, const i64* ia, const i64* ja, const double* a) {
    Ilut* h = new Ilut;
    h->n = n;
    h->ia.assign(ia, ia + n + 1);
    h->ja.assign(ja, ja + ia[n]);
    h->a.assign(a, a + ia[n]);
    return h;
}

void ilut_destroy(void* ptr) { delete static_cast<Ilut*>(ptr); }

// Returns factor nnz (L strict + U strict + diagonal) or -(i+1) when the
// diagonal of row i vanished and could not be safeguarded.
i64 ilut_factorize(void* ptr, double tol, i64 maxfil) {
    Ilut& h = *static_cast<Ilut*>(ptr);
    const i64 n = h.n;
    if (maxfil < 1) maxfil = 1;

    h.lp.assign(n + 1, 0);
    h.up.assign(n + 1, 0);
    h.lj.clear(); h.lv.clear();
    h.uj.clear(); h.uv.clear();
    h.lj.reserve(size_t(maxfil) * n);
    h.lv.reserve(size_t(maxfil) * n);
    h.uj.reserve(size_t(maxfil) * n);
    h.uv.reserve(size_t(maxfil) * n);
    h.d.assign(n, 0.0);

    std::vector<double> w(n, 0.0);
    std::vector<i64> pattern;       // marked columns of the work row
    std::vector<char> marked(n, 0);
    std::vector<i64> heap;          // active columns < i, min-first
    std::vector<i64> cand;          // gather scratch
    pattern.reserve(16 * size_t(maxfil) + 16);

    for (i64 i = 0; i < n; ++i) {
        pattern.clear();
        heap.clear();
        double row2 = 0.0;
        for (i64 q = h.ia[i]; q < h.ia[i + 1]; ++q) {
            i64 j = h.ja[q];
            double v = h.a[q];
            w[j] = v;
            marked[j] = 1;
            pattern.push_back(j);
            if (j < i) heap_push(heap, j);
            row2 += v * v;
        }
        const double rownorm = std::sqrt(row2);
        const double tau = tol * rownorm;

        // eliminate lower entries in ascending column order; fill may
        // introduce new active columns, hence the heap
        while (!heap.empty()) {
            i64 k = heap_pop(heap);
            double lik = w[k] / h.d[k];
            if (std::abs(lik) < tau) {      // drop the multiplier
                w[k] = 0.0;
                continue;
            }
            w[k] = lik;
            for (i64 q = h.up[k]; q < h.up[k + 1]; ++q) {
                i64 j = h.uj[q];
                double upd = lik * h.uv[q];
                if (marked[j]) {
                    w[j] -= upd;
                } else {
                    marked[j] = 1;
                    pattern.push_back(j);
                    w[j] = -upd;
                    if (j < i) heap_push(heap, j);
                }
            }
        }

        // gather L: keep the maxfil largest multipliers, columns sorted
        cand.clear();
        for (i64 j : pattern)
            if (j < i && w[j] != 0.0) cand.push_back(j);
        if ((i64)cand.size() > maxfil) {
            std::nth_element(cand.begin(), cand.begin() + maxfil,
                             cand.end(), [&](i64 x, i64 y) {
                                 return std::abs(w[x]) > std::abs(w[y]);
                             });
            cand.resize(maxfil);
        }
        std::sort(cand.begin(), cand.end());
        for (i64 j : cand) {
            h.lj.push_back(j);
            h.lv.push_back(w[j]);
        }
        h.lp[i + 1] = (i64)h.lj.size();

        // diagonal with the dcsrilut-style small-pivot safeguard
        double di = marked[i] ? w[i] : 0.0;
        if (std::abs(di) < tau || di == 0.0) {
            double mag = tau > 0.0 ? tau : rownorm * 1e-16;
            if (mag == 0.0) return -(i + 1);
            di = (di >= 0.0 ? mag : -mag);
        }
        h.d[i] = di;

        // gather U: entries above the drop threshold, maxfil largest
        cand.clear();
        for (i64 j : pattern)
            if (j > i && std::abs(w[j]) >= tau) cand.push_back(j);
        if ((i64)cand.size() > maxfil) {
            std::nth_element(cand.begin(), cand.begin() + maxfil,
                             cand.end(), [&](i64 x, i64 y) {
                                 return std::abs(w[x]) > std::abs(w[y]);
                             });
            cand.resize(maxfil);
        }
        std::sort(cand.begin(), cand.end());
        for (i64 j : cand) {
            h.uj.push_back(j);
            h.uv.push_back(w[j]);
        }
        h.up[i + 1] = (i64)h.uj.size();

        for (i64 j : pattern) {
            w[j] = 0.0;
            marked[j] = 0;
        }
    }
    h.factored = true;
    return (i64)(h.lj.size() + h.uj.size()) + n;
}

i64 ilut_factor_nnz(void* ptr) {
    Ilut& h = *static_cast<Ilut*>(ptr);
    return h.factored ? (i64)(h.lj.size() + h.uj.size()) + h.n : 0;
}

// Solve L U x = b in place; ``b`` is RHS-contiguous (n, nrhs) row-major
// (b[row * nrhs + rhs]).  Independent column slabs run in parallel.
void ilut_solve(void* ptr, i64 nrhs, double* b) {
    Ilut& h = *static_cast<Ilut*>(ptr);
    const i64 n = h.n;
    if (!h.factored || nrhs < 1) return;

    i64 nslabs = 1;
#ifdef _OPENMP
    nslabs = std::min<i64>(omp_get_max_threads(), (nrhs + 15) / 16);
    if (nslabs < 1) nslabs = 1;
#endif

#ifdef _OPENMP
#pragma omp parallel for schedule(static) num_threads((int)nslabs)
#endif
    for (i64 s = 0; s < nslabs; ++s) {
        const i64 c0 = s * nrhs / nslabs;
        const i64 c1 = (s + 1) * nrhs / nslabs;
        const i64 w = c1 - c0;
        if (w <= 0) continue;
        // forward: (unit L) y = b
        for (i64 i = 0; i < n; ++i) {
            double* bi = b + i * nrhs + c0;
            for (i64 q = h.lp[i]; q < h.lp[i + 1]; ++q) {
                const double l = h.lv[q];
                const double* bj = b + h.lj[q] * nrhs + c0;
                for (i64 c = 0; c < w; ++c) bi[c] -= l * bj[c];
            }
        }
        // backward: U x = y
        for (i64 i = n - 1; i >= 0; --i) {
            double* bi = b + i * nrhs + c0;
            for (i64 q = h.up[i]; q < h.up[i + 1]; ++q) {
                const double u = h.uv[q];
                const double* bj = b + h.uj[q] * nrhs + c0;
                for (i64 c = 0; c < w; ++c) bi[c] -= u * bj[c];
            }
            const double dinv = 1.0 / h.d[i];
            for (i64 c = 0; c < w; ++c) bi[c] *= dinv;
        }
    }
}

}  // extern "C"
