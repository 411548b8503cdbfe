// Sparse symmetric LDL^T factorization with inertia and blocked
// multiple-RHS triangular solves.
//
// Native replacement for the capability the reference reaches through MKL
// PARDISO via ctypes (reference raleigh/algebra/mkl_wrap.py:350-545):
// phase-11 analyse (here: elimination-tree symbolic analysis), phase-22
// LDL^T factorize (up-looking simplicial, with tiny-pivot perturbation for
// shifted indefinite matrices), phase-33 solve with nrhs block right-hand
// sides (RHS-contiguous layout so the inner loops vectorize), and inertia
// (signs of D, reference mkl_wrap.py:491-545).
//
// Input: upper-triangular part of A (with diagonal) in CSC layout =
// lower-triangular CSR of the symmetric matrix; any fill-reducing
// permutation is applied by the Python caller beforehand.
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC ldlt.cpp -o libldlt.so

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

struct LdltHandle {
    int64_t n = 0;
    // input matrix, upper-tri CSC (column j holds rows i <= j)
    std::vector<int64_t> Ap, Ai;
    std::vector<double> Ax;
    // symbolic
    std::vector<int64_t> parent, Lnz;
    // numeric factor L (unit lower triangular, CSC, strict lower part)
    std::vector<int64_t> Lp, Li;
    std::vector<double> Lx, D;
    int64_t n_neg = 0, n_pos = 0, n_zero = 0, n_perturbed = 0;
    bool factorized = false;
};

void* ldlt_create(int64_t n, const int64_t* Ap, const int64_t* Ai,
                  const double* Ax) {
    LdltHandle* h = new LdltHandle();
    h->n = n;
    int64_t nnz = Ap[n];
    h->Ap.assign(Ap, Ap + n + 1);
    h->Ai.assign(Ai, Ai + nnz);
    h->Ax.assign(Ax, Ax + nnz);
    return h;
}

void ldlt_destroy(void* vh) { delete static_cast<LdltHandle*>(vh); }

// Symbolic analysis: elimination tree and per-column factor counts via the
// standard row-subtree traversal over the upper-triangular structure.
int64_t ldlt_analyse(void* vh) {
    LdltHandle* h = static_cast<LdltHandle*>(vh);
    const int64_t n = h->n;
    h->parent.assign(n, -1);
    h->Lnz.assign(n, 0);
    std::vector<int64_t> flag(n, -1);
    for (int64_t k = 0; k < n; ++k) {
        flag[k] = k;
        for (int64_t p = h->Ap[k]; p < h->Ap[k + 1]; ++p) {
            int64_t i = h->Ai[p];
            if (i >= k) continue;  // strict upper entries only
            // walk from i up the partial elimination tree to the root of
            // the row subtree, marking and counting
            while (flag[i] != k) {
                if (h->parent[i] == -1) h->parent[i] = k;
                h->Lnz[i]++;
                flag[i] = k;
                i = h->parent[i];
            }
        }
    }
    h->Lp.assign(n + 1, 0);
    for (int64_t k = 0; k < n; ++k) h->Lp[k + 1] = h->Lp[k] + h->Lnz[k];
    return h->Lp[n];  // factor nnz (strict lower)
}

// Numeric factorization (up-looking). Returns 0 on success, -k-1 if column
// k produced a zero pivot that could not be perturbed meaningfully.
int64_t ldlt_factorize(void* vh, double pivot_rel_eps) {
    LdltHandle* h = static_cast<LdltHandle*>(vh);
    const int64_t n = h->n;
    if (h->parent.empty()) ldlt_analyse(vh);
    int64_t lnz = h->Lp[n];
    h->Li.assign(lnz, 0);
    h->Lx.assign(lnz, 0.0);
    h->D.assign(n, 0.0);
    std::vector<int64_t> lnext(h->Lp.begin(), h->Lp.end() - 1);
    std::vector<int64_t> pattern(n), flag(n, -1);
    std::vector<double> y(n, 0.0);

    double amax = 0.0;
    for (double v : h->Ax) amax = std::max(amax, std::fabs(v));
    const double piv_floor = pivot_rel_eps * amax;

    h->n_neg = h->n_pos = h->n_zero = h->n_perturbed = 0;
    for (int64_t k = 0; k < n; ++k) {
        // scatter column k of A (upper part) into the dense accumulator,
        // collecting the nonzero pattern of row k of L via etree walks
        int64_t top = n;
        flag[k] = k;
        double dk = 0.0;
        for (int64_t p = h->Ap[k]; p < h->Ap[k + 1]; ++p) {
            int64_t i = h->Ai[p];
            if (i > k) continue;
            if (i == k) { dk = h->Ax[p]; continue; }
            y[i] = h->Ax[p];
            int64_t len = 0;
            std::vector<int64_t>& pat = pattern;
            while (flag[i] != k) {
                pat[len++] = i;
                flag[i] = k;
                i = h->parent[i];
            }
            // prepend this path (reversed) to keep topological order
            while (len > 0) pat[--top] = pat[--len];
        }
        // sparse triangular solve: process pattern in topological order
        for (int64_t t = top; t < n; ++t) {
            int64_t i = pattern[t];
            double yi = y[i];
            y[i] = 0.0;
            double lki = yi / h->D[i];
            // update the accumulator with column i of L
            int64_t pend = lnext[i];
            for (int64_t p = h->Lp[i]; p < pend; ++p)
                y[h->Li[p]] -= h->Lx[p] * yi;
            dk -= lki * yi;
            // append L(k, i) to column i of the factor
            h->Li[pend] = k;
            h->Lx[pend] = lki;
            lnext[i] = pend + 1;
        }
        // pivot handling: tiny pivots are perturbed, preserving the sign
        // (PARDISO-style static pivoting for shifted indefinite systems)
        if (std::fabs(dk) <= piv_floor) {
            if (amax == 0.0) return -k - 1;
            double sign = (dk < 0.0) ? -1.0 : 1.0;
            dk = sign * (piv_floor > 0 ? piv_floor
                                       : pivot_rel_eps);
            h->n_perturbed++;
        }
        h->D[k] = dk;
        if (dk < 0) h->n_neg++; else if (dk > 0) h->n_pos++; else h->n_zero++;
    }
    h->factorized = true;
    return 0;
}

// Solve (LDL^T) X = B for nrhs right-hand sides stored RHS-contiguous:
// b[i*nrhs + r] is component i of RHS r. In-place capable (b == x).
// The RHS-contiguous layout makes every inner loop a unit-stride fused
// multiply-add over nrhs lanes (vectorized); with OpenMP available the
// RHS block is additionally split across threads (the triangular sweeps
// are sequential in rows but independent across right-hand sides).
static void ldlt_solve_range(const LdltHandle* h, int64_t nrhs,
                             int64_t r0, int64_t r1, double* x) {
    const int64_t n = h->n;
    const int64_t* __restrict Lp = h->Lp.data();
    const int64_t* __restrict Li = h->Li.data();
    const double* __restrict Lx = h->Lx.data();
    const double* __restrict D = h->D.data();
    // forward: L y = b
    for (int64_t j = 0; j < n; ++j) {
        const double* __restrict xj = x + j * nrhs;
        for (int64_t p = Lp[j]; p < Lp[j + 1]; ++p) {
            const double l = Lx[p];
            double* __restrict xi = x + Li[p] * nrhs;
#pragma omp simd
            for (int64_t r = r0; r < r1; ++r) xi[r] -= l * xj[r];
        }
    }
    // diagonal: D z = y
    for (int64_t j = 0; j < n; ++j) {
        const double di = 1.0 / D[j];
        double* __restrict xj = x + j * nrhs;
#pragma omp simd
        for (int64_t r = r0; r < r1; ++r) xj[r] *= di;
    }
    // backward: L^T x = z
    for (int64_t j = n - 1; j >= 0; --j) {
        double* __restrict xj = x + j * nrhs;
        for (int64_t p = Lp[j]; p < Lp[j + 1]; ++p) {
            const double l = Lx[p];
            const double* __restrict xi = x + Li[p] * nrhs;
#pragma omp simd
            for (int64_t r = r0; r < r1; ++r) xj[r] -= l * xi[r];
        }
    }
}

void ldlt_solve(void* vh, int64_t nrhs, const double* b, double* x) {
    LdltHandle* h = static_cast<LdltHandle*>(vh);
    const int64_t n = h->n;
    if (x != b) std::memcpy(x, b, sizeof(double) * n * nrhs);
#ifdef _OPENMP
    if (nrhs >= 8) {
#pragma omp parallel num_threads(2)
        {
            int t = omp_get_thread_num();
            int nt = omp_get_num_threads();
            int64_t chunk = (nrhs + nt - 1) / nt;
            int64_t r0 = t * chunk;
            int64_t r1 = std::min<int64_t>(nrhs, r0 + chunk);
            if (r0 < r1) ldlt_solve_range(h, nrhs, r0, r1, x);
        }
        return;
    }
#endif
    ldlt_solve_range(h, nrhs, 0, nrhs, x);
}

void ldlt_inertia(void* vh, int64_t* neg, int64_t* pos, int64_t* zero) {
    LdltHandle* h = static_cast<LdltHandle*>(vh);
    *neg = h->n_neg;
    *pos = h->n_pos;
    *zero = h->n_zero;
}

int64_t ldlt_factor_nnz(void* vh) {
    LdltHandle* h = static_cast<LdltHandle*>(vh);
    return h->Lp.empty() ? 0 : h->Lp[h->n];
}

int64_t ldlt_perturbed(void* vh) {
    return static_cast<LdltHandle*>(vh)->n_perturbed;
}

}  // extern "C"
