// Supernodal multifrontal LDL^T / LDL^H factorization with BLAS3 fronts.
//
// Second-generation numeric engine behind SparseSymmetricSolver (the
// PARDISO replacement; reference raleigh/algebra/mkl_wrap.py:350-545):
// the up-looking simplicial code in ldlt.cpp is the robust fallback, this
// engine processes relaxed supernodes as dense frontal matrices so the
// flops run through dgemm/dtrsm (resolved at runtime from SciPy's bundled
// OpenBLAS via dlopen; scalar kernels otherwise).
//
// The whole numeric engine is a template over the scalar type: T = double
// gives the real symmetric LDL^T (exported as ldltmf_*), T =
// std::complex<double> gives the Hermitian LDL^H with a real diagonal D
// (exported as zldltmf_*) — inertia comes straight from sign(D), exactly
// the property the reference extracts from PARDISO's iparm/diag probing
// (mkl_wrap.py:491-545).  The only scalar-type-sensitive spots are (a)
// conjugation when a relabeled entry flips triangles, (b) 'T' vs 'C' in
// the trsm/gemm calls, and (c) D kept real.
//
// Pipeline: postorder the elimination tree, detect fundamental supernodes
// (parent chain + equal column counts, width-capped), then for each
// supernode in postorder: assemble its A columns and its children's
// update matrices into a dense column-major front, partial-LDL the pivot
// block (with PARDISO-style static pivot perturbation for shifted
// indefinite systems), trsm the subdiagonal panel, gemm the Schur
// complement, and push it on the update stack for the parent.
// Triangular solves are supernodal too: per supernode one trsm-like sweep
// plus a gemm against the block of right-hand sides.

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <cmath>
#include <cstdio>
#include <complex>
#include <string>
#include <vector>
#include <algorithm>
#include <dlfcn.h>
#include <unistd.h>
#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

typedef std::complex<double> cplx;

typedef void (*dgemm_t)(const char*, const char*, const int*, const int*,
                        const int*, const double*, const double*, const int*,
                        const double*, const int*, const double*, double*,
                        const int*);
typedef void (*dtrsm_t)(const char*, const char*, const char*, const char*,
                        const int*, const int*, const double*, const double*,
                        const int*, double*, const int*);
typedef void (*zgemm_t)(const char*, const char*, const int*, const int*,
                        const int*, const cplx*, const cplx*, const int*,
                        const cplx*, const int*, const cplx*, cplx*,
                        const int*);
typedef void (*ztrsm_t)(const char*, const char*, const char*, const char*,
                        const int*, const int*, const cplx*, const cplx*,
                        const int*, cplx*, const int*);

typedef void (*set_threads_t)(int);

dgemm_t g_dgemm = nullptr;
dtrsm_t g_dtrsm = nullptr;
zgemm_t g_zgemm = nullptr;
ztrsm_t g_ztrsm = nullptr;
set_threads_t g_blas_set_threads = nullptr;

inline double conj_of(double x) { return x; }
inline cplx conj_of(const cplx& x) { return std::conj(x); }
inline double real_of(double x) { return x; }
inline double real_of(const cplx& x) { return x.real(); }
inline double abs_of(double x) { return std::fabs(x); }
inline double abs_of(const cplx& x) { return std::abs(x); }

// op(A)(i,p) for the naive kernels: 'N', 'T' (transpose) or 'C'
// (conjugate transpose)
template <typename T>
inline T op_at(char op, const T* a, int lda, int i, int p) {
    if (op == 'N') return a[i + (size_t)p * lda];
    T v = a[p + (size_t)i * lda];
    return op == 'C' ? conj_of(v) : v;
}

template <typename T>
void naive_gemm(const char* ta, const char* tb, const int* m, const int* n,
                const int* k, const T* alpha, const T* a, const int* lda,
                const T* b, const int* ldb, const T* beta, T* c,
                const int* ldc) {
    int M = *m, N = *n, K = *k;
    T al = *alpha, be = *beta;
    for (int j = 0; j < N; ++j)
        for (int i = 0; i < M; ++i) {
            T s = T(0);
            for (int p = 0; p < K; ++p)
                s += op_at(*ta, a, *lda, i, p) * op_at(*tb, b, *ldb, p, j);
            c[i + (size_t)j * *ldc] = be * c[i + (size_t)j * *ldc] + al * s;
        }
}

// the trsm variants this file uses, all with unit lower-triangular L:
//   side='R', ta='T'/'C':  B := B * inv(op(L))   (panel sweep)
//   side='L', ta='N':      solve L X = B
//   side='L', ta='T'/'C':  solve op(L) X = B
template <typename T>
void naive_trsm(const char* side, const char* uplo, const char* ta,
                const char* diag, const int* m, const int* n, const T* alpha,
                const T* a, const int* lda, T* b, const int* ldb) {
    (void)uplo; (void)diag; (void)alpha;
    int M = *m, N = *n;
    if (*side == 'R') {
        // B := B * inv(op(L));  op(L)(p,j) = L(j,p) (or conj) for p < j
        for (int j = 0; j < N; ++j) {
            for (int p = 0; p < j; ++p) {
                T l = a[j + (size_t)p * *lda];       // L(j,p)
                if (*ta == 'C') l = conj_of(l);
                for (int i = 0; i < M; ++i)
                    b[i + (size_t)j * *ldb] -= l * b[i + (size_t)p * *ldb];
            }
        }
    } else if (*ta == 'N') {
        // forward substitution, column-major B (M x N)
        for (int rr = 0; rr < N; ++rr) {
            T* col = b + (size_t)rr * *ldb;
            for (int j = 0; j < M; ++j)
                for (int i = j + 1; i < M; ++i)
                    col[i] -= a[i + (size_t)j * *lda] * col[j];
        }
    } else {
        // backward substitution with op(L)
        for (int rr = 0; rr < N; ++rr) {
            T* col = b + (size_t)rr * *ldb;
            for (int j = M - 1; j >= 0; --j)
                for (int i = j + 1; i < M; ++i) {
                    T l = a[i + (size_t)j * *lda];
                    if (*ta == 'C') l = conj_of(l);
                    col[j] -= l * col[i];
                }
        }
    }
}

template <typename T> struct Blas;

template <> struct Blas<double> {
    static constexpr char CT = 'T';   // (conjugate) transpose opcode
    static void gemm(const char* ta, const char* tb, const int* m,
                     const int* n, const int* k, const double* al,
                     const double* a, const int* lda, const double* b,
                     const int* ldb, const double* be, double* c,
                     const int* ldc) {
        if (g_dgemm) g_dgemm(ta, tb, m, n, k, al, a, lda, b, ldb, be, c, ldc);
        else naive_gemm(ta, tb, m, n, k, al, a, lda, b, ldb, be, c, ldc);
    }
    static void trsm(const char* s, const char* u, const char* ta,
                     const char* dg, const int* m, const int* n,
                     const double* al, const double* a, const int* lda,
                     double* b, const int* ldb) {
        if (g_dtrsm) g_dtrsm(s, u, ta, dg, m, n, al, a, lda, b, ldb);
        else naive_trsm(s, u, ta, dg, m, n, al, a, lda, b, ldb);
    }
};

template <> struct Blas<cplx> {
    static constexpr char CT = 'C';
    static void gemm(const char* ta, const char* tb, const int* m,
                     const int* n, const int* k, const cplx* al,
                     const cplx* a, const int* lda, const cplx* b,
                     const int* ldb, const cplx* be, cplx* c,
                     const int* ldc) {
        if (g_zgemm) g_zgemm(ta, tb, m, n, k, al, a, lda, b, ldb, be, c, ldc);
        else naive_gemm(ta, tb, m, n, k, al, a, lda, b, ldb, be, c, ldc);
    }
    static void trsm(const char* s, const char* u, const char* ta,
                     const char* dg, const int* m, const int* n,
                     const cplx* al, const cplx* a, const int* lda,
                     cplx* b, const int* ldb) {
        if (g_ztrsm) g_ztrsm(s, u, ta, dg, m, n, al, a, lda, b, ldb);
        else naive_trsm(s, u, ta, dg, m, n, al, a, lda, b, ldb);
    }
};

template <typename T>
struct Supernode {
    int64_t c0, c1;                  // column range [c0, c1)
    std::vector<int64_t> rows;       // rows strictly below the supernode
    std::vector<T> L11;              // (w x w) column-major, unit lower
    std::vector<T> L21;              // (r x w) column-major
    std::vector<double> D;           // (w), real also in the Hermitian case
};

template <typename T>
struct MfHandle {
    int64_t n = 0;
    std::vector<int64_t> Ap, Ai;     // relabeled upper CSC
    std::vector<T> Ax;
    std::vector<int64_t> Lp_low, Li_low;   // relabeled lower CSC (pattern)
    std::vector<T> Lx_low;
    std::vector<int64_t> post;       // postorder relabel: new = post_of[old]
    std::vector<int64_t> ipost;
    std::vector<Supernode<T>> snodes;
    std::vector<int64_t> snode_of_col;
    std::vector<int64_t> col_parent, col_lnz;  // relabeled etree + counts
    int64_t n_neg = 0, n_pos = 0, n_zero = 0, n_perturbed = 0;
    int64_t factor_nnz = 0;
    bool factorized = false;
};

template <typename T>
struct Update {
    std::vector<int64_t> rows;
    std::vector<T> m;                // (r x r) column-major, full
};

struct FactCounters {
    int64_t n_neg = 0, n_pos = 0, n_zero = 0, n_perturbed = 0;
    int64_t factor_nnz = 0;
};

void etree_upper_csc(int64_t n, const int64_t* Ap, const int64_t* Ai,
                     std::vector<int64_t>& parent,
                     std::vector<int64_t>& lnz) {
    parent.assign(n, -1);
    lnz.assign(n, 0);
    std::vector<int64_t> flag(n, -1);
    for (int64_t k = 0; k < n; ++k) {
        flag[k] = k;
        for (int64_t p = Ap[k]; p < Ap[k + 1]; ++p) {
            int64_t i = Ai[p];
            if (i >= k) continue;
            while (flag[i] != k) {
                if (parent[i] == -1) parent[i] = k;
                lnz[i]++;
                flag[i] = k;
                i = parent[i];
            }
        }
    }
}

template <typename T>
MfHandle<T>* mf_create(int64_t n, const int64_t* Ap, const int64_t* Ai,
                       const T* Ax) {
    MfHandle<T>* h = new MfHandle<T>();
    h->n = n;

    // 1) elimination tree of the input, then its postorder
    std::vector<int64_t> parent, lnz;
    etree_upper_csc(n, Ap, Ai, parent, lnz);
    std::vector<std::vector<int64_t>> kids(n);
    std::vector<int64_t> roots;
    for (int64_t v = 0; v < n; ++v) {
        if (parent[v] >= 0) kids[parent[v]].push_back(v);
        else roots.push_back(v);
    }
    h->post.assign(n, -1);       // post[old] = new label
    h->ipost.assign(n, -1);
    {
        int64_t label = 0;
        std::vector<std::pair<int64_t, size_t>> stack;
        for (int64_t r : roots) {
            stack.emplace_back(r, 0);
            while (!stack.empty()) {
                auto& top = stack.back();
                if (top.second < kids[top.first].size()) {
                    int64_t c = kids[top.first][top.second++];
                    stack.emplace_back(c, 0);
                } else {
                    h->post[top.first] = label;
                    h->ipost[label] = top.first;
                    ++label;
                    stack.pop_back();
                }
            }
        }
    }

    // 2) relabel the matrix by the postorder (upper CSC of P A P^T);
    // an entry whose (i, j) order flips under the relabeling moves to the
    // other triangle and must be conjugated in the Hermitian case
    int64_t nnz = Ap[n];
    std::vector<int64_t> cnt(n + 1, 0);
    std::vector<int64_t> ri(nnz), ci(nnz);
    std::vector<T> vx(nnz);
    for (int64_t j = 0; j < n; ++j)
        for (int64_t p = Ap[j]; p < Ap[j + 1]; ++p) {
            int64_t i2 = h->post[Ai[p]], j2 = h->post[j];
            T v = Ax[p];
            if (i2 > j2) {
                std::swap(i2, j2);
                v = conj_of(v);
            }
            ri[p] = i2;
            ci[p] = j2;
            vx[p] = v;
            cnt[j2 + 1]++;
        }
    for (int64_t j = 0; j < n; ++j) cnt[j + 1] += cnt[j];
    h->Ap = cnt;
    h->Ai.assign(nnz, 0);
    h->Ax.assign(nnz, T(0));
    {
        std::vector<int64_t> next(h->Ap.begin(), h->Ap.end() - 1);
        for (int64_t p = 0; p < nnz; ++p) {
            int64_t q = next[ci[p]]++;
            h->Ai[q] = ri[p];
            h->Ax[q] = vx[p];
        }
        // sort each column by row
        for (int64_t j = 0; j < n; ++j) {
            int64_t a = h->Ap[j], b = h->Ap[j + 1];
            std::vector<std::pair<int64_t, T>> col;
            col.reserve(b - a);
            for (int64_t p = a; p < b; ++p)
                col.emplace_back(h->Ai[p], h->Ax[p]);
            std::sort(col.begin(), col.end(),
                      [](const std::pair<int64_t, T>& x,
                         const std::pair<int64_t, T>& y) {
                          return x.first < y.first;
                      });
            for (int64_t p = a; p < b; ++p) {
                h->Ai[p] = col[p - a].first;
                h->Ax[p] = col[p - a].second;
            }
        }
    }
    // lower CSC (= conjugate transpose of upper CSC) for per-column
    // assembly: lower column i holds rows j >= i with value B[j, i] =
    // conj(B[i, j])
    {
        std::vector<int64_t> c2(n + 1, 0);
        for (int64_t p = 0; p < nnz; ++p) c2[h->Ai[p] + 1]++;
        for (int64_t j = 0; j < n; ++j) c2[j + 1] += c2[j];
        h->Lp_low = c2;
        h->Li_low.assign(nnz, 0);
        h->Lx_low.assign(nnz, T(0));
        std::vector<int64_t> next(h->Lp_low.begin(), h->Lp_low.end() - 1);
        for (int64_t j = 0; j < n; ++j)
            for (int64_t p = h->Ap[j]; p < h->Ap[j + 1]; ++p) {
                int64_t i = h->Ai[p];
                int64_t q = next[i]++;
                h->Li_low[q] = j;     // (row j of lower col i) -> j >= i
                h->Lx_low[q] = (j == i) ? h->Ax[p] : conj_of(h->Ax[p]);
            }
    }

    // 3) supernode partition on the relabeled tree: fundamental supernodes
    // plus relaxed amalgamation along parent chains — small column-count
    // jumps are absorbed as explicit zeros so the fronts get wide enough
    // to keep dgemm on the BLAS3 fast path (FE meshes with few dofs per
    // node otherwise yield width-3 fronts)
    etree_upper_csc(n, h->Ap.data(), h->Ai.data(), h->col_parent,
                    h->col_lnz);
    const std::vector<int64_t>& parent2 = h->col_parent;
    const std::vector<int64_t>& lnz2 = h->col_lnz;
    // fundamental chains may grow to WCAP (wide separator supernodes are
    // factored with a blocked in-front panel sweep, so width costs no
    // extra update traffic); relaxed amalgamation defaults are the
    // round-5 sweep winners on the FE flagship (128/48/2: 4.9 -> 4.0 s
    // numeric factorize at identical symbolic fill — wider fronts keep
    // dgemm on the BLAS3 fast path; env-overridable for experiments)
    const int64_t WCAP = 1024;
    static const int64_t WRELAX = [] {
        const char* e = std::getenv("RALEIGH_MF_WRELAX");
        return e ? atoll(e) : 128;
    }();
    static const int64_t JUMP0 = [] {
        const char* e = std::getenv("RALEIGH_MF_JUMP");
        return e ? atoll(e) : 48;
    }();
    static const int64_t JDIV = [] {
        const char* e = std::getenv("RALEIGH_MF_JDIV");
        return e ? atoll(e) : 2;
    }();
    h->snode_of_col.assign(n, -1);
    for (int64_t j = 0; j < n;) {
        int64_t c0 = j;
        int64_t w = 1;
        while (c0 + w < n && parent2[c0 + w - 1] == c0 + w && w < WCAP) {
            int64_t prev = lnz2[c0 + w - 1], next = lnz2[c0 + w];
            bool fundamental = (prev == next + 1);
            // relaxed: tolerate a bounded count jump (explicit zeros)
            int64_t jump = prev - 1 - next;
            bool relaxed = (w < WRELAX)
                && jump >= 0
                && jump <= std::max<int64_t>(JUMP0, next / JDIV);
            if (!(fundamental || relaxed)) break;
            ++w;
        }
        Supernode<T> s;
        s.c0 = c0;
        s.c1 = c0 + w;
        for (int64_t c = c0; c < s.c1; ++c)
            h->snode_of_col[c] = (int64_t)h->snodes.size();
        h->snodes.push_back(std::move(s));
        j = c0 + w;
    }
    return h;
}

// Factor one supernode: assemble its front from A and the children
// updates on top of ``stack``, partial-LDL the pivot block, trsm the
// panel, push the Schur update.  Thread-safe across disjoint supernodes
// (all shared handle state is read-only here; results land in s and cnt).
template <typename T>
int64_t process_snode(MfHandle<T>* h, Supernode<T>& s,
                      std::vector<Update<T>>& stack,
                      std::vector<int64_t>& loc, double piv_floor,
                      double amax, double pivot_rel_eps,
                      FactCounters& cnt) {
    const char CT[2] = {Blas<T>::CT, 0};
    {
        const int64_t w = s.c1 - s.c0;
        // children updates sit on top of the stack: count how many by
        // checking row ownership (their first row lies in this supernode
        // or beyond; by postorder all pending updates whose first row is
        // within [c0, c1) belong to children of this supernode)
        size_t first_child = stack.size();
        while (first_child > 0) {
            const auto& u = stack[first_child - 1];
            if (!u.rows.empty() && u.rows[0] >= s.c0 && u.rows[0] < s.c1)
                --first_child;
            else
                break;
        }
        // rows below the supernode: union of A-lower patterns of its
        // columns and the children's update rows
        std::vector<int64_t> rows;
        for (int64_t c = s.c0; c < s.c1; ++c)
            for (int64_t p = h->Lp_low[c]; p < h->Lp_low[c + 1]; ++p) {
                int64_t r = h->Li_low[p];
                if (r >= s.c1) rows.push_back(r);
            }
        for (size_t u = first_child; u < stack.size(); ++u)
            for (int64_t r : stack[u].rows)
                if (r >= s.c1) rows.push_back(r);
        std::sort(rows.begin(), rows.end());
        rows.erase(std::unique(rows.begin(), rows.end()), rows.end());
        const int64_t r = (int64_t)rows.size();
        const int64_t d = w + r;

        // local index map
        for (int64_t c = s.c0; c < s.c1; ++c) loc[c] = c - s.c0;
        for (int64_t t = 0; t < r; ++t) loc[rows[t]] = w + t;

        // the front is held as a (d x w) column-major PANEL only; the
        // trailing (r x r) Schur block is produced straight into the
        // update buffer by gemm (beta=0) and children's F22 pieces are
        // scatter-added afterwards — no d x d buffer, no copy-out
        std::vector<T> F((size_t)d * w, T(0));
        // assemble A columns (lower part; columns are always in-supernode)
        for (int64_t c = s.c0; c < s.c1; ++c) {
            int64_t lc = loc[c];
            for (int64_t p = h->Lp_low[c]; p < h->Lp_low[c + 1]; ++p) {
                int64_t i = h->Li_low[p];
                F[(size_t)lc * d + loc[i]] += h->Lx_low[p];
            }
        }
        // extend-add children contributions that land in panel columns
        for (size_t u = first_child; u < stack.size(); ++u) {
            const auto& up = stack[u];
            const int64_t rc = (int64_t)up.rows.size();
            for (int64_t j = 0; j < rc; ++j) {
                int64_t lj = loc[up.rows[j]];
                if (lj >= w) break;   // rows sorted: rest is F22 territory
                const T* src = up.m.data() + (size_t)j * rc;
                T* dst = F.data() + (size_t)lj * d;
                for (int64_t i = j; i < rc; ++i)
                    dst[loc[up.rows[i]]] += src[i];
            }
        }

        // blocked partial LDL of the (w x w) pivot block + panel: process
        // PB-wide panels left to right; within each panel a scalar LDL of
        // the diagonal block, a trsm for everything below it, and a gemm
        // rank-PB update of the remaining columns — wide separator
        // supernodes run at BLAS3 speed instead of through the update
        // stack.  After this sweep the subdiagonal part of F holds
        // W = L * D (the trsm images), exactly as the one-shot path.
        const int64_t PB = 64;
        s.D.assign(w, 0.0);
        std::vector<T> ltmp;
        for (int64_t p0 = 0; p0 < w; p0 += PB) {
            const int64_t pw = std::min(PB, w - p0);
            const int64_t p1 = p0 + pw;
            // scalar LDL of the (pw x pw) diagonal block; normalize to
            // unit lower within the block.  Pivots are real (Hermitian
            // diagonal); F(i,k) -= W(i,j) * conj(L(k,j))
            for (int64_t j = p0; j < p1; ++j) {
                double dj = real_of(F[(size_t)j * d + j]);
                if (std::fabs(dj) <= piv_floor) {
                    if (amax == 0.0) return -(s.c0 + j) - 1;
                    dj = (dj < 0 ? -1.0 : 1.0)
                         * (piv_floor > 0 ? piv_floor : pivot_rel_eps);
                    cnt.n_perturbed++;
                }
                s.D[j] = dj;
                if (dj < 0) cnt.n_neg++; else if (dj > 0) cnt.n_pos++;
                else cnt.n_zero++;
                for (int64_t k = j + 1; k < p1; ++k) {
                    T ljk = conj_of(F[(size_t)j * d + k] / dj);  // conj L(k,j)
                    T* colk = F.data() + (size_t)k * d;
                    const T* colj = F.data() + (size_t)j * d;
                    for (int64_t i = k; i < p1; ++i)
                        colk[i] -= colj[i] * ljk;
                }
                for (int64_t i = j + 1; i < p1; ++i)
                    F[(size_t)j * d + i] /= dj;
            }
            // trsm: rows p1..d of the panel become W = L*D images
            // (F_below = W * L11^H  ->  W = F_below * inv(L11^H))
            const int64_t below = d - p1;
            if (below > 0) {
                int m_i = (int)below, n_i = (int)pw, d_i = (int)d;
                T one = T(1);
                Blas<T>::trsm("R", "L", CT, "U", &m_i, &n_i, &one,
                              F.data() + (size_t)p0 * d + p0, &d_i,
                              F.data() + (size_t)p0 * d + p1, &d_i);
            }
            // rank-pw update of the remaining pivot columns [p1, w):
            // F[p1:d, p1:w] -= W * Lpanel^H, Lpanel = W[p1:w] * D^-1
            const int64_t rem = w - p1;
            if (rem > 0 && below > 0) {
                ltmp.assign((size_t)rem * pw, T(0));
                for (int64_t j = 0; j < pw; ++j) {
                    double inv = 1.0 / s.D[p0 + j];
                    const T* wcol = F.data() + (size_t)(p0 + j) * d + p1;
                    for (int64_t i = 0; i < rem; ++i)
                        ltmp[(size_t)j * rem + i] = wcol[i] * inv;
                }
                int m_i = (int)below, n_i = (int)rem, k_i = (int)pw;
                int lda = (int)d, ldb = (int)rem, ldc = (int)d;
                T mone = T(-1), one = T(1);
                Blas<T>::gemm("N", CT, &m_i, &n_i, &k_i, &mone,
                              F.data() + (size_t)p0 * d + p1, &lda,
                              ltmp.data(), &ldb, &one,
                              F.data() + (size_t)p1 * d + p1, &ldc);
            }
        }
        // normalize the subdiagonal pivot-block rows to unit lower
        // (rows within [p1_j, w) of every panel hold W; convert to L)
        for (int64_t j = 0; j < w; ++j) {
            int64_t pend = std::min(((j / PB) + 1) * PB, w);
            double inv = 1.0 / s.D[j];
            T* col = F.data() + (size_t)j * d;
            for (int64_t i = pend; i < w; ++i) col[i] *= inv;
        }
        // store factors; build L21 = W * D^{-1}
        s.L11.assign((size_t)w * w, T(0));
        for (int64_t j = 0; j < w; ++j)
            for (int64_t i = j; i < w; ++i)
                s.L11[(size_t)j * w + i] = (i == j)
                    ? T(1) : F[(size_t)j * d + i];
        s.L21.assign((size_t)r * w, T(0));
        for (int64_t j = 0; j < w; ++j) {
            double inv = 1.0 / s.D[j];
            const T* wcol = F.data() + (size_t)j * d + w;
            T* lcol = s.L21.data() + (size_t)j * r;
            for (int64_t i = 0; i < r; ++i) lcol[i] = wcol[i] * inv;
        }
        cnt.factor_nnz += w * (w - 1) / 2 + r * w;

        // Schur complement straight into the update buffer:
        //   up.m = -W * L21^H   (W = L21 * D lives in the panel)
        if (r > 0) {
            Update<T> up;
            up.rows = rows;
            up.m.resize((size_t)r * r);
            int m_i = (int)r, n_i = (int)r, k_i = (int)w;
            int lda = (int)d, ldb = (int)r, ldc = (int)r;
            T mone = T(-1), zero = T(0);
            Blas<T>::gemm("N", CT, &m_i, &n_i, &k_i, &mone, F.data() + w,
                          &lda, s.L21.data(), &ldb, &zero, up.m.data(), &ldc);
            // now add the children's F22 contributions
            for (size_t u = first_child; u < stack.size(); ++u) {
                const auto& cu = stack[u];
                const int64_t rc = (int64_t)cu.rows.size();
                for (int64_t j = 0; j < rc; ++j) {
                    int64_t lj = loc[cu.rows[j]];
                    if (lj < w) continue;    // panel part, already added
                    const T* src = cu.m.data() + (size_t)j * rc;
                    T* dst = up.m.data() + (size_t)(lj - w) * r;
                    for (int64_t i = j; i < rc; ++i)
                        dst[loc[cu.rows[i]] - w] += src[i];
                }
            }
            stack.push_back(std::move(up));
        }
        // pop the children updates (keep the new one if it was pushed)
        if (r > 0) {
            Update<T> mine = std::move(stack.back());
            stack.resize(first_child);
            stack.push_back(std::move(mine));
        } else {
            stack.resize(first_child);
        }
        for (int64_t c = s.c0; c < s.c1; ++c) loc[c] = -1;
        for (int64_t t = 0; t < r; ++t) loc[rows[t]] = -1;
        s.rows = std::move(rows);
    }
    return 0;
}

// Numeric factorization with task-parallel elimination-subtree
// scheduling: independent subtrees of the supernode tree (contiguous
// supernode ranges in postorder) whose estimated work is below a
// threshold are factored concurrently, each with its own update stack
// and single-threaded BLAS; the remaining top of the tree then runs
// sequentially, its stack seeded with the subtree-root updates at their
// postorder positions (the stack invariant — children updates on top, in
// order — is thereby preserved).  This is the task-parallel counterpart
// of PARDISO's subtree scheduling on the host cores.
template <typename T>
int64_t mf_factorize(MfHandle<T>* h, double pivot_rel_eps) {
    const int64_t n = h->n;
    const int64_t ns = (int64_t)h->snodes.size();

    double amax = 0.0;
    for (const T& v : h->Ax) amax = std::max(amax, abs_of(v));
    const double piv_floor = pivot_rel_eps * amax;

    h->n_neg = h->n_pos = h->n_zero = h->n_perturbed = 0;
    h->factor_nnz = 0;

    // supernode tree + per-subtree work estimate (sum lnz^2 over columns)
    std::vector<int64_t> sparent(ns, -1);
    std::vector<double> weight(ns, 0.0);
    std::vector<int64_t> first_sid(ns);
    for (int64_t si = 0; si < ns; ++si) {
        const auto& s = h->snodes[si];
        double wk = 0.0;
        for (int64_t c = s.c0; c < s.c1; ++c) {
            double l = (double)h->col_lnz[c];
            wk += l * l;
        }
        weight[si] = wk;
        first_sid[si] = si;
        int64_t pc = h->col_parent[s.c1 - 1];
        sparent[si] = pc >= 0 ? h->snode_of_col[pc] : -1;
    }
    for (int64_t si = 0; si < ns; ++si)
        if (sparent[si] >= 0) {
            weight[sparent[si]] += weight[si];
            first_sid[sparent[si]] =
                std::min(first_sid[sparent[si]], first_sid[si]);
        }

    int nthreads = 1;
#ifdef _OPENMP
    // never oversubscribe the physical cores: an OMP_NUM_THREADS above
    // the core count thrashes (measured 2x slower on a 2-core host)
    nthreads = std::min(std::min(omp_get_max_threads(),
                                 omp_get_num_procs()), 8);
#endif
    double total = 0.0;
    for (int64_t si = 0; si < ns; ++si)
        if (sparent[si] < 0) total += weight[si];
    const double threshold = total / (8.0 * std::max(nthreads, 1));

    // select maximal subtrees below the threshold: walk the supernode
    // tree top-down; a subtree that fits becomes a task (its supernodes
    // are exactly [first_sid, si])
    std::vector<std::pair<int64_t, int64_t>> tasks;   // [begin, end) sid
    std::vector<char> in_task(ns, 0);
    if (nthreads > 1 && ns > 4) {
        std::vector<std::vector<int64_t>> kids(ns);
        std::vector<int64_t> sroots;
        for (int64_t si = 0; si < ns; ++si) {
            if (sparent[si] >= 0) kids[sparent[si]].push_back(si);
            else sroots.push_back(si);
        }
        std::vector<int64_t> dfs(sroots.rbegin(), sroots.rend());
        while (!dfs.empty()) {
            int64_t si = dfs.back();
            dfs.pop_back();
            if (weight[si] <= threshold || kids[si].empty()) {
                tasks.emplace_back(first_sid[si], si + 1);
                for (int64_t q = first_sid[si]; q <= si; ++q) in_task[q] = 1;
            } else {
                for (int64_t c : kids[si]) dfs.push_back(c);
            }
        }
        std::sort(tasks.begin(), tasks.end());
    }

    std::vector<std::vector<Update<T>>> task_out(tasks.size());
    std::vector<int64_t> task_status(tasks.size(), 0);
    std::vector<FactCounters> task_cnt(tasks.size());

    if (!tasks.empty()) {
        if (g_blas_set_threads) g_blas_set_threads(1);
#ifdef _OPENMP
#pragma omp parallel num_threads(nthreads)
        {
            std::vector<int64_t> loc(n, -1);
#pragma omp for schedule(dynamic, 1)
            for (int64_t t = 0; t < (int64_t)tasks.size(); ++t) {
                std::vector<Update<T>> stack;
                for (int64_t si = tasks[t].first; si < tasks[t].second;
                     ++si) {
                    int64_t st = process_snode(
                        h, h->snodes[si], stack, loc, piv_floor, amax,
                        pivot_rel_eps, task_cnt[t]);
                    if (st != 0) { task_status[t] = st; break; }
                }
                task_out[t] = std::move(stack);
            }
        }
#else
        {
            std::vector<int64_t> loc(n, -1);
            for (int64_t t = 0; t < (int64_t)tasks.size(); ++t) {
                std::vector<Update<T>> stack;
                for (int64_t si = tasks[t].first; si < tasks[t].second;
                     ++si) {
                    int64_t st = process_snode(
                        h, h->snodes[si], stack, loc, piv_floor, amax,
                        pivot_rel_eps, task_cnt[t]);
                    if (st != 0) { task_status[t] = st; break; }
                }
                task_out[t] = std::move(stack);
            }
        }
#endif
        if (g_blas_set_threads) {
            int ncpu = (int)sysconf(_SC_NPROCESSORS_ONLN);
            g_blas_set_threads(ncpu > 0 ? ncpu : 1);
        }
        for (int64_t st : task_status)
            if (st != 0) return st;
    }

    // sequential top-of-tree pass; seed the stack with the tasks' pending
    // updates at their postorder positions
    FactCounters cnt;
    std::vector<Update<T>> stack;
    std::vector<int64_t> loc(n, -1);
    size_t next_task = 0;
    for (int64_t si = 0; si < ns;) {
        if (next_task < tasks.size() && tasks[next_task].first == si) {
            for (auto& u : task_out[next_task])
                stack.push_back(std::move(u));
            si = tasks[next_task].second;
            ++next_task;
            continue;
        }
        int64_t st = process_snode(h, h->snodes[si], stack, loc, piv_floor,
                                   amax, pivot_rel_eps, cnt);
        if (st != 0) return st;
        ++si;
    }
    for (const auto& c : task_cnt) {
        cnt.n_neg += c.n_neg;
        cnt.n_pos += c.n_pos;
        cnt.n_zero += c.n_zero;
        cnt.n_perturbed += c.n_perturbed;
        cnt.factor_nnz += c.factor_nnz;
    }
    h->n_neg = cnt.n_neg;
    h->n_pos = cnt.n_pos;
    h->n_zero = cnt.n_zero;
    h->n_perturbed = cnt.n_perturbed;
    h->factor_nnz = cnt.factor_nnz;
    h->factorized = true;
    return 0;
}

// Solve sweeps over a contiguous slab of right-hand-side columns
// (y + n*rr0, nrhs columns).  Column slabs are independent, so
// mf_solve parallelizes over them with one task per thread.
template <typename T>
void mf_solve_slab(MfHandle<T>* h, int64_t nrhs, T* y) {
    const int64_t n = h->n;
    const char CT[2] = {Blas<T>::CT, 0};
    std::vector<T> t1, t2;
    int nr = (int)nrhs;
    // forward: L z = y  (gather y1 column-major, trsm, scatter; one gemm
    // against the whole RHS block per supernode)
    for (auto& s : h->snodes) {
        int64_t w = s.c1 - s.c0, r = (int64_t)s.rows.size();
        t1.assign((size_t)w * nrhs, T(0));
        for (int64_t rr = 0; rr < nrhs; ++rr)
            for (int64_t j = 0; j < w; ++j)
                t1[(size_t)rr * w + j] = y[(size_t)rr * n + s.c0 + j];
        if (w > 1) {
            int m_i = (int)w, w_i = (int)w;
            T one = T(1);
            Blas<T>::trsm("L", "L", "N", "U", &m_i, &nr, &one, s.L11.data(),
                          &w_i, t1.data(), &m_i);
        }
        for (int64_t rr = 0; rr < nrhs; ++rr)
            for (int64_t j = 0; j < w; ++j)
                y[(size_t)rr * n + s.c0 + j] = t1[(size_t)rr * w + j];
        if (r > 0 && w > 0) {
            t2.assign((size_t)r * nrhs, T(0));
            int m_i = (int)r, k_i = (int)w, ldb = (int)w, ldc = (int)r;
            int lda = (int)r;
            T one = T(1), zero = T(0);
            Blas<T>::gemm("N", "N", &m_i, &nr, &k_i, &one, s.L21.data(),
                          &lda, t1.data(), &ldb, &zero, t2.data(), &ldc);
            for (int64_t rr = 0; rr < nrhs; ++rr)
                for (int64_t i = 0; i < r; ++i)
                    y[(size_t)rr * n + s.rows[i]]
                        -= t2[(size_t)rr * r + i];
        }
    }
    // diagonal (real also in the Hermitian case)
    for (auto& s : h->snodes) {
        int64_t w = s.c1 - s.c0;
        for (int64_t j = 0; j < w; ++j) {
            double inv = 1.0 / s.D[j];
            for (int64_t rr = 0; rr < nrhs; ++rr)
                y[(size_t)rr * n + s.c0 + j] *= inv;
        }
    }
    // backward: L^H x = z (reverse supernode order)
    for (auto it = h->snodes.rbegin(); it != h->snodes.rend(); ++it) {
        auto& s = *it;
        int64_t w = s.c1 - s.c0, r = (int64_t)s.rows.size();
        t1.assign((size_t)w * nrhs, T(0));
        for (int64_t rr = 0; rr < nrhs; ++rr)
            for (int64_t j = 0; j < w; ++j)
                t1[(size_t)rr * w + j] = y[(size_t)rr * n + s.c0 + j];
        if (r > 0 && w > 0) {
            // y1 -= L21^H * y(rows)
            t2.assign((size_t)r * nrhs, T(0));
            for (int64_t rr = 0; rr < nrhs; ++rr)
                for (int64_t i = 0; i < r; ++i)
                    t2[(size_t)rr * r + i] = y[(size_t)rr * n + s.rows[i]];
            int m_i = (int)w, k_i = (int)r, lda = (int)r, ldb = (int)r;
            int ldc = (int)w;
            T mone = T(-1), one = T(1);
            Blas<T>::gemm(CT, "N", &m_i, &nr, &k_i, &mone, s.L21.data(),
                          &lda, t2.data(), &ldb, &one, t1.data(), &ldc);
        }
        // L11^H solve
        if (w > 1) {
            int m_i = (int)w, w_i = (int)w;
            T one = T(1);
            Blas<T>::trsm("L", "L", CT, "U", &m_i, &nr, &one, s.L11.data(),
                          &w_i, t1.data(), &m_i);
        }
        for (int64_t rr = 0; rr < nrhs; ++rr)
            for (int64_t j = 0; j < w; ++j)
                y[(size_t)rr * n + s.c0 + j] = t1[(size_t)rr * w + j];
    }
}

// Solve (P^T L D L^H P) X = B where P is the internal postorder; b/x are
// RHS-contiguous (n rows x nrhs) in the caller's (pre-postorder) labels.
// Parallelized over RHS column slabs: each thread runs the full
// supernodal sweeps on its own contiguous slice of y (no shared writes),
// with single-threaded BLAS inside the tasks.
template <typename T>
void mf_solve(MfHandle<T>* h, int64_t nrhs, const T* b, T* x) {
    const int64_t n = h->n;
    // y (column-major n x nrhs) in postorder labels
    std::vector<T> y((size_t)n * nrhs);
    for (int64_t i = 0; i < n; ++i) {
        int64_t ip = h->post[i];
        for (int64_t rr = 0; rr < nrhs; ++rr)
            y[(size_t)rr * n + ip] = b[(size_t)i * nrhs + rr];
    }
    int nthreads = 1;
#ifdef _OPENMP
    nthreads = std::min(std::min(omp_get_max_threads(),
                                 omp_get_num_procs()), 8);
    nthreads = (int)std::min<int64_t>(nthreads, nrhs);
#endif
    if (nthreads > 1) {
        if (g_blas_set_threads) g_blas_set_threads(1);
#ifdef _OPENMP
        int64_t chunk = (nrhs + nthreads - 1) / nthreads;
#pragma omp parallel for num_threads(nthreads) schedule(static, 1)
        for (int64_t c = 0; c < nthreads; ++c) {
            int64_t rr0 = c * chunk;
            int64_t nrr = std::min<int64_t>(chunk, nrhs - rr0);
            if (nrr > 0)
                mf_solve_slab(h, nrr, y.data() + (size_t)rr0 * n);
        }
#endif
        if (g_blas_set_threads) {
            int ncpu = (int)sysconf(_SC_NPROCESSORS_ONLN);
            g_blas_set_threads(ncpu > 0 ? ncpu : 1);
        }
    } else {
        mf_solve_slab(h, nrhs, y.data());
    }
    for (int64_t i = 0; i < n; ++i) {
        int64_t ip = h->post[i];
        for (int64_t rr = 0; rr < nrhs; ++rr)
            x[(size_t)i * nrhs + rr] = y[(size_t)rr * n + ip];
    }
}

}  // namespace

extern "C" {

int64_t ldltmf_set_blas(const char* path, const char* prefix) {
    void* h = dlopen(path, RTLD_NOW | RTLD_LOCAL);
    if (!h) return -1;
    std::string pre = prefix ? prefix : "";
    g_dgemm = (dgemm_t)dlsym(h, (pre + "dgemm_").c_str());
    g_dtrsm = (dtrsm_t)dlsym(h, (pre + "dtrsm_").c_str());
    if (!g_dgemm || !g_dtrsm) {
        g_dgemm = nullptr;
        g_dtrsm = nullptr;
        return -2;
    }
    // complex BLAS3 is optional: the Hermitian engine falls back to the
    // naive kernels if absent
    g_zgemm = (zgemm_t)dlsym(h, (pre + "zgemm_").c_str());
    g_ztrsm = (ztrsm_t)dlsym(h, (pre + "ztrsm_").c_str());
    if (!g_zgemm || !g_ztrsm) {
        g_zgemm = nullptr;
        g_ztrsm = nullptr;
    }
    // thread-count control (for the task-parallel subtree phase, where
    // oversubscribing BLAS threads on top of OpenMP tasks would thrash)
    g_blas_set_threads =
        (set_threads_t)dlsym(h, (pre + "openblas_set_num_threads").c_str());
    if (!g_blas_set_threads)
        g_blas_set_threads =
            (set_threads_t)dlsym(h, "openblas_set_num_threads");
    return 0;
}

// -- real symmetric (LDL^T) --------------------------------------------------

void* ldltmf_create(int64_t n, const int64_t* Ap, const int64_t* Ai,
                    const double* Ax) {
    return mf_create<double>(n, Ap, Ai, Ax);
}

void ldltmf_destroy(void* vh) { delete static_cast<MfHandle<double>*>(vh); }

int64_t ldltmf_factorize(void* vh, double pivot_rel_eps) {
    return mf_factorize(static_cast<MfHandle<double>*>(vh), pivot_rel_eps);
}

void ldltmf_solve(void* vh, int64_t nrhs, const double* b, double* x) {
    mf_solve(static_cast<MfHandle<double>*>(vh), nrhs, b, x);
}

void ldltmf_inertia(void* vh, int64_t* neg, int64_t* pos, int64_t* zero) {
    MfHandle<double>* h = static_cast<MfHandle<double>*>(vh);
    *neg = h->n_neg;
    *pos = h->n_pos;
    *zero = h->n_zero;
}

int64_t ldltmf_factor_nnz(void* vh) {
    return static_cast<MfHandle<double>*>(vh)->factor_nnz;
}

int64_t ldltmf_perturbed(void* vh) {
    return static_cast<MfHandle<double>*>(vh)->n_perturbed;
}

// -- complex Hermitian (LDL^H, real D) ---------------------------------------

void* zldltmf_create(int64_t n, const int64_t* Ap, const int64_t* Ai,
                     const double* Ax_interleaved) {
    return mf_create<cplx>(n, Ap, Ai,
                           reinterpret_cast<const cplx*>(Ax_interleaved));
}

void zldltmf_destroy(void* vh) { delete static_cast<MfHandle<cplx>*>(vh); }

int64_t zldltmf_factorize(void* vh, double pivot_rel_eps) {
    return mf_factorize(static_cast<MfHandle<cplx>*>(vh), pivot_rel_eps);
}

void zldltmf_solve(void* vh, int64_t nrhs, const double* b, double* x) {
    mf_solve(static_cast<MfHandle<cplx>*>(vh), nrhs,
             reinterpret_cast<const cplx*>(b), reinterpret_cast<cplx*>(x));
}

void zldltmf_inertia(void* vh, int64_t* neg, int64_t* pos, int64_t* zero) {
    MfHandle<cplx>* h = static_cast<MfHandle<cplx>*>(vh);
    *neg = h->n_neg;
    *pos = h->n_pos;
    *zero = h->n_zero;
}

int64_t zldltmf_factor_nnz(void* vh) {
    return static_cast<MfHandle<cplx>*>(vh)->factor_nnz;
}

int64_t zldltmf_perturbed(void* vh) {
    return static_cast<MfHandle<cplx>*>(vh)->n_perturbed;
}

}  // extern "C"
