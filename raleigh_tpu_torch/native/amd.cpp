// Approximate minimum degree (AMD) fill-reducing ordering.
//
// Native component of the PARDISO-replacement pipeline: MKL's PARDISO does
// its own METIS/MD ordering inside phase 11 (reference
// raleigh/algebra/mkl_wrap.py:411-434); our LDL^T needs an equally strong
// symmetric ordering, and reverse Cuthill-McKee (the SciPy-available
// fallback) leaves an order of magnitude more fill on 3D/FE meshes.
//
// Implementation: quotient-graph minimum degree with approximate external
// degrees (one-pass |Le \ Lp| counters), element absorption, and
// supervariable merging of indistinguishable variables detected by
// adjacency hashing — the standard AMD recipe, written from scratch.
//
// C API: amd_order(n, Ap, Ai, perm) fills perm with the elimination order
// (perm[k] = index of the k-th pivot). Input: symmetric pattern, full or
// triangular (symmetrized internally), 64-bit indices.

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>

namespace {

struct Node {
    std::vector<int64_t> vars;    // variable: remaining A-adjacency;
                                  // element: member variables (L_e)
    std::vector<int64_t> elems;   // adjacent elements (variables only)
    int64_t degree = 0;           // approximate external degree
    int64_t size = 1;             // supervariable weight; 0 = dead
    bool is_element = false;
};

class DegreeLists {
  public:
    explicit DegreeLists(int64_t n)
        : head_(n + 1, -1), next_(n, -1), prev_(n, -1), deg_of_(n, 0),
          inlist_(n, 0), mindeg_(0) {}

    void insert(int64_t v, int64_t d) {
        next_[v] = head_[d];
        prev_[v] = -1;
        if (head_[d] != -1) prev_[head_[d]] = v;
        head_[d] = v;
        deg_of_[v] = d;
        inlist_[v] = 1;
        if (d < mindeg_) mindeg_ = d;
    }
    void remove(int64_t v) {
        if (!inlist_[v]) return;
        int64_t d = deg_of_[v];
        if (prev_[v] != -1) next_[prev_[v]] = next_[v];
        else head_[d] = next_[v];
        if (next_[v] != -1) prev_[next_[v]] = prev_[v];
        next_[v] = prev_[v] = -1;
        inlist_[v] = 0;
    }
    int64_t pop_min() {
        while (mindeg_ < (int64_t)head_.size() - 1 && head_[mindeg_] == -1)
            ++mindeg_;
        int64_t v = head_[mindeg_];
        if (v != -1) remove(v);
        return v;
    }

  private:
    std::vector<int64_t> head_, next_, prev_, deg_of_;
    std::vector<char> inlist_;
    int64_t mindeg_;
};

}  // namespace

extern "C" int64_t amd_order(int64_t n, const int64_t* Ap, const int64_t* Ai,
                             int64_t* perm) {
    if (n <= 0) return 0;
    // symmetrized pattern without the diagonal
    std::vector<std::vector<int64_t>> adj(n);
    for (int64_t j = 0; j < n; ++j)
        for (int64_t p = Ap[j]; p < Ap[j + 1]; ++p) {
            int64_t i = Ai[p];
            if (i == j || i < 0 || i >= n) continue;
            adj[i].push_back(j);
            adj[j].push_back(i);
        }
    std::vector<Node> nodes(n);
    for (int64_t i = 0; i < n; ++i) {
        auto& a = adj[i];
        std::sort(a.begin(), a.end());
        a.erase(std::unique(a.begin(), a.end()), a.end());
        nodes[i].vars = std::move(a);
        nodes[i].degree = (int64_t)nodes[i].vars.size();
    }
    adj.clear();
    adj.shrink_to_fit();

    DegreeLists dl(n);
    for (int64_t i = 0; i < n; ++i) dl.insert(i, nodes[i].degree);

    std::vector<int64_t> w(n, -1);           // per-pass |Le \ Lp| counters
    std::vector<int64_t> mark(n, 0);
    int64_t mark_tag = 0;
    std::vector<int64_t> merged_into(n, -1); // supervariable forest
    std::vector<int64_t> order_of(n, -1);    // position of each pivot rep
    std::vector<int64_t> lp;
    int64_t nordered = 0;

    while (nordered < n) {
        int64_t p = dl.pop_min();
        if (p < 0) break;
        Node& np = nodes[p];
        if (np.size <= 0 || np.is_element) continue;

        // ---- form element Lp ----------------------------------------
        ++mark_tag;
        mark[p] = mark_tag;
        lp.clear();
        for (int64_t v : np.vars) {
            Node& nv = nodes[v];
            if (nv.size > 0 && !nv.is_element && mark[v] != mark_tag) {
                mark[v] = mark_tag;
                lp.push_back(v);
            }
        }
        for (int64_t e : np.elems) {
            Node& ne = nodes[e];
            if (!ne.is_element) continue;
            for (int64_t v : ne.vars) {
                Node& nv = nodes[v];
                if (nv.size > 0 && !nv.is_element && mark[v] != mark_tag) {
                    mark[v] = mark_tag;
                    lp.push_back(v);
                }
            }
            ne.vars.clear();             // absorbed
            ne.vars.shrink_to_fit();
        }

        order_of[p] = nordered;
        nordered += np.size;

        np.is_element = true;
        np.vars.assign(lp.begin(), lp.end());
        np.elems.clear();
        if (lp.empty()) continue;
        int64_t lp_weight = 0;
        for (int64_t v : lp) lp_weight += nodes[v].size;

        // ---- one-pass |Le \ Lp| counters ----------------------------
        for (int64_t v : lp) {
            for (int64_t e : nodes[v].elems) {
                Node& ne = nodes[e];
                if (!ne.is_element || ne.vars.empty() || e == p) continue;
                if (w[e] < 0) {
                    int64_t we = 0;
                    for (int64_t u : ne.vars)
                        if (nodes[u].size > 0 && !nodes[u].is_element)
                            we += nodes[u].size;
                    w[e] = we;
                }
                w[e] -= nodes[v].size;
            }
        }

        // ---- update variables in Lp ---------------------------------
        for (int64_t v : lp) {
            Node& nv = nodes[v];
            int64_t ext_a = 0;
            {
                auto& a = nv.vars;
                int64_t out = 0;
                for (int64_t u : a) {
                    Node& nu = nodes[u];
                    if (nu.size <= 0 || nu.is_element || u == p
                        || mark[u] == mark_tag)
                        continue;
                    a[out++] = u;
                    ext_a += nu.size;
                }
                a.resize(out);
            }
            int64_t ext_e = 0;
            {
                auto& el = nv.elems;
                int64_t out = 0;
                for (int64_t e : el) {
                    Node& ne = nodes[e];
                    if (!ne.is_element || ne.vars.empty() || e == p)
                        continue;
                    int64_t we = w[e];
                    if (we <= 0) {       // element inside Lp: absorb
                        ne.vars.clear();
                        continue;
                    }
                    ext_e += we;
                    el[out++] = e;
                }
                el.resize(out);
                el.push_back(p);
                std::sort(el.begin(), el.end());
            }
            int64_t d = ext_a + ext_e + (lp_weight - nv.size);
            d = std::min(d, n - nordered);
            if (d < 0) d = 0;
            nv.degree = d;
        }

        // reset counters
        for (int64_t v : lp)
            for (int64_t e : nodes[v].elems) w[e] = -1;

        // ---- supervariable merging via adjacency hashing ------------
        {
            std::vector<std::pair<uint64_t, int64_t>> hashes;
            hashes.reserve(lp.size());
            for (int64_t v : lp) {
                Node& nv = nodes[v];
                if (nv.size <= 0) continue;
                uint64_t hv = 1469598103934665603ull;
                for (int64_t u : nv.vars)
                    hv += (uint64_t)(u + 1) * 2654435761u;
                for (int64_t e : nv.elems)
                    hv ^= (uint64_t)(e + 1) * 1099511628211ull;
                hashes.emplace_back(hv, v);
            }
            std::sort(hashes.begin(), hashes.end());
            for (size_t i = 0; i + 1 < hashes.size();) {
                size_t j = i + 1;
                while (j < hashes.size()
                       && hashes[j].first == hashes[i].first)
                    ++j;
                if (j - i > 1) {
                    for (size_t s = i; s < j; ++s) {
                        int64_t v0 = hashes[s].second;
                        if (nodes[v0].size <= 0) continue;
                        for (size_t t = s + 1; t < j; ++t) {
                            int64_t v1 = hashes[t].second;
                            if (nodes[v1].size <= 0) continue;
                            if (nodes[v0].vars == nodes[v1].vars
                                && nodes[v0].elems == nodes[v1].elems) {
                                nodes[v0].size += nodes[v1].size;
                                nodes[v1].size = 0;
                                nodes[v1].vars.clear();
                                nodes[v1].elems.clear();
                                merged_into[v1] = v0;
                                dl.remove(v1);
                            }
                        }
                    }
                }
                i = j;
            }
        }

        // re-bucket updated variables
        for (int64_t v : lp) {
            if (nodes[v].size <= 0) continue;
            dl.remove(v);
            dl.insert(v, nodes[v].degree);
        }
    }

    // ---- expand supervariables into the final permutation -----------
    std::vector<std::vector<int64_t>> members(n);
    for (int64_t i = 0; i < n; ++i) {
        if (merged_into[i] >= 0) {
            int64_t r = merged_into[i];
            while (merged_into[r] >= 0) r = merged_into[r];
            members[r].push_back(i);
        }
    }
    std::vector<std::pair<int64_t, int64_t>> reps;
    reps.reserve(n);
    for (int64_t i = 0; i < n; ++i)
        if (order_of[i] >= 0 && merged_into[i] < 0)
            reps.emplace_back(order_of[i], i);
    std::sort(reps.begin(), reps.end());
    std::vector<int64_t> out;
    out.reserve(n);
    for (auto& pr : reps) {
        out.push_back(pr.second);
        for (int64_t m : members[pr.second]) out.push_back(m);
    }
    std::vector<char> seen(n, 0);
    for (int64_t v : out) seen[v] = 1;
    for (int64_t i = 0; i < n; ++i)
        if (!seen[i]) out.push_back(i);
    for (int64_t i = 0; i < n; ++i) perm[i] = out[i];
    return 0;
}
