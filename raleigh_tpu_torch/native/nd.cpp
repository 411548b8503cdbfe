// Multilevel nested-dissection fill-reducing ordering.
//
// Second fill-reducing engine of the PARDISO-replacement pipeline
// (reference raleigh/algebra/mkl_wrap.py:411-434 relies on PARDISO's
// internal METIS nested dissection): recursive bisection by vertex
// separators found with the multilevel scheme METIS made standard —
// coarsen by heavy-edge matching, find a level-set separator on the
// coarsest graph, then uncoarsen with weighted Fiduccia-Mattheyses
// vertex-separator refinement at every level.  Leaf subgraphs and the
// separators themselves are ordered with minimum degree (amd.cpp).  On
// 3D FE meshes nested dissection asymptotically beats pure minimum
// degree on fill; the Python layer counts symbolic fill for both
// orderings (symbolic_lnz below) and keeps the better one.
//
// C API:
//   nd_order(n, Ap, Ai, perm)      perm[k] = index of the k-th pivot
//   symbolic_lnz(n, Ap, Ai, perm)  exact LDL^T factor nnz under perm
// Input: symmetric pattern, full or triangular (symmetrized internally),
// 64-bit indices.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <vector>
#include <queue>
#include <tuple>
#include <algorithm>

extern "C" int64_t amd_order(int64_t n, const int64_t* Ap, const int64_t* Ai,
                             int64_t* perm);

namespace {

struct Ctx {
    int64_t n = 0;
    uint64_t salt0 = 0;               // global attempt salt
    int64_t leaf = 160;                // MD-takeover subgraph size
                                       // (reset from nd_leaf_size())
    std::vector<int64_t> xadj, adjv;   // symmetric adjacency, no diagonal
    std::vector<int64_t> vwt;          // vertex weights (empty = unit)
    std::vector<int64_t> tag;          // vertex -> active subgraph tag
    std::vector<int64_t> seen;         // BFS visit stamps
    std::vector<int64_t> lev;          // BFS levels
    std::vector<int64_t> loc;          // vertex -> local index scratch
    std::vector<int64_t> out;          // out[pos] = vertex
    int64_t next_pos = 0;
    int64_t next_tag = 1;
    int64_t epoch = 0;
    // reusable leaf-extraction buffers
    std::vector<int64_t> lAp, lAi, lperm;
};

static int nd_stats_level() {
    static int lvl = -2;
    if (lvl == -2) {
        const char* e = std::getenv("RALEIGH_ND_STATS");
        lvl = e ? std::atoi(e) : -1;
    }
    return lvl;
}

// tuning knobs (env-overridable for experiments; defaults are the
// measured-best values on the FE flagship + lap3d sweeps)
static int64_t nd_env(const char* name, int64_t dflt) {
    const char* e = std::getenv(name);
    return e ? std::atoll(e) : dflt;
}

static int64_t nd_leaf_size() {
    static int64_t v = nd_env("RALEIGH_ND_LEAF", 160);
    return v;
}

static int64_t nd_coarse_size() {
    static int64_t v = nd_env("RALEIGH_ND_COARSE", 160);
    return v;
}

// per-candidate smoothing depth: the salted ordering competition runs
// several ND candidates concurrently (ldlt.py best_ordering), and
// varying the Fiedler smoothing depth between them diversifies the
// portfolio beyond tie-break reseeding alone (measured: different
// depths win on different graphs)
thread_local int64_t g_smooth_extra = 0;

static int64_t nd_smooth_iters() {
    static int64_t v = nd_env("RALEIGH_ND_SMOOTH", 5);
    return v + g_smooth_extra;
}

uint64_t splitmix64(uint64_t x) {
    x += 0x9e3779b97f4a7c15ULL;
    x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
    x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
    return x ^ (x >> 31);
}

// breadth-first levels within the subgraph identified by ``t`` starting
// from ``root``; returns the visited vertices in BFS order and fills
// c.lev (c.seen stamps with the current epoch)
int64_t bfs(Ctx& c, int64_t root, int64_t t, std::vector<int64_t>& order) {
    order.clear();
    ++c.epoch;
    c.seen[root] = c.epoch;
    c.lev[root] = 0;
    order.push_back(root);
    int64_t maxlev = 0;
    for (size_t q = 0; q < order.size(); ++q) {
        int64_t v = order[q];
        for (int64_t p = c.xadj[v]; p < c.xadj[v + 1]; ++p) {
            int64_t w = c.adjv[p];
            if (c.tag[w] != t || c.seen[w] == c.epoch) continue;
            c.seen[w] = c.epoch;
            c.lev[w] = c.lev[v] + 1;
            maxlev = std::max(maxlev, c.lev[w]);
            order.push_back(w);
        }
    }
    return maxlev;
}

// order a subgraph with minimum degree on its induced pattern.  The
// leaf's coupling to vertices eliminated LATER (its boundary
// separators) is represented by one aggregated ghost vertex adjacent
// to every boundary-touching leaf vertex: plain local AMD would
// eliminate high-external-degree vertices early (their external fill
// is invisible to it); with the ghost their degree reflects the
// boundary coupling and they drift toward the end of the leaf order —
// a one-vertex approximation of constrained minimum degree.
void order_leaf(Ctx& c, const std::vector<int64_t>& S, int64_t t) {
    const int64_t m = (int64_t)S.size();
    if (m == 0) return;
    if (m == 1) {
        c.out[c.next_pos++] = S[0];
        return;
    }
    for (int64_t i = 0; i < m; ++i) c.loc[S[i]] = i;
    std::vector<int8_t> bnd(m, 0);
    bool any_bnd = false;
    for (int64_t i = 0; i < m; ++i) {
        int64_t v = S[i];
        for (int64_t p = c.xadj[v]; p < c.xadj[v + 1]; ++p)
            if (c.tag[c.adjv[p]] != t) {
                bnd[i] = 1;
                any_bnd = true;
                break;
            }
    }
    const bool ghost = any_bnd && m > 8;
    c.lAp.assign(m + 1 + (ghost ? 1 : 0), 0);
    c.lAi.clear();
    for (int64_t i = 0; i < m; ++i) {
        int64_t v = S[i];
        for (int64_t p = c.xadj[v]; p < c.xadj[v + 1]; ++p) {
            int64_t w = c.adjv[p];
            if (c.tag[w] == t) c.lAi.push_back(c.loc[w]);
        }
        if (ghost && bnd[i]) c.lAi.push_back(m);
        c.lAp[i + 1] = (int64_t)c.lAi.size();
    }
    if (ghost) {
        for (int64_t i = 0; i < m; ++i)
            if (bnd[i]) c.lAi.push_back(i);
        c.lAp[m + 1] = (int64_t)c.lAi.size();
    }
    const int64_t mq = m + (ghost ? 1 : 0);
    c.lperm.assign(mq, 0);
    amd_order(mq, c.lAp.data(), c.lAi.data(), c.lperm.data());
    for (int64_t k = 0; k < mq; ++k) {
        int64_t j = c.lperm[k];
        if (j < m) c.out[c.next_pos++] = S[j];
    }
}

// ---------------------------------------------------------------------
// Multilevel vertex-separator machinery.  Works on a compact local graph
// with vertex weights (= number of original vertices a multilevel or
// supervariable vertex represents) and edge weights (= number of fine
// edges a coarse edge aggregates, used to steer heavy-edge matching).
// ---------------------------------------------------------------------

const int8_t SA = 0, SB = 1, SS = 2;

// Balance floor for bisections: each side must keep at least
// BAL_NUM/BAL_DEN of the subgraph weight.  Tuned on the FE flagship +
// lap3d sweeps: a loose floor (1/4) lets FM settle into small-but-
// lopsided corner cuts whose big side re-cuts all the way down, while
// a tight floor (2/5) forbids the thin-waist cuts that minimize fill
// on plate/shell structures (the best waists sit at ~1/3-2/5) — 3/10
// admits the waists while still blocking corner-cut drift.
const int64_t BAL_NUM = 3, BAL_DEN = 10;

// per-candidate floor override (0 = use BAL_NUM/BAL_DEN): diversifies
// the salted ordering portfolio — different structures favor different
// imbalance allowances
thread_local int64_t g_bal_num = 0, g_bal_den = 1;

inline int64_t bal_floor(int64_t totw) {
    if (g_bal_num)
        return std::max<int64_t>(1, (g_bal_num * totw) / g_bal_den);
    return std::max<int64_t>(1, (BAL_NUM * totw) / BAL_DEN);
}

struct WG {
    int64_t nv = 0;
    int64_t totw = 0;
    std::vector<int64_t> xadj, adj, ewt, vwt;
};

// Weighted Fiduccia-Mattheyses refinement of a vertex separator.  Moves
// separator vertices into A or B (pulling the opposite side's neighbors
// into the separator to keep it a separator), accepting negative-gain
// moves and rolling back to the best state seen.  Invariant maintained
// throughout: no edge joins A and B.  All sizes are vertex-weighted so
// refinement on coarse graphs optimizes the true (fine) separator size.
void fm_refine_w(const WG& g, std::vector<int8_t>& side) {
    const int64_t nv = g.nv;
    if (nv < 4) return;
    int64_t wa = 0, wb = 0, ws = 0, nsep0 = 0;
    for (int64_t v = 0; v < nv; ++v) {
        if (side[v] == SA) wa += g.vwt[v];
        else if (side[v] == SB) wb += g.vwt[v];
        else { ws += g.vwt[v]; ++nsep0; }
    }
    if (nsep0 == 0) return;
    // balance floor — unless the incoming cut is already more lopsided,
    // in which case hold the line at its current smaller side (keeps
    // refinement feasible while forbidding further drift; imbalance
    // compounding through the uncoarsening hierarchy was the round-1
    // quality regression)
    const int64_t min_part = std::max<int64_t>(
        1, std::min(bal_floor(g.totw), std::min(wa, wb)));

    // moving v (side SS) toward ``to`` pulls its opposite-side neighbors
    // into the separator: gain in separator weight = vwt[v] - pulled wt
    auto gain = [&](int64_t v, int8_t to) -> int64_t {
        int8_t other = (to == SA) ? SB : SA;
        int64_t pulls = 0;
        for (int64_t p = g.xadj[v]; p < g.xadj[v + 1]; ++p) {
            int64_t w = g.adj[p];
            if (side[w] == other) pulls += g.vwt[w];
        }
        return g.vwt[v] - pulls;
    };

    struct Rec {
        int64_t v;
        int8_t to;
        int64_t pull_begin, pull_end;
    };
    std::vector<Rec> log;
    std::vector<int64_t> pulled;
    std::vector<int64_t> locked(nv, -1);
    int64_t epoch = 0;
    bool improved_any = true;
    for (int pass = 0; pass < 10 && improved_any; ++pass) {
        improved_any = false;
        ++epoch;
        log.clear();
        pulled.clear();
        std::priority_queue<std::tuple<int64_t, int64_t, int8_t>> heap;
        int64_t nsep = 0;
        for (int64_t v = 0; v < nv; ++v)
            if (side[v] == SS) {
                ++nsep;
                heap.emplace(gain(v, SA), v, SA);
                heap.emplace(gain(v, SB), v, SB);
            }
        int64_t best_ws = ws, best_bal = std::max(wa, wb);
        size_t best_len = 0;
        int64_t budget = 2 * nsep + 64 + nv / 8;
        while (!heap.empty() && budget > 0) {
            auto [gn, v, to] = heap.top();
            heap.pop();
            if (side[v] != SS || locked[v] == epoch) continue;
            int64_t g2 = gain(v, to);
            if (g2 != gn) {                     // stale entry: refresh
                heap.emplace(g2, v, to);
                continue;
            }
            int64_t pullw = g.vwt[v] - gn;
            int64_t wa2 = (to == SA) ? wa + g.vwt[v] : wa - pullw;
            int64_t wb2 = (to == SA) ? wb - pullw : wb + g.vwt[v];
            if (std::min(wa2, wb2) < min_part) continue;
            // apply the move
            --budget;
            Rec r{v, to, (int64_t)pulled.size(), 0};
            int8_t other = (to == SA) ? SB : SA;
            side[v] = to;
            locked[v] = epoch;
            for (int64_t p = g.xadj[v]; p < g.xadj[v + 1]; ++p) {
                int64_t w = g.adj[p];
                if (side[w] != other) continue;
                side[w] = SS;
                pulled.push_back(w);
                if (locked[w] != epoch) {
                    heap.emplace(gain(w, SA), w, SA);
                    heap.emplace(gain(w, SB), w, SB);
                }
            }
            r.pull_end = (int64_t)pulled.size();
            log.push_back(r);
            wa = wa2;
            wb = wb2;
            ws -= gn;
            if (ws < best_ws
                || (ws == best_ws && std::max(wa, wb) < best_bal)) {
                if (ws < best_ws) improved_any = true;
                best_ws = ws;
                best_bal = std::max(wa, wb);
                best_len = log.size();
            }
        }
        // roll back past the best point (reverse order restores exactly)
        while (log.size() > best_len) {
            const Rec& r = log.back();
            int8_t other = (r.to == SA) ? SB : SA;
            int64_t pullw = 0;
            for (int64_t q = r.pull_end - 1; q >= r.pull_begin; --q) {
                side[pulled[q]] = other;
                pullw += g.vwt[pulled[q]];
            }
            side[r.v] = SS;
            if (r.to == SA) { wa -= g.vwt[r.v]; wb += pullw; }
            else { wb -= g.vwt[r.v]; wa += pullw; }
            ws += g.vwt[r.v] - pullw;
            pulled.resize(r.pull_begin);
            log.pop_back();
        }
    }
}

std::pair<int64_t, int64_t> cut_cost(const WG& g,
                                     const std::vector<int8_t>& side);

// helpers shared by the initial-cut constructions -----------------------

// make an A/B assignment a vertex separator: for each crossing edge pull
// the B endpoint into S (one-sided cover; FM thins it afterwards).
// ``pull_a`` selects which side donates its boundary.
void cover_from_cut(const WG& g, std::vector<int8_t>& side, bool pull_a) {
    int8_t from = pull_a ? SA : SB, other = pull_a ? SB : SA;
    for (int64_t v = 0; v < g.nv; ++v) {
        if (side[v] != from) continue;
        for (int64_t p = g.xadj[v]; p < g.xadj[v + 1]; ++p)
            if (side[g.adj[p]] == other) { side[v] = SS; break; }
    }
}

// Minimum-vertex-cover separator from an A/B edge cut (König): max
// bipartite matching on the crossing edges via augmenting paths, then
// the cover = (unreached A-boundary) + (reached B-boundary) becomes S.
// Thinner than either one-sided boundary whenever the cut zig-zags —
// the separator FM then starts from a strictly better state.
void min_cover_sep(const WG& g, std::vector<int8_t>& side) {
    const int64_t nv = g.nv;
    // collect boundary vertices of each side and the crossing edges
    std::vector<int64_t> xa, xb, ida(nv, -1), idb(nv, -1);
    for (int64_t v = 0; v < nv; ++v) {
        if (side[v] != SA) continue;
        for (int64_t p = g.xadj[v]; p < g.xadj[v + 1]; ++p)
            if (side[g.adj[p]] == SB) {
                ida[v] = (int64_t)xa.size();
                xa.push_back(v);
                break;
            }
    }
    if (xa.empty()) return;
    std::vector<std::vector<int64_t>> adj(xa.size());
    for (size_t i = 0; i < xa.size(); ++i) {
        int64_t v = xa[i];
        for (int64_t p = g.xadj[v]; p < g.xadj[v + 1]; ++p) {
            int64_t w = g.adj[p];
            if (side[w] != SB) continue;
            if (idb[w] < 0) {
                idb[w] = (int64_t)xb.size();
                xb.push_back(w);
            }
            adj[i].push_back(idb[w]);
        }
    }
    const int64_t na = (int64_t)xa.size(), nb = (int64_t)xb.size();
    std::vector<int64_t> mate_a(na, -1), mate_b(nb, -1), seen(nb, -1);
    // simple augmenting-path matching (Kuhn); boundary graphs are
    // sparse and shallow, so this stays fast at coarse sizes
    std::vector<int64_t> stack, parent_b(nb);
    for (int64_t s = 0; s < na; ++s) {
        // iterative DFS over alternating paths from s
        bool found = false;
        stack.clear();
        stack.push_back(s);
        std::vector<int64_t> frontier{s};
        // recursive lambda flattened: classic Kuhn with recursion is
        // fine at these depths
        std::vector<std::pair<int64_t, size_t>> st;   // (a vertex, edge i)
        st.emplace_back(s, 0);
        while (!st.empty() && !found) {
            auto& [a, ei] = st.back();
            if (ei >= adj[a].size()) {
                st.pop_back();
                continue;
            }
            int64_t b = adj[a][ei++];
            if (seen[b] == s) continue;
            seen[b] = s;
            parent_b[b] = a;
            if (mate_b[b] < 0) {
                // augment along parents
                int64_t bb = b;
                while (true) {
                    int64_t aa = parent_b[bb];
                    int64_t prev = mate_a[aa];
                    mate_a[aa] = bb;
                    mate_b[bb] = aa;
                    if (prev < 0) break;
                    bb = prev;
                }
                found = true;
            } else {
                st.emplace_back(mate_b[b], 0);
            }
        }
    }
    // König: alternating BFS from unmatched A vertices
    std::vector<int8_t> ra(na, 0), rb(nb, 0);
    std::vector<int64_t> q;
    for (int64_t i = 0; i < na; ++i)
        if (mate_a[i] < 0) {
            ra[i] = 1;
            q.push_back(i);
        }
    while (!q.empty()) {
        int64_t a = q.back();
        q.pop_back();
        for (int64_t b : adj[a]) {
            if (rb[b]) continue;
            rb[b] = 1;
            int64_t a2 = mate_b[b];
            if (a2 >= 0 && !ra[a2]) {
                ra[a2] = 1;
                q.push_back(a2);
            }
        }
    }
    for (int64_t i = 0; i < na; ++i)
        if (!ra[i]) side[xa[i]] = SS;         // A-side cover members
    for (int64_t j = 0; j < nb; ++j)
        if (rb[j]) side[xb[j]] = SS;          // B-side cover members
}

bool valid_sides(const WG& g, const std::vector<int8_t>& side) {
    bool has_a = false, has_b = false;
    for (int64_t v = 0; v < g.nv; ++v) {
        has_a |= (side[v] == SA);
        has_b |= (side[v] == SB);
    }
    return has_a && has_b;
}

// BFS level-cut separator from ``root`` (pseudo-peripheral pass inside);
// returns false when the graph is disconnected from root or too small.
bool init_level_cut(const WG& g, std::vector<int8_t>& side, int64_t root) {
    const int64_t nv = g.nv;
    if (nv < 4) return false;
    std::vector<int64_t> lev(nv, -1), order;
    order.reserve(nv);
    auto run_bfs = [&](int64_t r) -> int64_t {
        std::fill(lev.begin(), lev.end(), -1);
        order.clear();
        lev[r] = 0;
        order.push_back(r);
        int64_t maxlev = 0;
        for (size_t q = 0; q < order.size(); ++q) {
            int64_t v = order[q];
            for (int64_t p = g.xadj[v]; p < g.xadj[v + 1]; ++p) {
                int64_t w = g.adj[p];
                if (lev[w] >= 0) continue;
                lev[w] = lev[v] + 1;
                maxlev = std::max(maxlev, lev[w]);
                order.push_back(w);
            }
        }
        return maxlev;
    };
    run_bfs(root % nv);
    if ((int64_t)order.size() < nv) return false;   // disconnected
    int64_t nlev = run_bfs(order.back());           // pseudo-peripheral

    side.assign(nv, SA);
    int64_t best_k = -1;
    if (nlev >= 3) {
        std::vector<int64_t> wlev(nlev + 1, 0);
        for (int64_t v = 0; v < nv; ++v) wlev[lev[v]] += g.vwt[v];
        std::vector<int64_t> below(nlev + 2, 0);
        for (int64_t l = 0; l <= nlev; ++l)
            below[l + 1] = below[l] + wlev[l];
        double best_cost = 1e300;
        for (int64_t k = 1; k < nlev; ++k) {
            int64_t na = below[k];                 // levels < k
            int64_t nb = g.totw - below[k + 1];    // levels > k
            // accept only near-balanced levels (30% floor here — FM
            // repairs moderate imbalance but cannot climb out of a
            // corner cut) and weight balance heavily in the choice
            if (na < (3 * g.totw) / 10 || nb < (3 * g.totw) / 10)
                continue;
            double balance = (double)std::max(na, nb)
                / (double)std::max<int64_t>(std::min(na, nb), 1);
            double cost = (double)wlev[k] * balance;
            if (cost < best_cost) {
                best_cost = cost;
                best_k = k;
            }
        }
    }
    if (best_k >= 0) {
        // A = levels < k; level-k vertices touching level k-1 separate,
        // the rest of level k joins B with the deeper levels
        for (int64_t v = 0; v < nv; ++v) {
            if (lev[v] < best_k) { side[v] = SA; continue; }
            if (lev[v] > best_k) { side[v] = SB; continue; }
            bool touches_a = false;
            for (int64_t p = g.xadj[v]; p < g.xadj[v + 1] && !touches_a;
                 ++p)
                touches_a = (lev[g.adj[p]] == best_k - 1);
            side[v] = touches_a ? SS : SB;
        }
    } else {
        // weighted-median split of the BFS order; B's boundary separates
        int64_t acc = 0;
        for (int64_t v : order) {
            if (acc < g.totw / 2) { side[v] = SA; acc += g.vwt[v]; }
            else side[v] = SB;
        }
        cover_from_cut(g, side, false);
    }
    return valid_sides(g, side);
}

// Greedy graph growing (GGGP): grow A from a seed, always absorbing the
// frontier vertex whose move least increases the edge cut, until A holds
// half the weight; the lighter boundary then becomes the separator.
// The METIS-style initial cut for irregular graphs, where BFS levels cut
// across many features at once.
bool init_gggp(const WG& g, std::vector<int8_t>& side, uint64_t seed) {
    const int64_t nv = g.nv;
    if (nv < 4) return false;
    side.assign(nv, SB);
    int64_t root = (int64_t)(splitmix64(seed) % (uint64_t)nv);
    // gain of moving v into A = (edge weight to A) - (edge weight to B)
    std::vector<int64_t> locked(nv, 0);
    std::priority_queue<std::tuple<int64_t, int64_t>> heap;
    auto gain = [&](int64_t v) -> int64_t {
        int64_t ga = 0;
        for (int64_t p = g.xadj[v]; p < g.xadj[v + 1]; ++p)
            ga += (side[g.adj[p]] == SA) ? g.ewt[p] : -g.ewt[p];
        return ga;
    };
    side[root] = SA;
    locked[root] = 1;
    int64_t wa = g.vwt[root];
    for (int64_t p = g.xadj[root]; p < g.xadj[root + 1]; ++p)
        heap.emplace(gain(g.adj[p]), g.adj[p]);
    const int64_t half = g.totw / 2;
    while (wa < half && !heap.empty()) {
        auto [gn, v] = heap.top();
        heap.pop();
        if (locked[v]) continue;
        int64_t g2 = gain(v);
        if (g2 != gn) {                      // stale: refresh
            heap.emplace(g2, v);
            continue;
        }
        side[v] = SA;
        locked[v] = 1;
        wa += g.vwt[v];
        for (int64_t p = g.xadj[v]; p < g.xadj[v + 1]; ++p) {
            int64_t w = g.adj[p];
            if (!locked[w]) heap.emplace(gain(w), w);
        }
    }
    if (wa < bal_floor(g.totw)) return false;   // growth starved
    // lighter boundary becomes the separator
    int64_t ba = 0, bb = 0;
    for (int64_t v = 0; v < nv; ++v) {
        bool bnd = false;
        for (int64_t p = g.xadj[v]; p < g.xadj[v + 1] && !bnd; ++p)
            bnd = (side[g.adj[p]] != side[v]);
        if (bnd) ((side[v] == SA) ? ba : bb) += g.vwt[v];
    }
    cover_from_cut(g, side, ba <= bb);
    return valid_sides(g, side);
}

// Spectral sweep cut: the Fiedler vector of the (edge-weighted) graph
// Laplacian orders vertices along the graph's softest direction; sweep
// cuts over that order find thin waists that BFS levels and greedy
// growing miss entirely (the decisive init on plate/shell FE graphs —
// measured on the FE flagship: a coordinate oracle that cuts at the
// geometric waists beats level-cut/GGGP multilevel by ~25% total fill,
// and the spectral init recovers that quality without coordinates).
// The graph here is the coarsest multilevel graph (<= ~240 vertices),
// so an exact dense eigensolve is cheap.

// Deflated power iteration on (c I - L) starting from ``x`` (resized +
// random-seeded if empty): the dominant eigenvector of the shifted
// operator restricted to the complement of the constant vector is the
// Fiedler vector.  Sweep cuts only need the vertex ORDER, so a few tens
// of matvecs suffice — and when ``x`` arrives interpolated from the
// coarse level (multigrid-style), a handful of smoothing iterations
// recover the fine-level waist detail the coarse graph cannot represent.
void fiedler_iterate(const WG& g, std::vector<double>& x, int iters,
                     uint64_t salt) {
    const int64_t nv = g.nv;
    std::vector<double> deg(nv, 0.0);
    double dmax = 0.0;
    for (int64_t v = 0; v < nv; ++v) {
        for (int64_t p = g.xadj[v]; p < g.xadj[v + 1]; ++p)
            deg[v] += (double)g.ewt[p];
        dmax = std::max(dmax, deg[v]);
    }
    const double c = 1.0001 * dmax + 1.0;
    if ((int64_t)x.size() != nv) {
        x.resize(nv);
        for (int64_t v = 0; v < nv; ++v)
            x[v] = (double)(splitmix64(salt ^ (uint64_t)v) % 4096)
                - 2048.0;
    }
    std::vector<double> y(nv);
    for (int it = 0; it < iters; ++it) {
        // y = (c I - L) x = (c - deg) x + W x
        for (int64_t v = 0; v < nv; ++v) {
            double s = (c - deg[v]) * x[v];
            for (int64_t p = g.xadj[v]; p < g.xadj[v + 1]; ++p)
                s += (double)g.ewt[p] * x[g.adj[p]];
            y[v] = s;
        }
        // deflate the constant vector, renormalize
        double mean = 0.0;
        for (int64_t v = 0; v < nv; ++v) mean += y[v];
        mean /= (double)nv;
        double nrm = 0.0;
        for (int64_t v = 0; v < nv; ++v) {
            y[v] -= mean;
            nrm += y[v] * y[v];
        }
        nrm = std::sqrt(nrm);
        if (nrm < 1e-30) return;           // disconnected / degenerate
        for (int64_t v = 0; v < nv; ++v) x[v] = y[v] / nrm;
    }
}

// Fiedler-sweep separator candidates from a precomputed Fiedler vector:
// order vertices by ``f``, pick the ``npick`` feasible prefixes with the
// smallest edge cut, turn each into a vertex separator.  Appends
// candidate sides to ``out``.
void spectral_candidates(const WG& g, const std::vector<double>& f,
                         std::vector<std::vector<int8_t>>& out,
                         int npick) {
    const int64_t nv = g.nv;
    if (nv < 8 || (int64_t)f.size() != nv) return;
    std::vector<std::pair<double, int64_t>> byf(nv);
    for (int64_t v = 0; v < nv; ++v) byf[v] = {f[v], v};
    std::sort(byf.begin(), byf.end());
    // incremental sweep: move vertices into A in Fiedler order, track
    // the edge cut and the balance
    std::vector<int8_t> inA(nv, 0);
    std::vector<std::tuple<int64_t, int64_t>> cuts;   // (cut, prefix len)
    int64_t cut = 0, wa = 0;
    const int64_t floor_w = bal_floor(g.totw);
    for (int64_t k = 0; k < nv - 1; ++k) {
        int64_t v = byf[k].second;
        for (int64_t p = g.xadj[v]; p < g.xadj[v + 1]; ++p)
            cut += inA[g.adj[p]] ? -g.ewt[p] : g.ewt[p];
        inA[v] = 1;
        wa += g.vwt[v];
        if (wa >= floor_w && g.totw - wa >= floor_w)
            cuts.emplace_back(cut, k + 1);
    }
    std::sort(cuts.begin(), cuts.end());
    for (int c = 0; c < npick && c < (int)cuts.size(); ++c) {
        auto [cw, len] = cuts[c];
        std::vector<int8_t> ab(nv, SB);
        for (int64_t k = 0; k < len; ++k) ab[byf[k].second] = SA;
        // two separator constructions per cut: the König minimum cover
        // (fewest vertices) and the lighter one-sided boundary (respects
        // vertex weights) — FM + cost selection keep the better basin
        std::vector<int8_t> side = ab;
        min_cover_sep(g, side);
        if (valid_sides(g, side)) out.push_back(std::move(side));
        int64_t ba = 0, bb = 0;
        for (int64_t v = 0; v < nv; ++v) {
            bool bnd = false;
            for (int64_t p = g.xadj[v]; p < g.xadj[v + 1] && !bnd; ++p)
                bnd = (ab[g.adj[p]] != ab[v]);
            if (bnd) ((ab[v] == SA) ? ba : bb) += g.vwt[v];
        }
        cover_from_cut(g, ab, ba <= bb);
        if (valid_sides(g, ab)) out.push_back(std::move(ab));
    }
}

// Best-of-several initial separator on the coarsest graph: BFS level
// cuts from varied roots plus greedy-growing cuts from varied seeds,
// each FM-refined, ranked by (separator weight, balance).
bool init_vsep_multi(const WG& g, std::vector<int8_t>& side,
                     uint64_t salt, int tries,
                     const std::vector<double>* fiedler = nullptr,
                     int npick = 2) {
    std::pair<int64_t, int64_t> best{INT64_MAX, INT64_MAX};
    std::vector<std::vector<int8_t>> cands;
    if (fiedler) spectral_candidates(g, *fiedler, cands, npick);
    std::vector<int8_t> cand;
    for (int t = 0; t < tries; ++t) {
        bool ok;
        if (t % 2 == 0)
            ok = init_level_cut(
                g, cand,
                (int64_t)(splitmix64(salt + 2 * t) % (uint64_t)g.nv));
        else
            ok = init_gggp(g, cand, salt + 2 * t + 1);
        if (ok) cands.push_back(cand);
    }
    for (auto& c2 : cands) {
        fm_refine_w(g, c2);
        auto cost = cut_cost(g, c2);
        if (cost < best) {
            best = cost;
            side = std::move(c2);
        }
    }
    return best.first != INT64_MAX;
}

// One coarsening step: heavy-edge matching in pseudo-random visit order
// (``salt`` varies the order between attempts); matched pairs merge,
// edge weights accumulate, vertex weights add.  Matches whose combined
// weight exceeds ``wcap`` are skipped so balanced cuts stay
// representable on the coarse graph (METIS does the same).
void coarsen(const WG& g, WG& cg, std::vector<int64_t>& cmap,
             int64_t wcap, uint64_t salt) {
    const int64_t nv = g.nv;
    cmap.assign(nv, -1);
    std::vector<int64_t> ord(nv);
    for (int64_t v = 0; v < nv; ++v) ord[v] = v;
    std::sort(ord.begin(), ord.end(), [salt](int64_t a, int64_t b) {
        uint64_t ha = splitmix64(salt ^ (uint64_t)a);
        uint64_t hb = splitmix64(salt ^ (uint64_t)b);
        return ha < hb || (ha == hb && a < b);
    });
    int64_t nc = 0;
    for (int64_t i = 0; i < nv; ++i) {
        int64_t v = ord[i];
        if (cmap[v] >= 0) continue;
        int64_t best = -1, bw = -1;
        for (int64_t p = g.xadj[v]; p < g.xadj[v + 1]; ++p) {
            int64_t w = g.adj[p];
            if (cmap[w] >= 0) continue;
            if (g.vwt[v] + g.vwt[w] > wcap) continue;
            if (g.ewt[p] > bw) {
                bw = g.ewt[p];
                best = w;
            }
        }
        cmap[v] = nc;
        if (best >= 0) cmap[best] = nc;
        ++nc;
    }
    cg.nv = nc;
    cg.totw = g.totw;
    cg.vwt.assign(nc, 0);
    for (int64_t v = 0; v < nv; ++v) cg.vwt[cmap[v]] += g.vwt[v];
    // members grouped by coarse vertex (counting sort)
    std::vector<int64_t> cnt(nc + 1, 0), mem(nv);
    for (int64_t v = 0; v < nv; ++v) cnt[cmap[v] + 1]++;
    for (int64_t c2 = 0; c2 < nc; ++c2) cnt[c2 + 1] += cnt[c2];
    {
        std::vector<int64_t> next(cnt.begin(), cnt.end() - 1);
        for (int64_t v = 0; v < nv; ++v) mem[next[cmap[v]]++] = v;
    }
    cg.xadj.assign(nc + 1, 0);
    cg.adj.clear();
    cg.ewt.clear();
    cg.adj.reserve(g.adj.size());
    cg.ewt.reserve(g.adj.size());
    std::vector<int64_t> pos(nc, -1);   // coarse nbr -> index in cg.adj
    for (int64_t c2 = 0; c2 < nc; ++c2) {
        int64_t start = (int64_t)cg.adj.size();
        for (int64_t q = cnt[c2]; q < cnt[c2 + 1]; ++q) {
            int64_t v = mem[q];
            for (int64_t p = g.xadj[v]; p < g.xadj[v + 1]; ++p) {
                int64_t wc = cmap[g.adj[p]];
                if (wc == c2) continue;
                if (pos[wc] >= start) {        // older entries are < start
                    cg.ewt[pos[wc]] += g.ewt[p];
                } else {
                    pos[wc] = (int64_t)cg.adj.size();
                    cg.adj.push_back(wc);
                    cg.ewt.push_back(g.ewt[p]);
                }
            }
        }
        cg.xadj[c2 + 1] = (int64_t)cg.adj.size();
    }
}

// cut quality = (separator weight, larger-side weight); smaller is better
// on both axes, lexicographically.  Returns {INT64_MAX, INT64_MAX} for an
// invalid cut (an empty side).
std::pair<int64_t, int64_t> cut_cost(const WG& g,
                                     const std::vector<int8_t>& side) {
    int64_t wa = 0, wb = 0, ws = 0;
    bool has_a = false, has_b = false;
    for (int64_t v = 0; v < g.nv; ++v) {
        if (side[v] == SA) { wa += g.vwt[v]; has_a = true; }
        else if (side[v] == SB) { wb += g.vwt[v]; has_b = true; }
        else ws += g.vwt[v];
    }
    if (!has_a || !has_b) return {INT64_MAX, INT64_MAX};
    // rank a cut below the balance floor behind every cut above it (but
    // ahead of "no cut"): compare by (floor violation, sep, max side)
    // folded into the first key
    int64_t viol = std::max<int64_t>(
        0, bal_floor(g.totw) - std::min(wa, wb));
    return {ws + viol * (g.totw / 8 + 1), std::max(wa, wb)};
}

// Multilevel vertex separator: coarsen until small (or matching stalls),
// cut the coarsest graph with the best of several level-cut / greedy-
// growing attempts, then project + FM-refine back up the levels.  A
// direct fine-level cut serves as the fallback when coarsening stalls
// or the projected cut comes back invalid.
bool multilevel_vsep(const WG& g, std::vector<int8_t>& side,
                     uint64_t salt, std::vector<double>* fout = nullptr) {
    std::pair<int64_t, int64_t> ml_cost{INT64_MAX, INT64_MAX};
    std::vector<int8_t> ml_side;
    std::vector<double> fiedler;
    const int64_t coarse = nd_coarse_size();
    bool coarsened = false;
    if (g.nv > coarse) {
        WG cg;
        std::vector<int64_t> cmap;
        // cap merged supervertices at ~1.5x the average weight of the
        // coarsest graph so balanced coarse cuts stay possible
        int64_t wcap = std::max<int64_t>(1, (3 * g.totw) / (2 * coarse));
        coarsen(g, cg, cmap, wcap, salt);
        if (cg.nv < (g.nv * 17) / 20) {          // made real progress
            coarsened = true;
            std::vector<int8_t> cside;
            std::vector<double> cf;
            if (multilevel_vsep(cg, cside, splitmix64(salt), &cf)) {
                ml_side.resize(g.nv);
                for (int64_t v = 0; v < g.nv; ++v)
                    ml_side[v] = cside[cmap[v]];
                fm_refine_w(g, ml_side);
                ml_cost = cut_cost(g, ml_side);
            }
            // interpolate the coarse Fiedler vector and smooth a few
            // iterations: the fine-level waist detail a 240-vertex
            // graph cannot represent comes back level by level
            if ((int64_t)cf.size() == cg.nv) {
                fiedler.resize(g.nv);
                for (int64_t v = 0; v < g.nv; ++v)
                    fiedler[v] = cf[cmap[v]];
                fiedler_iterate(g, fiedler, (int)nd_smooth_iters(), salt);
            }
        }
        // fall through: matching stalled or coarse cut failed
    }
    if (fiedler.empty())
        fiedler_iterate(g, fiedler,
                        coarsened ? (int)nd_smooth_iters() : 60,
                        salt ^ 0xfeed);
    // the projected cut competes against direct fine-level cuts: BFS
    // level sets (on grid-like graphs a level set IS the optimal flat
    // separator), greedy growing at the coarsest graph, and the
    // Fiedler-sweep waist cuts at EVERY level
    std::pair<int64_t, int64_t> dir_cost{INT64_MAX, INT64_MAX};
    if (init_vsep_multi(g, side, salt, g.nv <= coarse ? 6 : 1, &fiedler,
                        g.nv <= coarse ? 5 : (g.nv >= 30000 ? 4 : 2)))
        dir_cost = cut_cost(g, side);
    if (ml_cost < dir_cost) side = std::move(ml_side);
    if (fout) *fout = std::move(fiedler);
    return std::min(ml_cost, dir_cost).first != INT64_MAX;
}



void dissect(Ctx& c, std::vector<int64_t> S, int64_t t, int depth = 0) {
    const int64_t m = (int64_t)S.size();
    if (m <= c.leaf) {
        order_leaf(c, S, t);
        return;
    }

    // connected components: retag each as soon as it is found (the tag is
    // the membership test, so an already-claimed vertex is never revisited)
    // and recurse on each separately
    std::vector<int64_t> comp;
    bfs(c, S[0], t, comp);
    if ((int64_t)comp.size() < m) {
        std::vector<std::pair<std::vector<int64_t>, int64_t>> comps;
        int64_t t0 = c.next_tag++;
        for (int64_t v : comp) c.tag[v] = t0;
        comps.emplace_back(std::move(comp), t0);
        for (int64_t v : S) {
            if (c.tag[v] != t) continue;
            std::vector<int64_t> more;
            bfs(c, v, t, more);
            int64_t tc = c.next_tag++;
            for (int64_t w : more) c.tag[w] = tc;
            comps.emplace_back(std::move(more), tc);
        }
        for (auto& cc : comps)
            dissect(c, std::move(cc.first), cc.second, depth);
        return;
    }

    // compact local weighted graph of the (connected) subgraph
    WG g;
    g.nv = m;
    for (int64_t i = 0; i < m; ++i) c.loc[S[i]] = i;
    g.xadj.assign(m + 1, 0);
    g.adj.clear();
    for (int64_t i = 0; i < m; ++i) {
        int64_t v = S[i];
        for (int64_t p = c.xadj[v]; p < c.xadj[v + 1]; ++p) {
            int64_t w = c.adjv[p];
            if (c.tag[w] == t) g.adj.push_back(c.loc[w]);
        }
        g.xadj[i + 1] = (int64_t)g.adj.size();
    }
    g.ewt.assign(g.adj.size(), 1);
    g.vwt.resize(m);
    g.totw = 0;
    for (int64_t i = 0; i < m; ++i) {
        g.vwt[i] = c.vwt.empty() ? 1 : c.vwt[S[i]];
        g.totw += g.vwt[i];
    }

    // several independent multilevel attempts at the shallow depths,
    // where separator quality dominates total fill; one attempt deeper
    // down, where the subgraphs are small and numerous
    const int attempts = depth == 0 ? 8 : (depth <= 2 ? 4 : 1);
    std::vector<int8_t> side, cand;
    std::pair<int64_t, int64_t> best{INT64_MAX, INT64_MAX};
    for (int at = 0; at < attempts; ++at) {
        if (!multilevel_vsep(g, cand,
                             c.salt0 + 0x9e37u * (at + 1)))
            continue;
        auto cost = cut_cost(g, cand);
        if (cost < best) {
            best = cost;
            side = cand;
        }
    }
    if (best.first == INT64_MAX) {
        // dense blob / expander-like subgraph: no useful separator
        if (nd_stats_level() >= 0 && m > 500)
            std::fprintf(stderr, "nd depth %d: NO-SEP takeover m=%lld\n",
                         depth, (long long)m);
        order_leaf(c, S, t);
        return;
    }
    std::vector<int64_t> A, B, sep;
    int64_t sepw = 0;
    for (int64_t i = 0; i < m; ++i) {
        if (side[i] == SA) A.push_back(S[i]);
        else if (side[i] == SB) B.push_back(S[i]);
        else { sep.push_back(S[i]); sepw += g.vwt[i]; }
    }
    // quality gate: a separator covering a third of the subgraph means
    // recursing is worse than minimum degree on the whole subgraph
    // (expander-like blobs); MD-order it and stop
    if (A.empty() || B.empty() || sep.empty() || sepw > g.totw / 3) {
        if (nd_stats_level() >= 0 && m > 500)
            std::fprintf(stderr,
                         "nd depth %d: GATE takeover m=%lld sepw=%lld\n",
                         depth, (long long)m, (long long)sepw);
        order_leaf(c, S, t);
        return;
    }
    if (depth <= nd_stats_level()) {
        int64_t wa2 = 0, wb2 = 0;
        for (int64_t i = 0; i < m; ++i) {
            if (side[i] == SA) wa2 += g.vwt[i];
            else if (side[i] == SB) wb2 += g.vwt[i];
        }
        std::fprintf(stderr,
                     "nd depth %d: tot %lld sep %lld a %lld b %lld\n",
                     depth, (long long)g.totw, (long long)sepw,
                     (long long)wa2, (long long)wb2);
    }
    int64_t ta = c.next_tag++;
    int64_t tb = c.next_tag++;
    int64_t ts = c.next_tag++;
    for (int64_t v : A) c.tag[v] = ta;
    for (int64_t v : B) c.tag[v] = tb;
    for (int64_t v : sep) c.tag[v] = ts;
    dissect(c, std::move(A), ta, depth + 1);
    dissect(c, std::move(B), tb, depth + 1);
    order_leaf(c, sep, ts);       // separator eliminated last
}

// exact LDL^T column counts of the relabeled matrix via the standard
// elimination-tree path traversal (same scheme mf.cpp uses)
int64_t etree_fill(int64_t n, const std::vector<int64_t>& Ap,
                   const std::vector<int64_t>& Ai) {
    std::vector<int64_t> parent(n, -1), flag(n, -1);
    int64_t total = n;             // the diagonal
    for (int64_t k = 0; k < n; ++k) {
        flag[k] = k;
        for (int64_t p = Ap[k]; p < Ap[k + 1]; ++p) {
            int64_t i = Ai[p];
            if (i >= k) continue;
            while (flag[i] != k) {
                if (parent[i] == -1) parent[i] = k;
                ++total;
                flag[i] = k;
                i = parent[i];
            }
        }
    }
    return total;
}

// run the whole dissection pipeline on the adjacency already loaded in
// ``c``; fills c.out with the ordering
int64_t run_dissect(Ctx& c) {
    const int64_t n = c.n;
    c.tag.assign(n, 0);
    c.seen.assign(n, -1);
    c.lev.assign(n, 0);
    c.loc.assign(n, -1);
    c.out.assign(n, -1);
    c.next_pos = 0;
    c.next_tag = 1;
    std::vector<int64_t> all(n);
    for (int64_t v = 0; v < n; ++v) all[v] = v;
    dissect(c, std::move(all), 0);
    return (c.next_pos == n) ? 0 : -1;
}

}  // namespace

extern "C" {

int64_t nd_order_salted(int64_t n, const int64_t* Ap, const int64_t* Ai,
                        int64_t* perm, int64_t salt) {
    if (n <= 0) return 0;
    Ctx c;
    c.n = n;
    c.salt0 = salt ? splitmix64((uint64_t)salt) : 0;
    c.leaf = nd_leaf_size();
    static const int64_t smooth_extra[3] = {0, 7, 20};
    g_smooth_extra = smooth_extra[(uint64_t)salt % 3];
    static const int64_t bal[3][2] = {{0, 1}, {1, 4}, {3, 8}};
    g_bal_num = bal[(uint64_t)salt % 3][0];
    g_bal_den = bal[(uint64_t)salt % 3][1];
    // symmetrized adjacency without the diagonal
    std::vector<int64_t> deg(n, 0);
    for (int64_t j = 0; j < n; ++j)
        for (int64_t p = Ap[j]; p < Ap[j + 1]; ++p) {
            int64_t i = Ai[p];
            if (i == j || i < 0 || i >= n) continue;
            deg[i]++;
            deg[j]++;
        }
    c.xadj.assign(n + 1, 0);
    for (int64_t v = 0; v < n; ++v) c.xadj[v + 1] = c.xadj[v] + deg[v];
    c.adjv.assign(c.xadj[n], 0);
    {
        std::vector<int64_t> next(c.xadj.begin(), c.xadj.end() - 1);
        for (int64_t j = 0; j < n; ++j)
            for (int64_t p = Ap[j]; p < Ap[j + 1]; ++p) {
                int64_t i = Ai[p];
                if (i == j || i < 0 || i >= n) continue;
                c.adjv[next[i]++] = j;
                c.adjv[next[j]++] = i;
            }
        // dedup (the input may be full-symmetric already)
        int64_t w = 0;
        std::vector<int64_t> xnew(n + 1, 0);
        for (int64_t v = 0; v < n; ++v) {
            int64_t a = c.xadj[v], b = c.xadj[v + 1];
            std::sort(c.adjv.begin() + a, c.adjv.begin() + b);
            int64_t start = w;
            for (int64_t p = a; p < b; ++p)
                if (p == a || c.adjv[p] != c.adjv[p - 1])
                    c.adjv[w++] = c.adjv[p];
            xnew[v + 1] = xnew[v] + (w - start);
        }
        c.xadj = std::move(xnew);
        c.adjv.resize(c.xadj[n]);
    }

    // Supervariable compression: vertices with identical closed
    // neighborhoods N[v] = N(v) ∪ {v} are indistinguishable for fill (FE
    // matrices with d dofs/node compress ~d×).  Dissect the quotient graph
    // — separators then align with mesh nodes — and expand members
    // consecutively at the end.
    std::vector<int64_t> leader(n);
    int64_t n_groups = 0;
    {
        std::vector<uint64_t> h(n);
        for (int64_t v = 0; v < n; ++v) {
            uint64_t s = splitmix64((uint64_t)v);
            for (int64_t p = c.xadj[v]; p < c.xadj[v + 1]; ++p)
                s += splitmix64((uint64_t)c.adjv[p]);
            h[v] = s;
        }
        std::vector<int64_t> byh(n);
        for (int64_t v = 0; v < n; ++v) byh[v] = v;
        std::sort(byh.begin(), byh.end(), [&](int64_t a, int64_t b) {
            return h[a] < h[b] || (h[a] == h[b] && a < b);
        });
        // exact closed-neighborhood equality (degrees equal + merged walk
        // treating the self vertex as an inserted element)
        auto closed_eq = [&](int64_t u, int64_t v) -> bool {
            int64_t du = c.xadj[u + 1] - c.xadj[u];
            int64_t dv = c.xadj[v + 1] - c.xadj[v];
            if (du != dv) return false;
            int64_t pu = c.xadj[u], pv = c.xadj[v];
            int64_t eu = c.xadj[u + 1], ev = c.xadj[v + 1];
            bool su = false, sv = false;   // self id consumed
            for (int64_t k = 0; k < du + 1; ++k) {
                int64_t a = (pu < eu) ? c.adjv[pu] : INT64_MAX;
                if (!su && u < a) { a = u; su = true; } else ++pu;
                int64_t b = (pv < ev) ? c.adjv[pv] : INT64_MAX;
                if (!sv && v < b) { b = v; sv = true; } else ++pv;
                if (a != b) return false;
            }
            return true;
        };
        for (int64_t i = 0; i < n; ++i) {
            int64_t v = byh[i];
            leader[v] = v;
            for (int64_t j = i - 1;
                 j >= 0 && h[byh[j]] == h[v] && i - j <= 16; --j) {
                int64_t u = byh[j];
                if (leader[u] == u && closed_eq(u, v)) {
                    leader[v] = u;
                    break;
                }
            }
            if (leader[v] == v) ++n_groups;
        }
    }

    if (n_groups > (9 * n) / 10) {
        // compression not worthwhile: dissect the full graph directly
        if (run_dissect(c) != 0) return -1;
        std::memcpy(perm, c.out.data(), sizeof(int64_t) * n);
        return 0;
    }

    // build the quotient graph
    std::vector<int64_t> gid(n, -1);        // vertex -> supervariable id
    std::vector<int64_t> reps;
    reps.reserve(n_groups);
    for (int64_t v = 0; v < n; ++v)
        if (leader[v] == v) {
            gid[v] = (int64_t)reps.size();
            reps.push_back(v);
        }
    for (int64_t v = 0; v < n; ++v) gid[v] = gid[leader[v]];
    // members grouped by supervariable (counting sort preserving id order)
    std::vector<int64_t> gcount(n_groups + 1, 0);
    for (int64_t v = 0; v < n; ++v) gcount[gid[v] + 1]++;
    for (int64_t g = 0; g < n_groups; ++g) gcount[g + 1] += gcount[g];
    std::vector<int64_t> gmem(n);
    {
        std::vector<int64_t> next(gcount.begin(), gcount.end() - 1);
        for (int64_t v = 0; v < n; ++v) gmem[next[gid[v]]++] = v;
    }
    Ctx q;
    q.n = n_groups;
    q.salt0 = c.salt0;
    // keep the MD-takeover threshold in *original* vertices: a quotient
    // leaf of leaf/ratio supervariables expands to ~leaf vertices
    q.leaf = std::max<int64_t>(32, (c.leaf * n_groups) / n);
    q.xadj.assign(n_groups + 1, 0);
    q.adjv.clear();
    q.adjv.reserve(c.xadj[n] / 2);
    // indistinguishable vertices share the neighborhood, so the
    // representative's adjacency suffices
    for (int64_t g = 0; g < n_groups; ++g) {
        int64_t v = reps[g];
        int64_t start = (int64_t)q.adjv.size();
        for (int64_t p = c.xadj[v]; p < c.xadj[v + 1]; ++p) {
            int64_t wg = gid[c.adjv[p]];
            if (wg != g) q.adjv.push_back(wg);
        }
        std::sort(q.adjv.begin() + start, q.adjv.end());
        q.adjv.erase(std::unique(q.adjv.begin() + start, q.adjv.end()),
                     q.adjv.end());
        q.xadj[g + 1] = (int64_t)q.adjv.size();
    }
    // supervariable sizes weight the dissection so separator/balance
    // decisions are made in original-vertex units
    q.vwt.resize(n_groups);
    for (int64_t g = 0; g < n_groups; ++g)
        q.vwt[g] = gcount[g + 1] - gcount[g];
    if (run_dissect(q) != 0) return -1;
    int64_t pos = 0;
    for (int64_t k = 0; k < n_groups; ++k) {
        int64_t g = q.out[k];
        for (int64_t p = gcount[g]; p < gcount[g + 1]; ++p)
            perm[pos++] = gmem[p];
    }
    return (pos == n) ? 0 : -1;
}

int64_t nd_order(int64_t n, const int64_t* Ap, const int64_t* Ai,
                 int64_t* perm) {
    return nd_order_salted(n, Ap, Ai, perm, 0);
}

int64_t symbolic_lnz(int64_t n, const int64_t* Ap, const int64_t* Ai,
                     const int64_t* perm) {
    if (n <= 0) return 0;
    std::vector<int64_t> ipos(n);
    for (int64_t k = 0; k < n; ++k) ipos[perm[k]] = k;
    // upper CSC of the relabeled pattern
    int64_t nnz = Ap[n];
    std::vector<int64_t> cnt(n + 1, 0), ri(nnz), ci(nnz);
    for (int64_t j = 0; j < n; ++j)
        for (int64_t p = Ap[j]; p < Ap[j + 1]; ++p) {
            int64_t i2 = ipos[Ai[p]], j2 = ipos[j];
            if (i2 > j2) std::swap(i2, j2);
            ri[p] = i2;
            ci[p] = j2;
            cnt[j2 + 1]++;
        }
    for (int64_t j = 0; j < n; ++j) cnt[j + 1] += cnt[j];
    std::vector<int64_t> Bp = cnt, Bi(nnz);
    {
        std::vector<int64_t> next(Bp.begin(), Bp.end() - 1);
        for (int64_t p = 0; p < nnz; ++p) Bi[next[ci[p]]++] = ri[p];
    }
    return etree_fill(n, Bp, Bi);
}

}  // extern "C"
