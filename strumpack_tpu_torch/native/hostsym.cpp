// Native host-side symbolic core.
//
// Role of the reference's C++ symbolic machinery: symbolic factorization
// (EliminationTree.cpp:65-123 bottom-up merge of child update sets),
// BFS-based nested dissection (sparse/ordering/ANDSparspak.cpp), multilevel
// vertex-separator nested dissection (the METIS_NodeND role), quotient-graph
// minimum degree (AMD/MMD) and minimum local fill.  Irregular graph
// algorithms that belong on the host CPU; the Python planner calls them
// through ctypes.  The same source as strumpack_tpu/native/hostsym.cpp, so
// both packages order a graph identically (the multilevel splitter's LCG
// included).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 hostsym.cpp -o libhostsym.so
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <functional>
#include <queue>
#include <vector>

using i64 = int64_t;

extern "C" {

// ---------------------------------------------------------------------------
// Symbolic factorization: per-front update index sets.
// Returns 0 on success; *out_upd is a malloc'd flat array with offsets
// *out_off (nseps+1 entries).  Caller frees both with hostsym_free.
// ---------------------------------------------------------------------------
int symbolic_factorization(i64 n, const i64* rowptr, const i64* colind,
                           i64 nseps, const i64* sep_begin,
                           const i64* sep_end, const i64* lch,
                           const i64* rch, i64** out_upd, i64** out_off) {
  std::vector<std::vector<i64>> upd(nseps);
  std::vector<i64> tmp;
  for (i64 i = 0; i < nseps; ++i) {
    i64 sb = sep_begin[i], se = sep_end[i];
    tmp.clear();
    for (i64 r = sb; r < se; ++r)
      for (i64 p = rowptr[r]; p < rowptr[r + 1]; ++p) {
        i64 c = colind[p];
        if (c >= se) tmp.push_back(c);
      }
    for (int side = 0; side < 2; ++side) {
      i64 ch = side == 0 ? lch[i] : rch[i];
      if (ch < 0) continue;
      for (i64 v : upd[ch])
        if (v >= se) tmp.push_back(v);
      // children's sets are no longer needed once merged into the parent,
      // but they are returned to the caller, so keep them.
    }
    std::sort(tmp.begin(), tmp.end());
    tmp.erase(std::unique(tmp.begin(), tmp.end()), tmp.end());
    upd[i] = tmp;
  }
  i64 total = 0;
  for (auto& u : upd) total += (i64)u.size();
  i64* flat = (i64*)malloc(sizeof(i64) * std::max<i64>(total, 1));
  i64* off = (i64*)malloc(sizeof(i64) * (nseps + 1));
  i64 pos = 0;
  off[0] = 0;
  for (i64 i = 0; i < nseps; ++i) {
    std::memcpy(flat + pos, upd[i].data(), sizeof(i64) * upd[i].size());
    pos += (i64)upd[i].size();
    off[i + 1] = pos;
  }
  *out_upd = flat;
  *out_off = off;
  return 0;
}

// ---------------------------------------------------------------------------
// BFS level-set bisection nested dissection (ANDSparspak role).
// Emits perm (perm[new] = old) and a postorder binary separator tree.
// ---------------------------------------------------------------------------
struct NDBuilder {
  std::vector<i64> perm, sb, se, par, lc, rc;
  i64 count = 0;
  i64 emit(const std::vector<i64>& v) {
    for (i64 x : v) perm.push_back(x);
    i64 lo = count;
    count += (i64)v.size();
    return lo;
  }
  i64 add_node(i64 lo, i64 hi, i64 l, i64 r) {
    i64 id = (i64)sb.size();
    sb.push_back(lo); se.push_back(hi);
    par.push_back(-1); lc.push_back(l); rc.push_back(r);
    if (l >= 0) par[l] = id;
    if (r >= 0) par[r] = id;
    return id;
  }
};

static i64 nd_rec(NDBuilder& B, const i64* rowptr, const i64* colind,
                  std::vector<i64>& ids, std::vector<i64>& mark,
                  std::vector<i64>& lev, i64 stamp_base, i64 leaf) {
  i64 m = (i64)ids.size();
  if (m <= leaf) {
    i64 lo = B.emit(ids);
    return B.add_node(lo, B.count, -1, -1);
  }
  // mark membership with a unique stamp; lev[] holds BFS levels
  i64 stamp = stamp_base;
  for (i64 v : ids) mark[v] = stamp;

  // pseudo-peripheral BFS from ids[0] (two sweeps)
  i64 start = ids[0];
  std::vector<i64> q;
  i64 maxlev = 0;
  for (int sweep = 0; sweep < 3; ++sweep) {
    for (i64 v : ids) lev[v] = -1;
    q.clear();
    q.push_back(start);
    lev[start] = 0;
    i64 last = start;
    maxlev = 0;
    for (size_t h = 0; h < q.size(); ++h) {
      i64 u = q[h];
      for (i64 p = rowptr[u]; p < rowptr[u + 1]; ++p) {
        i64 w = colind[p];
        if (mark[w] == stamp && lev[w] < 0) {
          lev[w] = lev[u] + 1;
          maxlev = std::max(maxlev, lev[w]);
          q.push_back(w);
          last = w;
        }
      }
    }
    if ((i64)q.size() < m) break;  // disconnected; handle below
    if (lev[last] == 0) break;
    start = last;
  }

  std::vector<i64> left, right, sep;
  if ((i64)q.size() < m) {
    // disconnected: reached component vs rest, empty separator
    for (i64 v : ids) (lev[v] >= 0 ? left : right).push_back(v);
  } else if (maxlev < 2) {
    i64 half = m / 2;
    left.assign(ids.begin(), ids.begin() + half);
    right.assign(ids.begin() + half, ids.end());
    // separator = boundary of left
    for (i64 v : right) mark[v] = stamp + 1;
    std::vector<i64> newleft;
    for (i64 v : left) {
      bool bnd = false;
      for (i64 p = rowptr[v]; p < rowptr[v + 1] && !bnd; ++p)
        if (mark[colind[p]] == stamp + 1) bnd = true;
      (bnd ? sep : newleft).push_back(v);
    }
    left.swap(newleft);
    for (i64 v : right) mark[v] = stamp;
  } else {
    // balanced split level
    std::vector<i64> cnt(maxlev + 2, 0);
    for (i64 v : ids) cnt[lev[v]]++;
    i64 cum = 0, split = 0, best = m;
    i64 c2 = 0;
    for (i64 l = 0; l <= maxlev - 1; ++l) {
      c2 += cnt[l];
      i64 bal = std::llabs(2 * c2 - m);
      if (bal < best) { best = bal; split = l; }
    }
    for (i64 v : ids) {
      if (lev[v] <= split) left.push_back(v); else right.push_back(v);
    }
    // separator: vertices of left adjacent to right
    for (i64 v : right) mark[v] = stamp + 1;
    std::vector<i64> newleft;
    for (i64 v : left) {
      bool bnd = false;
      for (i64 p = rowptr[v]; p < rowptr[v + 1] && !bnd; ++p)
        if (mark[colind[p]] == stamp + 1) bnd = true;
      (bnd ? sep : newleft).push_back(v);
    }
    left.swap(newleft);
    for (i64 v : right) mark[v] = stamp;
  }
  if (sep.empty() && (left.empty() || right.empty())) {
    i64 lo = B.emit(ids);
    return B.add_node(lo, B.count, -1, -1);
  }
  i64 l = -1, r = -1;
  if (!left.empty())
    l = nd_rec(B, rowptr, colind, left, mark, lev, stamp_base + 2, leaf);
  if (!right.empty())
    r = nd_rec(B, rowptr, colind, right, mark, lev, stamp_base + 2, leaf);
  i64 lo = B.emit(sep);
  return B.add_node(lo, B.count, l, r);
}

// ---------------------------------------------------------------------------
// Multilevel vertex-separator nested dissection (METIS_NodeND role,
// sparse/ordering/MetisReordering.hpp in the reference): heavy-edge-matching
// coarsening -> greedy-growing initial bisection -> FM boundary refinement on
// uncoarsening -> minimum vertex cover separator (Hopcroft-Karp + Koenig on
// the boundary bipartite graph) -> recurse.
// ---------------------------------------------------------------------------

namespace ml {

struct Graph {
  i64 n = 0;
  std::vector<i64> xadj, adj, ewgt, vwgt;
};

struct Rng {  // deterministic LCG (reproducible orderings)
  uint64_t s;
  explicit Rng(uint64_t seed) : s(seed * 6364136223846793005ull + 1) {}
  uint64_t next() { s = s * 6364136223846793005ull + 1442695040888963407ull;
                    return s >> 33; }
  i64 below(i64 m) { return (i64)(next() % (uint64_t)m); }
};

// Heavy-edge matching: returns coarse vertex count; cmap[v] = coarse id.
static i64 hem_match(const Graph& g, std::vector<i64>& cmap, Rng& rng) {
  i64 n = g.n;
  std::vector<i64> order(n);
  for (i64 i = 0; i < n; ++i) order[i] = i;
  for (i64 i = n - 1; i > 0; --i) std::swap(order[i], order[rng.below(i + 1)]);
  cmap.assign(n, -1);
  i64 nc = 0;
  for (i64 oi = 0; oi < n; ++oi) {
    i64 v = order[oi];
    if (cmap[v] >= 0) continue;
    i64 best = -1, bw = -1;
    for (i64 p = g.xadj[v]; p < g.xadj[v + 1]; ++p) {
      i64 u = g.adj[p];
      if (u != v && cmap[u] < 0 && g.ewgt[p] > bw) { bw = g.ewgt[p]; best = u; }
    }
    cmap[v] = nc;
    if (best >= 0) cmap[best] = nc;
    ++nc;
  }
  return nc;
}

// Contract g by cmap into gc (merged adjacency, summed edge/vertex weights).
static void contract(const Graph& g, const std::vector<i64>& cmap, i64 nc,
                     Graph& gc) {
  gc.n = nc;
  gc.vwgt.assign(nc, 0);
  for (i64 v = 0; v < g.n; ++v) gc.vwgt[cmap[v]] += g.vwgt[v];
  gc.xadj.assign(nc + 1, 0);
  gc.adj.clear(); gc.ewgt.clear();
  std::vector<i64> pos(nc, -1);        // scatter buffer: coarse nbr -> slot
  std::vector<std::vector<i64>> members(nc);
  for (i64 v = 0; v < g.n; ++v) members[cmap[v]].push_back(v);
  std::vector<i64> nbr; std::vector<i64> wgt;
  for (i64 c = 0; c < nc; ++c) {
    nbr.clear(); wgt.clear();
    for (i64 v : members[c])
      for (i64 p = g.xadj[v]; p < g.xadj[v + 1]; ++p) {
        i64 u = cmap[g.adj[p]];
        if (u == c) continue;
        if (pos[u] < 0) { pos[u] = (i64)nbr.size(); nbr.push_back(u);
                          wgt.push_back(g.ewgt[p]); }
        else wgt[pos[u]] += g.ewgt[p];
      }
    for (i64 u : nbr) pos[u] = -1;
    gc.xadj[c + 1] = gc.xadj[c] + (i64)nbr.size();
    gc.adj.insert(gc.adj.end(), nbr.begin(), nbr.end());
    gc.ewgt.insert(gc.ewgt.end(), wgt.begin(), wgt.end());
  }
}

// Greedy graph growing bisection of g: BFS from a random start until half
// the vertex weight is reached.  part[v] in {0,1}.  Returns edge cut.
static i64 grow_bisect(const Graph& g, std::vector<i64>& part, Rng& rng) {
  i64 n = g.n, total = 0;
  for (i64 v = 0; v < n; ++v) total += g.vwgt[v];
  part.assign(n, 1);
  std::vector<i64> q; q.reserve(n);
  std::vector<char> seen(n, 0);
  i64 w0 = 0, target = total / 2;
  i64 start = rng.below(n);
  q.push_back(start); seen[start] = 1;
  for (size_t h = 0; h < q.size() && w0 < target; ++h) {
    i64 v = q[h];
    part[v] = 0; w0 += g.vwgt[v];
    for (i64 p = g.xadj[v]; p < g.xadj[v + 1]; ++p) {
      i64 u = g.adj[p];
      if (!seen[u]) { seen[u] = 1; q.push_back(u); }
    }
    if ((i64)q.size() == (i64)h + 1 && h + 1 < (size_t)n && w0 < target) {
      // disconnected: jump to an unseen vertex
      for (i64 u = 0; u < n; ++u)
        if (!seen[u]) { seen[u] = 1; q.push_back(u); break; }
    }
  }
  i64 cut = 0;
  for (i64 v = 0; v < n; ++v)
    for (i64 p = g.xadj[v]; p < g.xadj[v + 1]; ++p)
      if (part[v] != part[g.adj[p]]) cut += g.ewgt[p];
  return cut / 2;
}

// One FM refinement pass (boundary Kernighan-Lin with rollback to the best
// prefix); maintains balance |w0 - w1| <= max(imbal*total, maxvw).
static void fm_refine(const Graph& g, std::vector<i64>& part, int npass) {
  i64 n = g.n, total = 0, maxvw = 1;
  for (i64 v = 0; v < n; ++v) { total += g.vwgt[v]; maxvw = std::max(maxvw, g.vwgt[v]); }
  i64 allow = std::max((i64)(0.03 * total), 2 * maxvw);
  std::vector<i64> gain(n);
  std::vector<char> locked(n);
  using QE = std::pair<i64, i64>;  // (gain, vertex), lazy invalidation
  for (int pass = 0; pass < npass; ++pass) {
    i64 w0 = 0;
    for (i64 v = 0; v < n; ++v) if (part[v] == 0) w0 += g.vwgt[v];
    std::priority_queue<QE> pq;
    for (i64 v = 0; v < n; ++v) {
      locked[v] = 0;
      i64 in = 0, ex = 0;
      for (i64 p = g.xadj[v]; p < g.xadj[v + 1]; ++p)
        (part[g.adj[p]] == part[v] ? in : ex) += g.ewgt[p];
      gain[v] = ex - in;
      if (ex > 0) pq.push({gain[v], v});  // boundary only
    }
    std::vector<i64> moves;
    i64 cur = 0, best = 0, bestk = -1;
    int bad = 0;
    while (!pq.empty() && bad < 100) {
      auto [gn, v] = pq.top(); pq.pop();
      if (locked[v] || gn != gain[v]) continue;
      // balance check for moving v out of part[v]
      i64 nw0 = part[v] == 0 ? w0 - g.vwgt[v] : w0 + g.vwgt[v];
      if (std::llabs(2 * nw0 - total) > allow &&
          std::llabs(2 * nw0 - total) > std::llabs(2 * w0 - total))
        continue;
      locked[v] = 1;
      part[v] ^= 1; w0 = nw0;
      cur += gn;
      moves.push_back(v);
      if (cur > best) { best = cur; bestk = (i64)moves.size() - 1; bad = 0; }
      else ++bad;
      for (i64 p = g.xadj[v]; p < g.xadj[v + 1]; ++p) {
        i64 u = g.adj[p];
        if (locked[u]) continue;
        i64 in = 0, ex = 0;
        for (i64 q2 = g.xadj[u]; q2 < g.xadj[u + 1]; ++q2)
          (part[g.adj[q2]] == part[u] ? in : ex) += g.ewgt[q2];
        gain[u] = ex - in;
        if (ex > 0) pq.push({gain[u], u});
      }
    }
    // rollback moves after the best prefix
    for (i64 k = (i64)moves.size() - 1; k > bestk; --k) part[moves[k]] ^= 1;
    if (best == 0) break;
  }
}

// Hopcroft-Karp maximum bipartite matching; left 0..nl-1, right 0..nr-1,
// adjacency ladj.  Returns matchL (right id or -1 per left).
static void hopcroft_karp(i64 nl, i64 nr,
                          const std::vector<std::vector<i64>>& ladj,
                          std::vector<i64>& matchL, std::vector<i64>& matchR) {
  matchL.assign(nl, -1); matchR.assign(nr, -1);
  const i64 INF = (i64)1e18;
  std::vector<i64> dist(nl);
  auto bfs = [&]() {
    std::queue<i64> q;
    bool found = false;
    for (i64 u = 0; u < nl; ++u) {
      if (matchL[u] < 0) { dist[u] = 0; q.push(u); }
      else dist[u] = INF;
    }
    while (!q.empty()) {
      i64 u = q.front(); q.pop();
      for (i64 v : ladj[u]) {
        i64 w = matchR[v];
        if (w < 0) found = true;
        else if (dist[w] == INF) { dist[w] = dist[u] + 1; q.push(w); }
      }
    }
    return found;
  };
  std::function<bool(i64)> dfs = [&](i64 u) -> bool {
    for (i64 v : ladj[u]) {
      i64 w = matchR[v];
      if (w < 0 || (dist[w] == dist[u] + 1 && dfs(w))) {
        matchL[u] = v; matchR[v] = u; return true;
      }
    }
    dist[u] = INF;
    return false;
  };
  while (bfs())
    for (i64 u = 0; u < nl; ++u)
      if (matchL[u] < 0) dfs(u);
}

// Minimum vertex cover separator from an edge bipartition (Koenig's theorem
// on the boundary bipartite graph via Hopcroft-Karp).  Returns where[]:
// 0 = A, 1 = B, 2 = S.
static std::vector<i64> vertex_cover_sep(const Graph& g,
                                         const std::vector<i64>& part) {
  i64 n = g.n;
  std::vector<i64> lid(n, -1), rid(n, -1), lvert, rvert;
  for (i64 v = 0; v < n; ++v) {
    bool bnd = false;
    for (i64 p = g.xadj[v]; p < g.xadj[v + 1] && !bnd; ++p)
      if (part[g.adj[p]] != part[v]) bnd = true;
    if (!bnd) continue;
    if (part[v] == 0) { lid[v] = (i64)lvert.size(); lvert.push_back(v); }
    else { rid[v] = (i64)rvert.size(); rvert.push_back(v); }
  }
  std::vector<std::vector<i64>> ladj(lvert.size());
  for (i64 li = 0; li < (i64)lvert.size(); ++li) {
    i64 v = lvert[li];
    for (i64 p = g.xadj[v]; p < g.xadj[v + 1]; ++p) {
      i64 u = g.adj[p];
      if (rid[u] >= 0 && part[u] == 1) ladj[li].push_back(rid[u]);
    }
  }
  std::vector<i64> matchL, matchR;
  hopcroft_karp((i64)lvert.size(), (i64)rvert.size(), ladj, matchL, matchR);
  // Koenig: Z = left vertices reachable by alternating paths from unmatched
  // left; cover = (L \ Z) + (R in Z)
  std::vector<char> inZL(lvert.size(), 0), inZR(rvert.size(), 0);
  std::queue<i64> q;
  for (i64 li = 0; li < (i64)lvert.size(); ++li)
    if (matchL[li] < 0) { inZL[li] = 1; q.push(li); }
  while (!q.empty()) {
    i64 li = q.front(); q.pop();
    for (i64 ri : ladj[li]) {
      if (inZR[ri]) continue;
      inZR[ri] = 1;
      i64 l2 = matchR[ri];
      if (l2 >= 0 && !inZL[l2]) { inZL[l2] = 1; q.push(l2); }
    }
  }
  std::vector<i64> where(n);
  for (i64 v = 0; v < n; ++v) where[v] = part[v];
  for (i64 li = 0; li < (i64)lvert.size(); ++li)
    if (!inZL[li]) where[lvert[li]] = 2;
  for (i64 ri = 0; ri < (i64)rvert.size(); ++ri)
    if (inZR[ri]) where[rvert[ri]] = 2;
  return where;
}

// Node-separator FM refinement (METIS-style): repeatedly move a separator
// vertex into a side, pulling its other-side neighbors into the separator,
// when that shrinks |S| (gain = 1 - #neighbors on the other side) subject
// to balance.  where[v]: 0 = A, 1 = B, 2 = S.
static void refine_sep(const Graph& g, std::vector<i64>& where, Rng& rng,
                       int npass) {
  i64 n = g.n;
  i64 wa = 0, wb = 0;
  for (i64 v = 0; v < n; ++v) {
    if (where[v] == 0) wa += g.vwgt[v];
    else if (where[v] == 1) wb += g.vwgt[v];
  }
  i64 total = wa + wb;
  std::vector<i64> order(n);
  for (int pass = 0; pass < npass; ++pass) {
    bool improved = false;
    i64 ns = 0;
    for (i64 v = 0; v < n; ++v) if (where[v] == 2) order[ns++] = v;
    for (i64 i = ns - 1; i > 0; --i)
      std::swap(order[i], order[rng.below(i + 1)]);
    for (i64 oi = 0; oi < ns; ++oi) {
      i64 v = order[oi];
      if (where[v] != 2) continue;
      i64 pullA = 0, pullB = 0;  // weight pulled into S if v moves
      for (i64 p = g.xadj[v]; p < g.xadj[v + 1]; ++p) {
        i64 u = g.adj[p];
        if (where[u] == 0) pullB += g.vwgt[u];   // v->B pulls A-nbrs
        else if (where[u] == 1) pullA += g.vwgt[u];  // v->A pulls B-nbrs
      }
      i64 gA = g.vwgt[v] - pullA, gB = g.vwgt[v] - pullB;
      // prefer the higher gain; tie-break toward the lighter side
      int side = -1;
      if (gA > 0 && (gA > gB || (gA == gB && wa <= wb))) side = 0;
      else if (gB > 0) side = 1;
      else if (gA == 0 && wa + g.vwgt[v] < wb) side = 0;
      else if (gB == 0 && wb + g.vwgt[v] < wa) side = 1;
      if (side < 0) continue;
      // balance guard: do not overload a side
      i64 grow = g.vwgt[v];
      if (side == 0 && 2 * (wa + grow) > (i64)(1.4 * total)) continue;
      if (side == 1 && 2 * (wb + grow) > (i64)(1.4 * total)) continue;
      where[v] = side;
      if (side == 0) wa += g.vwgt[v]; else wb += g.vwgt[v];
      for (i64 p = g.xadj[v]; p < g.xadj[v + 1]; ++p) {
        i64 u = g.adj[p];
        if (where[u] == (side ^ 1)) {
          where[u] = 2;
          if (side == 0) wb -= g.vwgt[u]; else wa -= g.vwgt[u];
        }
      }
      improved = true;
    }
    if (!improved) break;
  }
}

// Multilevel edge bisection of the induced subgraph over ids, then minimum
// vertex cover separator.  Outputs global-id lists.
static void bisect_ml(const i64* rowptr, const i64* colind,
                      const std::vector<i64>& ids, std::vector<i64>& g2l,
                      Rng& rng, std::vector<i64>& left,
                      std::vector<i64>& right, std::vector<i64>& sep) {
  i64 n = (i64)ids.size();
  // induced subgraph with local ids
  Graph g0;
  g0.n = n; g0.vwgt.assign(n, 1); g0.xadj.assign(n + 1, 0);
  for (i64 i = 0; i < n; ++i) g2l[ids[i]] = i;
  for (i64 i = 0; i < n; ++i) {
    i64 v = ids[i];
    for (i64 p = rowptr[v]; p < rowptr[v + 1]; ++p) {
      i64 u = colind[p];
      if (u != v && g2l[u] >= 0) {
        g0.adj.push_back(g2l[u]);
        g0.ewgt.push_back(1);
      }
    }
    g0.xadj[i + 1] = (i64)g0.adj.size();
  }

  // coarsening chain
  std::vector<Graph> graphs;
  std::vector<std::vector<i64>> cmaps;
  graphs.push_back(std::move(g0));
  const i64 COARSE_N = 96;
  while (graphs.back().n > COARSE_N) {
    std::vector<i64> cmap;
    i64 nc = hem_match(graphs.back(), cmap, rng);
    if (nc > (i64)(0.95 * graphs.back().n)) break;  // stalled
    Graph gc;
    contract(graphs.back(), cmap, nc, gc);
    cmaps.push_back(std::move(cmap));
    graphs.push_back(std::move(gc));
  }

  // initial partition on the coarsest graph: best of 6 greedy growings
  Graph& gc = graphs.back();
  std::vector<i64> part, bestp;
  i64 bestcut = -1;
  for (int t = 0; t < 6; ++t) {
    i64 cut = grow_bisect(gc, part, rng);
    fm_refine(gc, part, 3);
    i64 c2 = 0;
    for (i64 v = 0; v < gc.n; ++v)
      for (i64 p = gc.xadj[v]; p < gc.xadj[v + 1]; ++p)
        if (part[v] != part[gc.adj[p]]) c2 += gc.ewgt[p];
    c2 /= 2; (void)cut;
    if (bestcut < 0 || c2 < bestcut) { bestcut = c2; bestp = part; }
  }
  part = bestp;

  // uncoarsen with edge-cut FM refinement per level, then convert the
  // finest bipartition to a vertex separator (Koenig cover) and shrink it
  // with node-FM (METIS node refinement role)
  for (i64 l = (i64)graphs.size() - 2; l >= 0; --l) {
    std::vector<i64> pf(graphs[l].n);
    for (i64 v = 0; v < graphs[l].n; ++v) pf[v] = part[cmaps[l][v]];
    part = std::move(pf);
    fm_refine(graphs[l], part, 2);
  }
  std::vector<i64> where = vertex_cover_sep(graphs[0], part);
  refine_sep(graphs[0], where, rng, 4);
  left.clear(); right.clear(); sep.clear();
  for (i64 v = 0; v < n; ++v) {
    if (where[v] == 2) sep.push_back(ids[v]);
    else if (where[v] == 0) left.push_back(ids[v]);
    else right.push_back(ids[v]);
  }
  for (i64 i = 0; i < n; ++i) g2l[ids[i]] = -1;  // reset scatter buffer
}

static i64 nd_rec_ml(NDBuilder& B, const i64* rowptr, const i64* colind,
                     std::vector<i64>& ids, std::vector<i64>& g2l,
                     Rng& rng, i64 leaf) {
  i64 m = (i64)ids.size();
  if (m <= leaf) {
    i64 lo = B.emit(ids);
    return B.add_node(lo, B.count, -1, -1);
  }
  std::vector<i64> left, right, sep;
  bisect_ml(rowptr, colind, ids, g2l, rng, left, right, sep);
  if ((left.empty() || right.empty()) && sep.empty()) {
    i64 lo = B.emit(ids);
    return B.add_node(lo, B.count, -1, -1);
  }
  // degenerate split (one side empty): emit the other side as one leaf tree
  i64 l = -1, r = -1;
  { std::vector<i64>().swap(ids); }  // release before recursion
  if (!left.empty())
    l = nd_rec_ml(B, rowptr, colind, left, g2l, rng, leaf);
  if (!right.empty())
    r = nd_rec_ml(B, rowptr, colind, right, g2l, rng, leaf);
  i64 lo = B.emit(sep);
  return B.add_node(lo, B.count, l, r);
}

}  // namespace ml

// Returns number of separators; fills malloc'd arrays.
i64 nested_dissection(i64 n, const i64* rowptr, const i64* colind, i64 leaf,
                      i64** out_perm, i64** out_sb, i64** out_se,
                      i64** out_par, i64** out_lc, i64** out_rc) {
  NDBuilder B;
  std::vector<i64> ids(n), mark(n, -1), lev(n, -1);
  for (i64 i = 0; i < n; ++i) ids[i] = i;
  nd_rec(B, rowptr, colind, ids, mark, lev, 0, leaf);
  i64 ns = (i64)B.sb.size();
  auto cpy = [](const std::vector<i64>& v) {
    i64* p = (i64*)malloc(sizeof(i64) * std::max<size_t>(v.size(), 1));
    std::memcpy(p, v.data(), sizeof(i64) * v.size());
    return p;
  };
  *out_perm = cpy(B.perm);
  *out_sb = cpy(B.sb);
  *out_se = cpy(B.se);
  *out_par = cpy(B.par);
  *out_lc = cpy(B.lc);
  *out_rc = cpy(B.rc);
  return ns;
}

// Multilevel vertex-separator ND (METIS_NodeND role).  Same output
// convention as nested_dissection.
i64 nested_dissection_ml(i64 n, const i64* rowptr, const i64* colind,
                         i64 leaf, i64** out_perm, i64** out_sb,
                         i64** out_se, i64** out_par, i64** out_lc,
                         i64** out_rc) {
  NDBuilder B;
  std::vector<i64> ids(n), g2l(n, -1);
  for (i64 i = 0; i < n; ++i) ids[i] = i;
  ml::Rng rng(0x9e3779b97f4a7c15ull);
  ml::nd_rec_ml(B, rowptr, colind, ids, g2l, rng, leaf);
  i64 ns = (i64)B.sb.size();
  auto cpy = [](const std::vector<i64>& v) {
    i64* p = (i64*)malloc(sizeof(i64) * std::max<size_t>(v.size(), 1));
    std::memcpy(p, v.data(), sizeof(i64) * v.size());
    return p;
  };
  *out_perm = cpy(B.perm);
  *out_sb = cpy(B.sb);
  *out_se = cpy(B.se);
  *out_par = cpy(B.par);
  *out_lc = cpy(B.lc);
  *out_rc = cpy(B.rc);
  return ns;
}

// ---------------------------------------------------------------------------
// Quotient-graph minimum-degree ordering (AMD / MMD roles).
//
// Role of the reference's minimum_degree/amdbar.F (Amestoy-Davis-Duff
// approximate minimum degree) and genmmd/mmd*.F (Liu's multiple minimum
// degree) — re-implemented from the published algorithm, not translated:
// the eliminated pivot becomes an ELEMENT whose boundary Lp is the union
// of its variable neighbors and its absorbed elements' boundaries; each
// boundary variable keeps (pruned variable list, element list) and an
// APPROXIMATE external degree  d(v) <= |Av| + |Lp \ v| + sum |Le \ Lp|
// computed with the one-scan w[] trick.  Elements emptied by the scan
// (Le subset of Lp) are aggressively absorbed.  `multiple` != 0 runs the
// MMD variant: an independent set of minimum-degree pivots is eliminated
// per outer step before degrees refresh.
//
// Returns perm[new] = old in *out_perm (malloc'd, n entries).
// ---------------------------------------------------------------------------
i64 min_degree_order(i64 n, const i64* rowptr, const i64* colind,
                     int multiple, i64** out_perm) {
  std::vector<std::vector<int>> Av((size_t)n), Ev((size_t)n), Le;
  std::vector<char> dead((size_t)n, 0);   // eliminated OR merged variable
  std::vector<char> edead;                // absorbed element
  std::vector<i64> degree((size_t)n, 0);
  std::vector<i64> nv((size_t)n, 1);      // supervariable weights
  std::vector<int> mchild((size_t)n, -1), mnext((size_t)n, -1);
  // build adjacency (symmetric union, diagonal dropped)
  for (i64 i = 0; i < n; ++i)
    for (i64 p = rowptr[i]; p < rowptr[i + 1]; ++p) {
      i64 j = colind[p];
      if (j != i && j >= 0 && j < n) {
        Av[(size_t)i].push_back((int)j);
        Av[(size_t)j].push_back((int)i);
      }
    }
  for (i64 i = 0; i < n; ++i) {
    auto& a = Av[(size_t)i];
    std::sort(a.begin(), a.end());
    a.erase(std::unique(a.begin(), a.end()), a.end());
    degree[(size_t)i] = (i64)a.size();
  }
  // lazy min-heap of (degree, vertex)
  using Q = std::pair<i64, int>;
  std::priority_queue<Q, std::vector<Q>, std::greater<Q>> heap;
  for (i64 i = 0; i < n; ++i) heap.push({degree[(size_t)i], (int)i});

  std::vector<i64> mark((size_t)n, 0);        // Lp membership stamp
  i64 stamp = 0;
  std::vector<i64> wstamp, wval;              // per-element |Le \ Lp| scan
  i64* perm = (i64*)malloc(sizeof(i64) * (size_t)std::max<i64>(n, 1));
  i64 np = 0;
  std::vector<int> Lp, batch;
  std::vector<std::pair<uint64_t, int>> hashes;

  auto emit = [&](int p) {   // output p and its merged chain (DFS)
    std::vector<int> st{p};
    while (!st.empty()) {
      int v = st.back();
      st.pop_back();
      perm[np++] = v;
      for (int c = mchild[(size_t)v]; c >= 0; c = mnext[(size_t)c])
        st.push_back(c);
    }
  };

  auto eliminate = [&](int p) {
    // Lp = (Av(p) u union Le(e), e in Ev(p)) \ {p, dead}
    ++stamp;
    Lp.clear();
    i64 nvLp = 0;
    mark[(size_t)p] = stamp;
    for (int u : Av[(size_t)p])
      if (!dead[(size_t)u] && mark[(size_t)u] != stamp) {
        mark[(size_t)u] = stamp;
        Lp.push_back(u);
        nvLp += nv[(size_t)u];
      }
    for (int e : Ev[(size_t)p]) {
      if (edead[(size_t)e]) continue;
      for (int u : Le[(size_t)e])
        if (!dead[(size_t)u] && mark[(size_t)u] != stamp) {
          mark[(size_t)u] = stamp;
          Lp.push_back(u);
          nvLp += nv[(size_t)u];
        }
      edead[(size_t)e] = 1;                   // absorbed into new element
    }
    dead[(size_t)p] = 1;
    emit(p);
    Av[(size_t)p].clear();
    Av[(size_t)p].shrink_to_fit();
    Ev[(size_t)p].clear();
    if (Lp.empty()) return;
    int ep = (int)Le.size();
    Le.push_back(Lp);
    edead.push_back(0);
    wstamp.resize(Le.size(), 0);
    wval.resize(Le.size(), 0);
    // one scan: wval[e] = weight of Le(e) \ Lp for elements touching Lp
    for (int v : Lp)
      for (int e : Ev[(size_t)v]) {
        if (edead[(size_t)e]) continue;
        if (wstamp[(size_t)e] != stamp) {
          wstamp[(size_t)e] = stamp;
          auto& le = Le[(size_t)e];           // compact to live entries
          size_t kk = 0;
          i64 wt = 0;
          for (int u : le)
            if (!dead[(size_t)u]) {
              le[kk++] = u;
              wt += nv[(size_t)u];
            }
          le.resize(kk);
          wval[(size_t)e] = wt;
        }
        wval[(size_t)e] -= nv[(size_t)v];
      }
    hashes.clear();
    for (int v : Lp) {
      // prune: drop eliminated vars and Lp members (covered by ep)
      auto& a = Av[(size_t)v];
      size_t k = 0;
      i64 nva = 0;
      uint64_t h = 0;
      for (int u : a)
        if (!dead[(size_t)u] && mark[(size_t)u] != stamp) {
          a[k++] = u;
          nva += nv[(size_t)u];
          h += (uint64_t)u * 0x9e3779b97f4a7c15ull;
        }
      a.resize(k);
      // element list: drop absorbed, aggressively absorb empty, add ep
      auto& el = Ev[(size_t)v];
      size_t m = 0;
      i64 dsum = 0;
      for (int e : el) {
        if (edead[(size_t)e]) continue;
        if (wstamp[(size_t)e] == stamp && wval[(size_t)e] <= 0) {
          edead[(size_t)e] = 1;               // Le subset of Lp: absorb
          continue;
        }
        el[m++] = e;
        h += (uint64_t)(e + n) * 0xc2b2ae3d27d4eb4full;
        dsum += (wstamp[(size_t)e] == stamp) ? wval[(size_t)e]
                                             : (i64)Le[(size_t)e].size();
      }
      el.resize(m);
      el.push_back(ep);
      i64 d = nva + (nvLp - nv[(size_t)v]) + dsum;
      degree[(size_t)v] = std::min(d, n - np);
      hashes.push_back({h, v});
    }
    // supervariable detection: equal hash -> verify identical
    // (Av, Ev \ {ep}) lists -> merge w into v (amdbar.F role)
    std::sort(hashes.begin(), hashes.end());
    for (size_t i0 = 0; i0 < hashes.size();) {
      size_t i1 = i0 + 1;
      while (i1 < hashes.size() && hashes[i1].first == hashes[i0].first)
        ++i1;
      for (size_t ii = i0; ii + 1 < i1; ++ii) {
        int v = hashes[ii].second;
        if (dead[(size_t)v]) continue;
        for (size_t jj = ii + 1; jj < i1; ++jj) {
          int w = hashes[jj].second;
          if (dead[(size_t)w]) continue;
          auto &av = Av[(size_t)v], &aw = Av[(size_t)w];
          auto &evv = Ev[(size_t)v], &evw = Ev[(size_t)w];
          if (av.size() != aw.size() || evv.size() != evw.size())
            continue;
          ++stamp;   // mark-compare the two adjacency lists as sets
          for (int u : av) mark[(size_t)u] = stamp;
          mark[(size_t)v] = stamp;   // allow mutual adjacency v<->w
          bool same = true;
          for (int u : aw)
            if (mark[(size_t)u] != stamp && u != w) { same = false; break; }
          if (same) {
            std::sort(evv.begin(), evv.end());
            std::sort(evw.begin(), evw.end());
            same = evv == evw;
          }
          if (!same) continue;
          nv[(size_t)v] += nv[(size_t)w];     // merge w into v
          dead[(size_t)w] = 1;
          mnext[(size_t)w] = mchild[(size_t)v];
          mchild[(size_t)v] = w;
          Av[(size_t)w].clear();
          Av[(size_t)w].shrink_to_fit();
          Ev[(size_t)w].clear();
        }
      }
      i0 = i1;
    }
    for (int v : Lp)
      if (!dead[(size_t)v]) heap.push({degree[(size_t)v], v});
  };

  while (np < n) {
    if (heap.empty()) {                       // isolated leftovers
      for (i64 i = 0; i < n; ++i)
        if (!dead[(size_t)i]) {
          dead[(size_t)i] = 1;
          emit((int)i);
        }
      break;
    }
    auto [d, p] = heap.top();
    heap.pop();
    if (dead[(size_t)p] || d != degree[(size_t)p]) continue;
    if (!multiple) {
      eliminate(p);
      continue;
    }
    // MMD: gather an independent set of min-degree pivots, then
    // eliminate them all before any pushed degree updates take effect
    batch.clear();
    batch.push_back(p);
    ++stamp;
    for (int u : Av[(size_t)p]) mark[(size_t)u] = stamp;
    for (int e : Ev[(size_t)p])
      if (!edead[(size_t)e])
        for (int u : Le[(size_t)e]) mark[(size_t)u] = stamp;
    while (!heap.empty() && heap.top().first == d) {
      auto [d2, q] = heap.top();
      if (dead[(size_t)q] || d2 != degree[(size_t)q]) {
        heap.pop();
        continue;
      }
      if (mark[(size_t)q] == stamp) break;    // adjacent to the batch
      heap.pop();
      batch.push_back(q);
      for (int u : Av[(size_t)q]) mark[(size_t)u] = stamp;
      for (int e : Ev[(size_t)q])
        if (!edead[(size_t)e])
          for (int u : Le[(size_t)e]) mark[(size_t)u] = stamp;
    }
    for (int q : batch)
      if (!dead[(size_t)q]) eliminate(q);
  }
  *out_perm = perm;
  return np;
}

// ---------------------------------------------------------------------------
// Minimum local fill ordering (the reference's ReorderingStrategy::MLF,
// StrumpackOptions.hpp): greedily eliminate the vertex whose elimination
// adds the fewest new edges.  Explicit-adjacency formulation with a lazy
// heap: entries carry a per-vertex version counter; eliminations bump the
// version of every vertex whose fill may have changed (the eliminated
// vertex's neighborhood plus its neighbors' neighbors — any vertex
// adjacent to a newly added clique edge), and stale pops recompute the
// exact fill and re-push.  Exact greedy, no approximation.
//
// Returns perm[new] = old in *out_perm (malloc'd, n entries).
// ---------------------------------------------------------------------------
i64 min_fill_order(i64 n, const i64* rowptr, const i64* colind,
                   i64** out_perm) {
  std::vector<std::vector<int>> adj((size_t)n);
  for (i64 i = 0; i < n; ++i)
    for (i64 p = rowptr[i]; p < rowptr[i + 1]; ++p) {
      i64 j = colind[p];
      if (j != i && j >= 0 && j < n) {
        adj[(size_t)i].push_back((int)j);
        adj[(size_t)j].push_back((int)i);
      }
    }
  for (i64 i = 0; i < n; ++i) {
    auto& a = adj[(size_t)i];
    std::sort(a.begin(), a.end());
    a.erase(std::unique(a.begin(), a.end()), a.end());
  }
  std::vector<char> dead((size_t)n, 0);
  std::vector<i64> ver((size_t)n, 0), mark((size_t)n, 0);
  i64 stamp = 0;

  auto fill_of = [&](int v) -> i64 {
    // missing edges among live neighbors of v: for each neighbor u,
    // stamp N(u); count pairs (u, w) in N(v) with w > u not stamped
    auto& av = adj[(size_t)v];
    i64 miss = 0;
    for (size_t iu = 0; iu < av.size(); ++iu) {
      int u = av[iu];
      ++stamp;
      for (int w : adj[(size_t)u]) mark[(size_t)w] = stamp;
      for (size_t iw = iu + 1; iw < av.size(); ++iw)
        if (mark[(size_t)av[iw]] != stamp) ++miss;
    }
    return miss;
  };

  struct Ent { i64 f, d; int v; i64 ver; };
  struct Cmp {
    bool operator()(const Ent& a, const Ent& b) const {
      if (a.f != b.f) return a.f > b.f;
      if (a.d != b.d) return a.d > b.d;
      return a.v > b.v;
    }
  };
  std::priority_queue<Ent, std::vector<Ent>, Cmp> heap;
  for (i64 i = 0; i < n; ++i)
    heap.push({fill_of((int)i), (i64)adj[(size_t)i].size(), (int)i, 0});

  i64* perm = (i64*)malloc(sizeof(i64) * (size_t)std::max<i64>(n, 1));
  i64 np = 0;
  std::vector<int> tmp;
  while (np < n) {
    if (heap.empty()) {
      for (i64 i = 0; i < n; ++i)
        if (!dead[(size_t)i]) { dead[(size_t)i] = 1; perm[np++] = i; }
      break;
    }
    Ent e = heap.top();
    heap.pop();
    int v = e.v;
    if (dead[(size_t)v]) continue;
    if (e.ver != ver[(size_t)v]) {           // stale: recompute + re-push
      heap.push({fill_of(v), (i64)adj[(size_t)v].size(), v,
                 ver[(size_t)v]});
      continue;
    }
    dead[(size_t)v] = 1;
    perm[np++] = v;
    auto nbrs = adj[(size_t)v];              // copy: adj[v] mutates below
    // clique the neighbors; remove v from each list
    for (int u : nbrs) {
      auto& au = adj[(size_t)u];
      // au = (au u nbrs) \ {u, v}, sorted-merge
      tmp.clear();
      tmp.reserve(au.size() + nbrs.size());
      size_t ia = 0, ib = 0;
      while (ia < au.size() || ib < nbrs.size()) {
        int x;
        if (ib >= nbrs.size() || (ia < au.size() && au[ia] <= nbrs[ib])) {
          x = au[ia];
          if (ib < nbrs.size() && nbrs[ib] == x) ++ib;
          ++ia;
        } else {
          x = nbrs[ib++];
        }
        if (x != u && x != v && !dead[(size_t)x]) tmp.push_back(x);
      }
      au = tmp;
      ++ver[(size_t)u];
      // fill of u's neighbors can change too (new clique edges land
      // inside their neighborhoods)
      for (int w : au) ++ver[(size_t)w];
    }
    for (int u : nbrs)
      heap.push({fill_of(u), (i64)adj[(size_t)u].size(), u,
                 ver[(size_t)u]});
  }
  *out_perm = perm;
  return np;
}

void hostsym_free(i64* p) { free(p); }

}  // extern "C"
