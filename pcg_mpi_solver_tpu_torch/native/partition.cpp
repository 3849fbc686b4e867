// Native graph partitioner of pcg_mpi_solver_tpu_torch: a copy of the JAX
// package's native/src/partition.cpp, algorithm for algorithm, so that the
// same inputs and seed give the same part map (tests/test_torch_native.py
// holds the two libraries array for array).
//
// The replacement for the reference's METIS dual-graph partition call
// (reference: src/solver/run_metis.py:84-88, `metis.part_mesh_dual`):
//
//   * dual-graph construction from the element->node CSR (elements adjacent
//     iff they share >= ncommon nodes),
//   * multilevel recursive-bisection k-way partitioning:
//       coarsen by heavy-edge matching -> BFS region-growing bisection of the
//       coarsest graph -> uncoarsen with Fiduccia–Mattheyses boundary
//       refinement at every level.
//
// Exposed as a tiny C ABI consumed via ctypes (pcg_mpi_solver_tpu_torch/
// native.py builds it with g++ at first use).

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <numeric>
#include <queue>
#include <random>
#include <vector>

namespace {

using i64 = int64_t;
using i32 = int32_t;

struct Graph {
  i64 n = 0;
  std::vector<i64> xadj;    // n+1
  std::vector<i64> adjncy;  // nnz
  std::vector<i64> adjwgt;  // nnz (edge weights)
  std::vector<i64> vwgt;    // n   (vertex weights)
  i64 total_vwgt = 0;
};

// ---------------------------------------------------------------------------
// Coarsening: heavy-edge matching
// ---------------------------------------------------------------------------

Graph coarsen(const Graph& g, std::vector<i64>& cmap, std::mt19937_64& rng) {
  const i64 n = g.n;
  cmap.assign(n, -1);
  std::vector<i64> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::shuffle(order.begin(), order.end(), rng);

  i64 nc = 0;
  // Heavy-edge matching: visit vertices in random order, match each unmatched
  // vertex with its unmatched neighbour of maximum edge weight.
  for (i64 oi = 0; oi < n; ++oi) {
    const i64 v = order[oi];
    if (cmap[v] >= 0) continue;
    i64 best = -1, bestw = -1;
    for (i64 e = g.xadj[v]; e < g.xadj[v + 1]; ++e) {
      const i64 u = g.adjncy[e];
      if (u == v || cmap[u] >= 0) continue;
      if (g.adjwgt[e] > bestw) { bestw = g.adjwgt[e]; best = u; }
    }
    cmap[v] = nc;
    if (best >= 0) cmap[best] = nc;
    ++nc;
  }

  Graph cg;
  cg.n = nc;
  cg.vwgt.assign(nc, 0);
  for (i64 v = 0; v < n; ++v) cg.vwgt[cmap[v]] += g.vwgt[v];
  cg.total_vwgt = g.total_vwgt;

  // Build coarse adjacency by merging fine edges; dedupe with a stamp array.
  std::vector<i64> stamp(nc, -1), slot(nc, 0);
  std::vector<std::pair<i64, i64>> buf;  // (coarse neighbour, weight) scratch
  std::vector<std::vector<i64>> members(nc);
  for (i64 v = 0; v < n; ++v) members[cmap[v]].push_back(v);

  std::vector<i64> cxadj(nc + 1, 0);
  std::vector<i64> cadj, cwgt;
  cadj.reserve(g.adjncy.size());
  cwgt.reserve(g.adjncy.size());
  for (i64 c = 0; c < nc; ++c) {
    buf.clear();
    for (i64 v : members[c]) {
      for (i64 e = g.xadj[v]; e < g.xadj[v + 1]; ++e) {
        const i64 cu = cmap[g.adjncy[e]];
        if (cu == c) continue;
        if (stamp[cu] != c) {
          stamp[cu] = c;
          slot[cu] = (i64)buf.size();
          buf.emplace_back(cu, g.adjwgt[e]);
        } else {
          buf[slot[cu]].second += g.adjwgt[e];
        }
      }
    }
    for (auto& [cu, w] : buf) { cadj.push_back(cu); cwgt.push_back(w); }
    cxadj[c + 1] = (i64)cadj.size();
  }
  cg.xadj = std::move(cxadj);
  cg.adjncy = std::move(cadj);
  cg.adjwgt = std::move(cwgt);
  return cg;
}

// ---------------------------------------------------------------------------
// Initial bisection: BFS region growing from a pseudo-peripheral vertex
// ---------------------------------------------------------------------------

i64 pseudo_peripheral(const Graph& g, i64 start) {
  std::vector<i32> dist(g.n, -1);
  i64 far = start;
  for (int it = 0; it < 3; ++it) {
    std::fill(dist.begin(), dist.end(), -1);
    std::queue<i64> q;
    q.push(far);
    dist[far] = 0;
    i64 last = far;
    while (!q.empty()) {
      const i64 v = q.front(); q.pop();
      last = v;
      for (i64 e = g.xadj[v]; e < g.xadj[v + 1]; ++e) {
        const i64 u = g.adjncy[e];
        if (dist[u] < 0) { dist[u] = dist[v] + 1; q.push(u); }
      }
    }
    if (last == far) break;
    far = last;
  }
  return far;
}

// Grow side 0 by best-connected frontier expansion until it holds
// ~target_wgt; everything else is side 1.
void grow_bisection(const Graph& g, i64 target_wgt, std::vector<i32>& side) {
  side.assign(g.n, 1);
  if (g.n == 0) return;
  const i64 seed = pseudo_peripheral(g, 0);
  // Max-priority by connection weight to the growing region.
  std::priority_queue<std::pair<i64, i64>> pq;  // (gain, vertex)
  std::vector<i64> conn(g.n, 0);
  std::vector<char> in(g.n, 0);
  pq.emplace(0, seed);
  i64 w0 = 0;
  while (!pq.empty() && w0 < target_wgt) {
    const auto [gain, v] = pq.top(); pq.pop();
    if (in[v] || gain < conn[v]) continue;  // stale entry
    in[v] = 1;
    side[v] = 0;
    w0 += g.vwgt[v];
    for (i64 e = g.xadj[v]; e < g.xadj[v + 1]; ++e) {
      const i64 u = g.adjncy[e];
      if (in[u]) continue;
      conn[u] += g.adjwgt[e];
      pq.emplace(conn[u], u);
    }
  }
  // Disconnected remainder: if we ran out of frontier early, sweep linearly.
  if (w0 < target_wgt) {
    for (i64 v = 0; v < g.n && w0 < target_wgt; ++v) {
      if (!in[v]) { in[v] = 1; side[v] = 0; w0 += g.vwgt[v]; }
    }
  }
}

// ---------------------------------------------------------------------------
// FM boundary refinement (2-way)
// ---------------------------------------------------------------------------

void fm_refine(const Graph& g, std::vector<i32>& side, i64 target0,
               double eps, int max_passes) {
  const i64 n = g.n;
  i64 w[2] = {0, 0};
  for (i64 v = 0; v < n; ++v) w[side[v]] += g.vwgt[v];
  const i64 total = w[0] + w[1];
  const i64 lo0 = (i64)((1.0 - eps) * (double)target0);
  const i64 hi0 = (i64)((1.0 + eps) * (double)target0);

  std::vector<i64> gain(n);
  std::vector<char> locked(n);

  auto compute_gain = [&](i64 v) {
    i64 in = 0, ex = 0;
    for (i64 e = g.xadj[v]; e < g.xadj[v + 1]; ++e) {
      if (side[g.adjncy[e]] == side[v]) in += g.adjwgt[e];
      else ex += g.adjwgt[e];
    }
    return ex - in;
  };

  for (int pass = 0; pass < max_passes; ++pass) {
    std::fill(locked.begin(), locked.end(), 0);
    // Initialize every gain (incremental deltas during the pass assume it),
    // seed the queue with boundary vertices only.
    std::priority_queue<std::pair<i64, i64>> pq;
    for (i64 v = 0; v < n; ++v) {
      gain[v] = compute_gain(v);
      for (i64 e = g.xadj[v]; e < g.xadj[v + 1]; ++e) {
        if (side[g.adjncy[e]] != side[v]) { pq.emplace(gain[v], v); break; }
      }
    }

    std::vector<i64> moves;
    i64 cum = 0, best_cum = 0;
    i64 best_prefix = 0;
    i64 moves_limit = std::max<i64>(64, n / 4);
    while (!pq.empty() && (i64)moves.size() < moves_limit) {
      const auto [gv, v] = pq.top(); pq.pop();
      if (locked[v] || gv != gain[v]) continue;
      // Balance feasibility of moving v to the other side.
      const i32 s = side[v];
      i64 nw0 = w[0] + (s == 1 ? g.vwgt[v] : -g.vwgt[v]);
      if (nw0 < lo0 || nw0 > hi0) {
        // Allow the move only if it strictly improves balance.
        if (std::llabs(nw0 - target0) >= std::llabs(w[0] - target0)) continue;
      }
      locked[v] = 1;
      side[v] = 1 - s;
      w[0] = nw0;
      w[1] = total - nw0;
      moves.push_back(v);
      cum += gv;
      if (cum > best_cum) { best_cum = cum; best_prefix = (i64)moves.size(); }
      // Incremental FM gain delta: v moved from side s to 1-s, so an edge
      // (v,u) flips between internal and external for u.
      for (i64 e = g.xadj[v]; e < g.xadj[v + 1]; ++e) {
        const i64 u = g.adjncy[e];
        if (locked[u]) continue;
        gain[u] += (side[u] == s ? 2 : -2) * g.adjwgt[e];
        pq.emplace(gain[u], u);
      }
    }
    // Roll back the suffix after the best prefix.
    for (i64 i = (i64)moves.size() - 1; i >= best_prefix; --i) {
      const i64 v = moves[i];
      const i32 s = side[v];
      side[v] = 1 - s;
      w[side[v]] += g.vwgt[v];
      w[s] -= g.vwgt[v];
    }
    if (best_cum <= 0) break;
  }
}

// ---------------------------------------------------------------------------
// Multilevel bisection + recursion
// ---------------------------------------------------------------------------

void multilevel_bisect(const Graph& g, i64 target0, std::vector<i32>& side,
                       std::mt19937_64& rng) {
  constexpr i64 kCoarsestN = 128;
  if (g.n <= kCoarsestN) {
    grow_bisection(g, target0, side);
    fm_refine(g, side, target0, 0.02, 8);
    return;
  }
  std::vector<i64> cmap;
  Graph cg = coarsen(g, cmap, rng);
  if (cg.n >= g.n * 95 / 100) {
    // Matching stalled (e.g. star graphs): stop coarsening here.
    grow_bisection(g, target0, side);
    fm_refine(g, side, target0, 0.02, 8);
    return;
  }
  std::vector<i32> cside;
  multilevel_bisect(cg, target0, cside, rng);
  side.resize(g.n);
  for (i64 v = 0; v < g.n; ++v) side[v] = cside[cmap[v]];
  fm_refine(g, side, target0, 0.02, 4);
}

// Extract the subgraph induced by vertices with mask[v]==keep.
Graph subgraph(const Graph& g, const std::vector<i32>& side, i32 keep,
               std::vector<i64>& orig_ids) {
  Graph s;
  std::vector<i64> newid(g.n, -1);
  orig_ids.clear();
  for (i64 v = 0; v < g.n; ++v) {
    if (side[v] == keep) {
      newid[v] = (i64)orig_ids.size();
      orig_ids.push_back(v);
    }
  }
  s.n = (i64)orig_ids.size();
  s.xadj.assign(s.n + 1, 0);
  s.vwgt.resize(s.n);
  for (i64 i = 0; i < s.n; ++i) {
    const i64 v = orig_ids[i];
    s.vwgt[i] = g.vwgt[v];
    s.total_vwgt += g.vwgt[v];
    for (i64 e = g.xadj[v]; e < g.xadj[v + 1]; ++e)
      if (newid[g.adjncy[e]] >= 0) ++s.xadj[i + 1];
  }
  for (i64 i = 0; i < s.n; ++i) s.xadj[i + 1] += s.xadj[i];
  s.adjncy.resize(s.xadj[s.n]);
  s.adjwgt.resize(s.xadj[s.n]);
  std::vector<i64> pos(s.xadj.begin(), s.xadj.end() - 1);
  for (i64 i = 0; i < s.n; ++i) {
    const i64 v = orig_ids[i];
    for (i64 e = g.xadj[v]; e < g.xadj[v + 1]; ++e) {
      const i64 u = newid[g.adjncy[e]];
      if (u >= 0) { s.adjncy[pos[i]] = u; s.adjwgt[pos[i]] = g.adjwgt[e]; ++pos[i]; }
    }
  }
  return s;
}

void recursive_partition(const Graph& g, int n_parts, int part0,
                         const std::vector<i64>& orig_ids, i32* part_out,
                         std::mt19937_64& rng) {
  if (n_parts == 1 || g.n == 0) {
    for (i64 v = 0; v < g.n; ++v) part_out[orig_ids[v]] = (i32)part0;
    return;
  }
  const int n_left = n_parts / 2;
  const i64 target0 = (i64)((double)g.total_vwgt * (double)n_left / (double)n_parts);
  std::vector<i32> side;
  multilevel_bisect(g, target0, side, rng);

  std::vector<i64> ids0, ids1;
  Graph g0 = subgraph(g, side, 0, ids0);
  Graph g1 = subgraph(g, side, 1, ids1);
  for (auto& id : ids0) id = orig_ids[id];
  for (auto& id : ids1) id = orig_ids[id];
  recursive_partition(g0, n_left, part0, ids0, part_out, rng);
  recursive_partition(g1, n_parts - n_left, part0 + n_left, ids1, part_out, rng);
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

// Partition a general graph (CSR) into n_parts; part_out must hold n int32.
// vwgt may be null (unit weights).  Returns 0 on success.
int pcgn_part_graph(i64 n, const i64* xadj, const i64* adjncy,
                    const i64* adjwgt, const i64* vwgt, int n_parts,
                    uint64_t seed, i32* part_out) {
  if (n < 0 || n_parts < 1) return 1;
  if (n_parts == 1 || n == 0) {
    for (i64 v = 0; v < n; ++v) part_out[v] = 0;
    return 0;
  }
  Graph g;
  g.n = n;
  g.xadj.assign(xadj, xadj + n + 1);
  g.adjncy.assign(adjncy, adjncy + xadj[n]);
  if (adjwgt) g.adjwgt.assign(adjwgt, adjwgt + xadj[n]);
  else g.adjwgt.assign(xadj[n], 1);
  if (vwgt) g.vwgt.assign(vwgt, vwgt + n);
  else g.vwgt.assign(n, 1);
  g.total_vwgt = std::accumulate(g.vwgt.begin(), g.vwgt.end(), (i64)0);

  std::vector<i64> ids(n);
  std::iota(ids.begin(), ids.end(), 0);
  std::mt19937_64 rng(seed);
  recursive_partition(g, n_parts, 0, ids, part_out, rng);
  return 0;
}

// Build the dual graph of a mesh (elements adjacent iff they share
// >= ncommon nodes) and partition it.  eptr/eind is the element->node CSR
// (eptr has n_elem+1 entries).  part_out must hold n_elem int32.
// Mirrors the call shape of METIS part_mesh_dual (run_metis.py:88).
int pcgn_part_mesh_dual(i64 n_elem, i64 n_node, const i64* eptr,
                        const i64* eind, int ncommon, int n_parts,
                        uint64_t seed, i32* part_out) {
  if (n_elem < 0 || n_parts < 1 || ncommon < 1) return 1;
  if (n_parts == 1 || n_elem == 0) {
    for (i64 e = 0; e < n_elem; ++e) part_out[e] = 0;
    return 0;
  }
  // node -> element inverse CSR
  std::vector<i64> ncnt(n_node + 1, 0);
  for (i64 i = 0; i < eptr[n_elem]; ++i) ++ncnt[eind[i] + 1];
  for (i64 i = 0; i < n_node; ++i) ncnt[i + 1] += ncnt[i];
  std::vector<i64> nelems(eptr[n_elem]);
  {
    std::vector<i64> pos(ncnt.begin(), ncnt.end() - 1);
    for (i64 e = 0; e < n_elem; ++e)
      for (i64 i = eptr[e]; i < eptr[e + 1]; ++i) nelems[pos[eind[i]]++] = e;
  }

  // Dual adjacency with shared-node counts (edge weight = #shared nodes).
  std::vector<i64> xadj(n_elem + 1, 0), adjncy, adjwgt;
  adjncy.reserve(n_elem * 6);
  adjwgt.reserve(n_elem * 6);
  std::vector<i64> stamp(n_elem, -1), cnt(n_elem, 0), touched;
  for (i64 e = 0; e < n_elem; ++e) {
    touched.clear();
    for (i64 i = eptr[e]; i < eptr[e + 1]; ++i) {
      const i64 nd = eind[i];
      for (i64 j = ncnt[nd]; j < ncnt[nd + 1]; ++j) {
        const i64 u = nelems[j];
        if (u == e) continue;
        if (stamp[u] != e) { stamp[u] = e; cnt[u] = 0; touched.push_back(u); }
        ++cnt[u];
      }
    }
    for (i64 u : touched) {
      if (cnt[u] >= ncommon) { adjncy.push_back(u); adjwgt.push_back(cnt[u]); }
    }
    xadj[e + 1] = (i64)adjncy.size();
  }

  return pcgn_part_graph(n_elem, xadj.data(), adjncy.data(), adjwgt.data(),
                         nullptr, n_parts, seed, part_out);
}

// Edge cut of a partition (diagnostics / tests).
i64 pcgn_edge_cut(i64 n, const i64* xadj, const i64* adjncy,
                  const i64* adjwgt, const i32* part) {
  i64 cut = 0;
  for (i64 v = 0; v < n; ++v)
    for (i64 e = xadj[v]; e < xadj[v + 1]; ++e)
      if (part[v] != part[adjncy[e]]) cut += adjwgt ? adjwgt[e] : 1;
  return cut / 2;
}

}  // extern "C"
