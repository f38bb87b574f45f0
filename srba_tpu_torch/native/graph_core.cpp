// srba_tpu native host graph service — C++ symbolic core.
//
// TPU-native equivalent of the reference's host-side spanning-tree /
// window-selection machinery (public MRPT/srba layout: the TSpanningTree
// symbolic structures of include/srba/srba_types.h, the incremental updates
// of impl/spantree_misc.h, and the window selection at the top of
// impl/optimize_local_area.h / optimize_edges.h).  The numeric side stays on
// device (the jitted solver recomposes poses from gathered edge values), so
// this extension is pure integer bookkeeping:
//
//   * append-only keyframe graph (KFs, kf2kf edges, adjacency),
//   * landmark registry (base KF, fixed flag) and observation log
//     (observer KF, landmark) with reverse indices,
//   * bounded-depth BFS spanning trees with epoch-stamped scratch (no
//     per-query allocation),
//   * the full optimization-window builder: one C call per keyframe emits
//     the padded int32 gather/scatter structure the device step consumes.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in the image).
// Ordering is bit-identical to the Python reference implementation in
// srba_tpu/graph/spantree.py + srba_tpu/solver/window.py (deterministic
// FIFO BFS with insertion-order adjacency; see tests/test_native_core.py).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Adj {
  int nb;    // neighbor keyframe
  int eid;   // edge id
};

struct Core {
  int max_tree_depth;
  int num_kfs = 0;
  std::vector<int> edge_a, edge_b;            // edge endpoints (a, b)
  std::vector<std::vector<Adj>> adjacency;    // per-KF, insertion order
  std::vector<int> lm_base;                   // per-landmark base KF
  std::vector<uint8_t> lm_fixed;
  std::vector<int> obs_kf, obs_lm;            // per-observation
  std::vector<std::vector<int>> kf_obs;       // reverse: KF -> obs ids
  std::vector<std::vector<int>> lm_obs;       // reverse: LM -> obs ids

  // Epoch-stamped BFS scratch (grown lazily; no clearing between queries).
  std::vector<int64_t> stamp;
  std::vector<int> dist, parent_kf, parent_eid;
  int64_t epoch = 0;
  std::vector<int> queue;

  explicit Core(int depth) : max_tree_depth(depth) {}

  void ensure_scratch() {
    if ((int)stamp.size() < num_kfs) {
      stamp.resize(num_kfs, -1);
      dist.resize(num_kfs);
      parent_kf.resize(num_kfs);
      parent_eid.resize(num_kfs);
    }
  }

  // Deterministic bounded BFS from root (FIFO, adjacency insertion order —
  // mirrors spantree.py::bfs_tree).  Results live in the epoch-stamped
  // scratch until the next bfs() call.  Returns the BFS visit order.
  const std::vector<int>& bfs(int root, int depth) {
    ensure_scratch();
    ++epoch;
    queue.clear();
    queue.push_back(root);
    stamp[root] = epoch;
    dist[root] = 0;
    parent_kf[root] = -1;
    parent_eid[root] = -1;
    for (size_t qi = 0; qi < queue.size(); ++qi) {
      int n = queue[qi];
      int d = dist[n];
      if (d >= depth) continue;
      for (const Adj& a : adjacency[n]) {
        if (stamp[a.nb] != epoch) {
          stamp[a.nb] = epoch;
          dist[a.nb] = d + 1;
          parent_kf[a.nb] = n;
          parent_eid[a.nb] = a.eid;
          queue.push_back(a.nb);
        }
      }
    }
    return queue;
  }

  bool reached(int n) const { return stamp[n] == epoch; }
};

}  // namespace

extern "C" {

void* srba_core_new(int max_tree_depth) { return new Core(max_tree_depth); }

void srba_core_free(void* h) { delete static_cast<Core*>(h); }

int srba_core_add_kf(void* h) {
  Core* c = static_cast<Core*>(h);
  c->adjacency.emplace_back();
  c->kf_obs.emplace_back();
  return c->num_kfs++;
}

int srba_core_add_edge(void* h, int a, int b) {
  Core* c = static_cast<Core*>(h);
  if (a == b || a < 0 || b < 0 || a >= c->num_kfs || b >= c->num_kfs)
    return -1;
  int eid = (int)c->edge_a.size();
  c->edge_a.push_back(a);
  c->edge_b.push_back(b);
  c->adjacency[a].push_back({b, eid});
  c->adjacency[b].push_back({a, eid});
  return eid;
}

int srba_core_add_lm(void* h, int base_kf, int fixed) {
  Core* c = static_cast<Core*>(h);
  c->lm_base.push_back(base_kf);
  c->lm_fixed.push_back((uint8_t)fixed);
  c->lm_obs.emplace_back();
  return (int)c->lm_base.size() - 1;
}

int srba_core_add_obs(void* h, int kf, int lm) {
  Core* c = static_cast<Core*>(h);
  if (kf < 0 || kf >= c->num_kfs || lm < 0 || lm >= (int)c->lm_base.size())
    return -1;
  int oid = (int)c->obs_kf.size();
  c->obs_kf.push_back(kf);
  c->obs_lm.push_back(lm);
  c->kf_obs[kf].push_back(oid);
  c->lm_obs[lm].push_back(oid);
  return oid;
}

int srba_core_num_edges(void* h) {
  return (int)static_cast<Core*>(h)->edge_a.size();
}

// Bounded BFS tree query (mirrors spantree.py::bfs_tree): fills per-reached-
// node arrays indexed by BFS visit order.  Returns the reached count
// (<= cap; if more reached than cap, returns -needed).
int srba_core_bfs_tree(void* h, int root, int depth, int cap,
                       int* out_node, int* out_dist,
                       int* out_parent, int* out_parent_eid) {
  Core* c = static_cast<Core*>(h);
  if (root < 0 || root >= c->num_kfs) return 0;
  const std::vector<int>& order = c->bfs(root, depth);
  if ((int)order.size() > cap) return -(int)order.size();
  for (size_t i = 0; i < order.size(); ++i) {
    int n = order[i];
    out_node[i] = n;
    out_dist[i] = c->dist[n];
    out_parent[i] = c->parent_kf[n];
    out_parent_eid[i] = c->parent_eid[n];
  }
  return (int)order.size();
}

// Shortest (spanning-tree) path src -> dst as (edge_id, sign) steps.
// Returns path length, -1 if unreachable within depth, -2 if cap too small.
int srba_core_path(void* h, int src, int dst, int depth,
                   int cap, int* out_eid, int* out_sign) {
  Core* c = static_cast<Core*>(h);
  if (src == dst) return 0;
  if (src < 0 || src >= c->num_kfs || dst < 0 || dst >= c->num_kfs) return -1;
  c->bfs(src, depth);
  if (!c->reached(dst)) return -1;
  int len = c->dist[dst];
  if (len > cap) return -2;
  int n = dst;
  for (int i = len - 1; i >= 0; --i) {
    int p = c->parent_kf[n];
    int eid = c->parent_eid[n];
    out_eid[i] = eid;
    out_sign[i] = (c->edge_a[eid] == p) ? 1 : -1;  // walking p -> n
    n = p;
  }
  return len;
}

// ---------------------------------------------------------------------------
// The per-keyframe window builder (mirrors solver/window.py::build_window).
//
// Emits, padded to the caller-chosen bucket capacities (cap_E/cap_L/cap_N):
//   edge_gids[cap_E], edge_opt[cap_E]       gather ids + unknown mask
//   lm_gids[cap_L],  lm_opt[cap_L]
//   obs_ids[cap_N]   global observation ids (pad = first real id, so the
//                    host obs_z gather reproduces window.py's pad rows)
//   obs_lm_local[cap_N], obs_valid[cap_N]
//   path_edge[cap_N * tree_depth], path_sign[cap_N * tree_depth]
// out_counts = {E_real, L_real, N_real}.
// obs_per_lm_cap > 0 keeps only the newest cap in-window observations per
// landmark (window-size bound: mirrors window.py's extra_obs_per_lm_cap).
// Returns 0 ok; -1 nothing to optimize; 1..3 = cap_E/cap_L/cap_N too small
// (out_counts then holds the required sizes; caller re-buckets and retries).
// ---------------------------------------------------------------------------
int srba_core_build_window(void* h, int root, int opt_depth, int tree_depth,
                           int cap_E, int cap_L, int cap_N,
                           int obs_per_lm_cap,
                           int* out_counts,
                           int* edge_gids, int* edge_opt,
                           int* lm_gids, int* lm_opt,
                           int* obs_ids, int* obs_lm_local, int* obs_valid,
                           int* path_edge, int* path_sign) {
  Core* c = static_cast<Core*>(h);
  if (root < 0 || root >= c->num_kfs) return -1;
  if (tree_depth > 64) return -1;  // Row step buffers are sized [64]
  const int num_lms = (int)c->lm_base.size();
  const int num_edges = (int)c->edge_a.size();

  // 1. Window keyframes: BFS from root to opt_depth.
  std::vector<int> win = c->bfs(root, opt_depth);  // copy: bfs reused below
  std::vector<uint8_t> in_win(c->num_kfs, 0);
  for (int n : win) in_win[n] = 1;

  // 2. Edges with both endpoints in the window, ascending edge id (the
  //    Python path iterates range(num_edges); we scan window adjacency and
  //    sort — same result, O(window) not O(map)).
  std::vector<int> opt_edges;
  {
    std::vector<uint8_t> seen(0);
    seen.assign(num_edges, 0);
    for (int n : win)
      for (const Adj& a : c->adjacency[n])
        if (!seen[a.eid] && in_win[c->edge_a[a.eid]] &&
            in_win[c->edge_b[a.eid]]) {
          seen[a.eid] = 1;
          opt_edges.push_back(a.eid);
        }
    std::sort(opt_edges.begin(), opt_edges.end());
  }
  if (opt_edges.empty()) return -1;

  // 3. Candidate observations: landmarks seen from the window, each with its
  //    in-window observations, ordered by (landmark id, insertion order).
  std::vector<int> lms;
  {
    std::vector<uint8_t> lm_seen(num_lms, 0);
    for (int n : win)
      for (int o : c->kf_obs[n]) {
        int l = c->obs_lm[o];
        if (!lm_seen[l]) { lm_seen[l] = 1; lms.push_back(l); }
      }
    std::sort(lms.begin(), lms.end());
  }

  // 4. Resolve spanning-tree paths per observation (skip unreachable);
  //    collect involved extra (fixed) edges in discovery order.
  std::vector<int> involved = opt_edges;
  std::vector<int> edge_local(num_edges, -1);
  for (size_t i = 0; i < opt_edges.size(); ++i)
    edge_local[opt_edges[i]] = (int)i;

  struct Row { int oid; int len; int step_le[64]; int step_sign[64]; };
  std::vector<Row> rows;
  std::vector<int> peid(tree_depth), psign(tree_depth);
  std::vector<int> elig;
  int bfs_src = -1;  // the epoch-stamped scratch holds ONE source's tree
  for (int l : lms) {
    // In-window observations of this landmark, insertion order; with a cap,
    // keep only the NEWEST cap of them (matches window.py's tail slice —
    // newest observations carry the freshest geometry).
    elig.clear();
    for (int o : c->lm_obs[l])
      if (in_win[c->obs_kf[o]]) elig.push_back(o);
    size_t e_start = 0;
    if (obs_per_lm_cap > 0 && (int)elig.size() > obs_per_lm_cap)
      e_start = elig.size() - (size_t)obs_per_lm_cap;
    for (size_t ei = e_start; ei < elig.size(); ++ei) {
      int o = elig[ei];
      int src = c->obs_kf[o];
      int dst = c->lm_base[l];
      // Path via cached BFS when src repeats consecutively (obs of one lm
      // often share observers across lms; recompute otherwise — bounded).
      if (src != bfs_src) { c->bfs(src, tree_depth); bfs_src = src; }
      int len = 0;
      if (src != dst) {
        if (!c->reached(dst)) continue;          // unusable here
        len = c->dist[dst];
        if (len > tree_depth) continue;
        int n = dst;
        for (int i = len - 1; i >= 0; --i) {
          int p = c->parent_kf[n];
          int eid = c->parent_eid[n];
          peid[i] = eid;
          psign[i] = (c->edge_a[eid] == p) ? 1 : -1;
          n = p;
        }
      }
      Row r;
      r.oid = o;
      r.len = len;
      for (int i = 0; i < len; ++i) {
        int eid = peid[i];
        if (edge_local[eid] < 0) {
          edge_local[eid] = (int)involved.size();
          involved.push_back(eid);
        }
        r.step_le[i] = edge_local[eid];
        r.step_sign[i] = psign[i];
      }
      rows.push_back(r);
    }
  }
  // Reset edge_local stamps for reuse safety (vector re-created per call —
  // cheap; kept simple).
  if (rows.empty()) return -1;

  // 5. Local landmark index over landmarks that actually have usable rows.
  std::vector<int> lm_local(num_lms, -1);
  std::vector<int> lm_used;
  for (const Row& r : rows) {
    int l = c->obs_lm[r.oid];
    if (lm_local[l] < 0) { lm_local[l] = 0; lm_used.push_back(l); }
  }
  std::sort(lm_used.begin(), lm_used.end());
  for (size_t i = 0; i < lm_used.size(); ++i) lm_local[lm_used[i]] = (int)i;

  const int E_real = (int)involved.size();
  const int L_real = (int)lm_used.size();
  const int N_real = (int)rows.size();
  out_counts[0] = E_real;
  out_counts[1] = L_real;
  out_counts[2] = N_real;
  if (E_real > cap_E) return 1;
  if (L_real > cap_L) return 2;
  if (N_real > cap_N) return 3;

  // 6. Emit padded outputs (pad conventions mirror window.py).
  std::memset(edge_gids, 0, sizeof(int) * cap_E);
  std::memset(edge_opt, 0, sizeof(int) * cap_E);
  std::memset(lm_gids, 0, sizeof(int) * cap_L);
  std::memset(lm_opt, 0, sizeof(int) * cap_L);
  std::memset(obs_lm_local, 0, sizeof(int) * cap_N);
  std::memset(obs_valid, 0, sizeof(int) * cap_N);
  std::memset(path_edge, 0, sizeof(int) * cap_N * tree_depth);
  std::memset(path_sign, 0, sizeof(int) * cap_N * tree_depth);

  const int n_opt = (int)opt_edges.size();
  for (int i = 0; i < E_real; ++i) {
    edge_gids[i] = involved[i];
    edge_opt[i] = i < n_opt ? 1 : 0;   // involved = opt_edges ++ extras
  }
  for (int i = 0; i < L_real; ++i) {
    lm_gids[i] = lm_used[i];
    lm_opt[i] = c->lm_fixed[lm_used[i]] ? 0 : 1;
  }
  for (int i = 0; i < N_real; ++i) {
    const Row& r = rows[i];
    obs_ids[i] = r.oid;
    obs_lm_local[i] = lm_local[c->obs_lm[r.oid]];
    obs_valid[i] = 1;
    for (int k = 0; k < r.len; ++k) {
      path_edge[i * tree_depth + k] = r.step_le[k];
      path_sign[i * tree_depth + k] = r.step_sign[k];
    }
  }
  for (int i = N_real; i < cap_N; ++i) obs_ids[i] = rows[0].oid;  // pad rows
  return 0;
}

}  // extern "C"
