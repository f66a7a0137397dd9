// treekit: native host-side runtime of the fine stage.
//
// The host-side hot loops that sit between the chemistry and the device:
// junction-tree order building (DFS/BFS programs), search adjacency
// construction, dense batch packing for the training iterators and the
// autoregressive beam-search fleet, and the beam searches over precomputed
// lattices. In Python they run per sample per step (data/orders.py,
// data/denoise.py); at training batch sizes they hold the device back.
//
// A copy of the JAX package's hierdiff_tpu/runtime/treekit.cpp, code
// unchanged, so both packers draw the same mt19937_64 streams.
//
// Exposed as a C ABI consumed via ctypes (hierdiff_torch/runtime/__init__.py).
// All buffers are caller-allocated numpy arrays; no memory crosses the
// boundary in native ownership.
//
// Build: hierdiff_torch/runtime/__init__.py compiles it at first use
// (c++ -O3 -fPIC -shared -std=c++17) into hierdiff_torch/_build/.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <random>
#include <unordered_map>
#include <utility>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// DFS order with explicit forward/backtrack path over an adjacency matrix.
// Mirrors data_utils/data_diffuse.py:83-96 (recursive preorder, neighbor
// order = ascending index, matching numpy nonzero order used by the
// reference's graph construction).
// ---------------------------------------------------------------------------

static void dfs_rec(const double* adj, int n, int node,
                    std::vector<uint8_t>& visited,
                    std::vector<int32_t>& order_node,
                    std::vector<int32_t>& order_depth,
                    std::vector<int32_t>& path_a,
                    std::vector<int32_t>& path_b) {
  order_node.push_back(node);
  order_depth.push_back((int32_t)path_a.size());
  visited[node] = 1;
  for (int next = 0; next < n; ++next) {
    if (adj[(size_t)node * n + next] != 0.0 && !visited[next]) {
      visited[next] = 1;
      path_a.push_back(node);
      path_b.push_back(next);
      dfs_rec(adj, n, next, visited, order_node, order_depth, path_a, path_b);
      path_a.push_back(next);
      path_b.push_back(node);
    }
  }
}

// dfs_bidirection (data_utils/MPNN_pattern.py:15-42): pick DFS step
// `sample_idx` (or uniform in [0, n) when sample_idx < 0 using `seed`).
// Outputs: undiscovered mask (n), search_ind, last_ind (-1 at root step).
// Returns the chosen step index.
int32_t tk_dfs_bidirection(const double* adj, int32_t n, int32_t sample_idx,
                           uint64_t seed, uint8_t* undiscovered_mask,
                           int32_t* search_ind, int32_t* last_ind) {
  std::vector<uint8_t> visited(n, 0);
  std::vector<int32_t> order_node, order_depth, path_a, path_b;
  order_node.reserve(n);
  dfs_rec(adj, n, 0, visited, order_node, order_depth, path_a, path_b);

  int32_t idx = sample_idx;
  if (idx < 0) {
    std::mt19937_64 rng(seed);
    std::uniform_int_distribution<int32_t> dist(0, (int32_t)order_node.size() - 1);
    idx = dist(rng);
  }
  std::memset(undiscovered_mask, 0, n);
  if (idx == 0) {
    for (int i = 0; i < n; ++i) undiscovered_mask[i] = 1;
    *search_ind = 0;
    *last_ind = -1;
    return idx;
  }
  int32_t s = order_node[idx];
  int32_t depth = order_depth[idx];
  // last_ind = node whose order entry precedes the first entry at `depth`
  int32_t first_at_depth = 0;
  for (size_t i = 0; i < order_depth.size(); ++i) {
    if (order_depth[i] == depth) { first_at_depth = (int32_t)i; break; }
  }
  *last_ind = order_node[first_at_depth - 1];
  *search_ind = s;
  // mask EXCLUDES the search node, exactly like the Python/reference
  // dfs_bidirection (MPNN_pattern.py:15-42, data/orders.py) — consumers add
  // the search node themselves where the contract needs it
  for (size_t i = 0; i < order_node.size(); ++i) {
    if (order_depth[i] > depth) undiscovered_mask[order_node[i]] = 1;
  }
  return idx;
}

// Search adjacency (MPNN_pattern.py:52-60): zero rows/cols of undiscovered
// nodes and the search node; org out param gets the result; search adds the
// last<->search edge.
void tk_make_search_adj(const double* adj, int32_t n,
                        const uint8_t* undiscovered_mask, int32_t search_ind,
                        int32_t last_ind, float* org, float* search) {
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j < n; ++j) {
      bool kill = undiscovered_mask[i] || undiscovered_mask[j] ||
                  i == search_ind || j == search_ind;
      float v = kill ? 0.f : (float)adj[(size_t)i * n + j];
      org[(size_t)i * n + j] = v;
      search[(size_t)i * n + j] = v;
    }
  }
  if (last_ind >= 0) {
    search[(size_t)last_ind * n + search_ind] = 1.f;
    search[(size_t)search_ind * n + last_ind] = 1.f;
  }
}

// ---------------------------------------------------------------------------
// Dense batch packing for the edge-denoise training iterator: for a batch of
// trees (flattened inputs), run DFS-step sampling + search adjacency + all
// dense fields in one call. Mirrors data/denoise.py:make_denoise_batch.
//
// Inputs per tree i (offsets via tree_offsets, node counts via tree_sizes):
//   feats   (sum_n, F) float32
//   pos     (sum_n, 3) float32
//   adj     (sum_n_sq) float64  (concatenated n_i x n_i blocks)
//   wids    (sum_n)    int64
// Outputs (B = n_trees, N = max_n): dense padded arrays, see Python side.
// ---------------------------------------------------------------------------

void tk_pack_denoise_batch(
    int32_t n_trees, int32_t max_n, int32_t feat_dim, uint64_t seed,
    const int32_t* tree_sizes, const int64_t* node_offsets,
    const int64_t* adj_offsets, const float* feats_in, const float* pos_in,
    const double* adj_in, const int64_t* wids_in, int32_t undiscovered_token,
    float* feats, float* pos, int32_t* discovered, int32_t* vocab_idx,
    float* node_mask, float* edge_mask, float* search_adj, float* focal_label,
    float* undiscovered, int32_t* predict_idx, int32_t* last_ind,
    int32_t* label) {
  std::vector<uint8_t> umask;
  std::vector<float> org, search;
  for (int b = 0; b < n_trees; ++b) {
    const int n = tree_sizes[b];
    const int64_t no = node_offsets[b];
    const int64_t ao = adj_offsets[b];
    const double* adj = adj_in + ao;
    umask.assign(n, 0);
    org.assign((size_t)n * n, 0.f);
    search.assign((size_t)n * n, 0.f);

    int32_t s_ind, l_ind;
    tk_dfs_bidirection(adj, n, -1, seed + (uint64_t)b * 0x9E3779B97F4A7C15ULL,
                       umask.data(), &s_ind, &l_ind);
    tk_make_search_adj(adj, n, umask.data(), s_ind, l_ind, org.data(), search.data());

    float* fb = feats + (size_t)b * max_n * feat_dim;
    float* pb = pos + (size_t)b * max_n * 3;
    for (int i = 0; i < n; ++i) {
      std::memcpy(fb + (size_t)i * feat_dim, feats_in + (no + i) * feat_dim,
                  sizeof(float) * feat_dim);
      std::memcpy(pb + (size_t)i * 3, pos_in + (no + i) * 3, sizeof(float) * 3);
      node_mask[(size_t)b * max_n + i] = 1.f;
    }
    for (int i = 0; i < n; ++i) {
      double org_row = 0.0, full_row = 0.0;
      for (int j = 0; j < n; ++j) {
        float ov = org[(size_t)i * n + j];
        search_adj[((size_t)b * max_n + i) * max_n + j] = ov;
        edge_mask[((size_t)b * max_n + i) * max_n + j] = (i == j) ? 0.f : 1.f;
        org_row += ov;
        full_row += adj[(size_t)i * n + j];
      }
      bool disc = org_row > 0.0;
      discovered[(size_t)b * max_n + i] = disc ? 1 : 0;
      bool val_miss = (full_row - org_row) != 0.0;
      focal_label[(size_t)b * max_n + i] = (disc && val_miss) ? 1.f : 0.f;
      // the batch channel INCLUDES the search node (its type is the label;
      // it must be in the CE support and carry the undiscovered token —
      // MPNN_pattern.py:68-79, data/denoise.py:make_denoise_example)
      bool und = umask[i] || i == s_ind;
      undiscovered[(size_t)b * max_n + i] = und ? 1.f : 0.f;
      vocab_idx[(size_t)b * max_n + i] =
          und ? undiscovered_token : (int32_t)wids_in[no + i];
    }
    for (int i = n; i < max_n; ++i)
      vocab_idx[(size_t)b * max_n + i] = undiscovered_token;
    predict_idx[b] = s_ind;
    last_ind[b] = l_ind;
    label[b] = (int32_t)wids_in[no + s_ind];
  }
}

// ---------------------------------------------------------------------------
// Fleet packing for the AR beam search (sampling/ar.py:_batch_step): pad K
// tree states into one dense bucket. States are given as flattened arrays.
// ---------------------------------------------------------------------------

void tk_pack_ar_fleet(
    int32_t n_states, int32_t max_n, int32_t feat_dim,
    const int32_t* state_sizes, const int64_t* node_offsets,
    const float* feats_in, const float* pos_in, const float* adj_in,
    const int64_t* adj_offsets, const int64_t* wids_in,
    int32_t undiscovered_token, float* feats, float* pos, float* adj,
    int32_t* vocab, int32_t* disc, float* nmask) {
  for (int b = 0; b < n_states; ++b) {
    const int n = state_sizes[b];
    const int64_t no = node_offsets[b];
    const int64_t ao = adj_offsets[b];
    float* fb = feats + (size_t)b * max_n * feat_dim;
    float* pb = pos + (size_t)b * max_n * 3;
    float* ab = adj + (size_t)b * max_n * max_n;
    for (int i = 0; i < n; ++i) {
      std::memcpy(fb + (size_t)i * feat_dim, feats_in + (no + i) * feat_dim,
                  sizeof(float) * feat_dim);
      std::memcpy(pb + (size_t)i * 3, pos_in + (no + i) * 3, sizeof(float) * 3);
      std::memcpy(ab + (size_t)i * max_n, adj_in + ao + (size_t)i * n,
                  sizeof(float) * n);
      nmask[(size_t)b * max_n + i] = 1.f;
      int64_t w = wids_in[no + i];
      vocab[(size_t)b * max_n + i] = w >= 0 ? (int32_t)w : undiscovered_token;
      disc[(size_t)b * max_n + i] = w >= 0 ? 1 : 0;
    }
    for (int i = n; i < max_n; ++i)
      vocab[(size_t)b * max_n + i] = undiscovered_token;
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Native PQ beam search over precomputed expansion lattices
// (sampling/beam.py PQBeamSearch driven by sampling/lattice.py
// LatticeExpander, ungated / no-refine-hook fast path).
//
// Bit-exact with the Python implementation: the tiny random tiebreak added
// to every pushed candidate (beam.py, mirroring ar_sampling_nosize.py:308)
// is drawn from a Mersenne Twister CONTINUED from the caller's
// random.Random state (mt_state/mt_pos in/out, from rng.getstate()), and
// all priorities are IEEE doubles accumulated in the same order.
// ---------------------------------------------------------------------------

namespace {

struct PyMT {
  uint32_t* mt;       // 624 words, caller-owned (written back)
  int32_t idx;
  uint32_t next() {
    if (idx >= 624) {
      for (int i = 0; i < 624; ++i) {
        uint32_t y = (mt[i] & 0x80000000u) | (mt[(i + 1) % 624] & 0x7fffffffu);
        uint32_t v = mt[(i + 397) % 624] ^ (y >> 1);
        if (y & 1u) v ^= 2567483615u;
        mt[i] = v;
      }
      idx = 0;
    }
    uint32_t y = mt[idx++];
    y ^= (y >> 11);
    y ^= (y << 7) & 2636928640u;
    y ^= (y << 15) & 4022730752u;
    y ^= (y >> 18);
    return y;
  }
  // CPython random_random (genrand_res53)
  double res53() {
    uint32_t a = next() >> 5, b = next() >> 6;
    return (a * 67108864.0 + b) * (1.0 / 9007199254740992.0);
  }
};

struct BeamEntry {
  double logp;
  uint64_t push;      // global push counter: the heapq tiebreak
  int32_t t;          // nodes assigned so far
  int64_t chain;      // arena index of the last choice, -1 for the init state
  uint8_t is_root;    // last_edge is None (init state or root-typing child)
};

struct ChainNode {
  int32_t parent;   // index into the molecule's own arena, -1 = chain end
  int32_t step;
  int32_t wid;      // vocab ids are < 2^31
};

inline bool entry_less(const BeamEntry& a, const BeamEntry& b) {
  return a.logp != b.logp ? a.logp < b.logp : a.push < b.push;
}

// Assembly-gate verdict callback (chem/assemble_gate.py _verdict): the
// verdict depends ONLY on (wid, sorted typed-neighbor wids) — topology is
// lattice-fixed, so the search gathers neighbors natively and calls back
// into the Python lru-cached verdict per (node, neighborhood) check.
typedef int32_t (*GateCB)(int64_t wid, const int64_t* neis, int32_t n_nei);

// Materialize a state's per-node wids (-1 = untyped) by walking its chain.
inline void chain_wids(const std::vector<ChainNode>& arena, int64_t chain,
                       const int32_t* target, int64_t off,
                       std::vector<int64_t>& wids_node) {
  std::fill(wids_node.begin(), wids_node.end(), (int64_t)-1);
  for (int64_t c = chain; c >= 0; c = arena[c].parent)
    wids_node[target[off + arena[c].step]] = arena[c].wid;
}

// Per-search memo over (wid, sorted neighbor wids) -> verdict: the verdict
// is a pure function of the key (assemble_gate.py), so repeat keys never
// cross the ctypes callback boundary (a Python callback costs ~3us; real
// chemistry has a small key space, so most checks become native hits).
struct GateMemo {
  std::unordered_map<uint64_t, std::vector<std::pair<std::vector<int64_t>, bool>>> map;
  static uint64_t hash_key(int64_t w, const std::vector<int64_t>& neis) {
    uint64_t h = 1469598103934665603ull ^ (uint64_t)w;
    for (int64_t v : neis) {
      h ^= (uint64_t)v + 0x9e3779b97f4a7c15ull + (h << 6) + (h >> 2);
    }
    return h;
  }
};

// gate(state, node): sorted typed neighbors of `node` among edges whose
// step < t; trivial pass when none (assemble_gate.py:38-47).
inline bool gate_node(GateCB gate, GateMemo& memo,
                      const std::vector<int64_t>& wids_node,
                      const int32_t* focal, const int32_t* target,
                      const uint8_t* attach, int64_t off, int32_t t,
                      int32_t node, std::vector<int64_t>& scratch) {
  int64_t w = wids_node[node];
  if (w < 0) return true;
  scratch.clear();
  scratch.push_back(w);   // key = (wid, neighbors); wid leads the vector
  for (int32_t s = 0; s < t; ++s) {
    if (!attach[off + s]) continue;   // step 0 is normally the root-typing step
    int32_t a = focal[off + s], b = target[off + s];
    int32_t other = a == node ? b : (b == node ? a : -1);
    if (other >= 0 && wids_node[other] >= 0)
      scratch.push_back(wids_node[other]);
  }
  if (scratch.size() == 1) return true;
  std::sort(scratch.begin() + 1, scratch.end());
  uint64_t h = GateMemo::hash_key(w, scratch);
  auto& bucket = memo.map[h];
  for (const auto& kv : bucket)
    if (kv.first == scratch) return kv.second;
  bool ok = gate(w, scratch.data() + 1, (int32_t)scratch.size() - 1) != 0;
  bucket.emplace_back(scratch, ok);
  return ok;
}

void beam_search_impl(
    int32_t n_mol, int32_t k, int32_t beam_size, int32_t max_exp_factor,
    const int32_t* sizes, const int64_t* offsets,
    const int32_t* focal, const int32_t* target, const uint8_t* attach,
    const int64_t* top_wid, const float* top_logp,
    uint32_t* mt_state, int32_t* mt_pos,
    GateCB gate, int32_t retry_final_gate,
    int64_t* out_wids, uint8_t* out_ok, double* out_logp) {
  PyMT rng{mt_state, *mt_pos};
  // per-molecule chain arenas: freed as soon as the molecule finishes or
  // dies, so peak memory tracks the ACTIVE frontier instead of every
  // candidate ever pushed (the Python search refcount-frees pruned states)
  std::vector<std::vector<ChainNode>> arenas(n_mol);
  std::vector<std::vector<BeamEntry>> heaps(n_mol);
  std::vector<int64_t> budget(n_mol);
  std::vector<uint8_t> finished(n_mol, 0);
  std::vector<int64_t> wids_node, scratch;
  GateMemo memo;
  uint64_t push_count = 0;
  auto free_mol = [&](int m) {
    std::vector<ChainNode>().swap(arenas[m]);
    std::vector<BeamEntry>().swap(heaps[m]);
  };

  for (int m = 0; m < n_mol; ++m) {
    heaps[m].push_back(BeamEntry{0.0, ++push_count, 0, -1, 1});
    budget[m] = (int64_t)max_exp_factor * sizes[m];
    out_ok[m] = 0;
    out_logp[m] = 0.0;
  }

  bool any = true;
  while (any) {
    any = false;
    for (int m = 0; m < n_mol; ++m) {
      if (finished[m] || heaps[m].empty() || budget[m] <= 0) {
        if (!arenas[m].empty() || !heaps[m].empty()) free_mol(m);
        continue;
      }
      any = true;
      // pop the cheapest entry (vector-min: heaps are <= beam+roots long)
      size_t mi = 0;
      for (size_t i = 1; i < heaps[m].size(); ++i)
        if (entry_less(heaps[m][i], heaps[m][mi])) mi = i;
      BeamEntry e = heaps[m][mi];
      heaps[m].erase(heaps[m].begin() + mi);

      const int n = sizes[m];
      const int64_t off = offsets[m];
      if (e.t >= n) {            // completed: accept on pop if final gate ok
        bool accept = true;
        if (gate) {
          wids_node.assign(n, -1);
          chain_wids(arenas[m], e.chain, target, off, wids_node);
          for (int32_t i = 0; i < n && accept; ++i)
            accept = gate_node(gate, memo, wids_node, focal, target, attach,
                               off, e.t, i, scratch);
        }
        if (accept) {
          finished[m] = 1;
          out_ok[m] = 1;
          out_logp[m] = e.logp;
          for (int64_t c = e.chain; c >= 0; c = arenas[m][c].parent)
            out_wids[off + target[off + arenas[m][c].step]] = arenas[m][c].wid;
          free_mol(m);           // purge (remove_queue_dup keep=0) + arena
        } else if (!retry_final_gate) {
          budget[m] = 0;         // reference: molecule yields nothing
        }
        continue;
      }

      // expand: push up to beam_size candidates of step e.t
      budget[m] -= 1;
      const int64_t row = (off + e.t) * k;
      const int kk = beam_size < k ? beam_size : k;
      const uint8_t att = attach[off + e.t];
      if (gate && att) {
        wids_node.assign(n, -1);
        chain_wids(arenas[m], e.chain, target, off, wids_node);
      }
      for (int c = 0; c < kk; ++c) {
        double lp = (double)top_logp[row + c];
        if (lp < -1e8) continue;             // outside restricted support
        if (gate && att) {
          // per-candidate gate on the focal node of the CHILD
          // (beam.py:222-224 — checked BEFORE the rng tiebreak draw)
          wids_node[target[off + e.t]] = top_wid[row + c];
          bool ok = gate_node(gate, memo, wids_node, focal, target, attach,
                              off, e.t + 1, focal[off + e.t], scratch);
          wids_node[target[off + e.t]] = -1;
          if (!ok) continue;
        }
        double child_logp = e.logp + (-lp) + 1e-8 * rng.res53();
        arenas[m].push_back(ChainNode{(int32_t)e.chain, e.t,
                                      (int32_t)top_wid[row + c]});
        heaps[m].push_back(BeamEntry{child_logp, ++push_count, e.t + 1,
                                     (int64_t)arenas[m].size() - 1,
                                     (uint8_t)(att ? 0 : 1)});
      }
      // prune (beam.py _prune): keep ALL root-step entries + the
      // (beam_size - #roots) cheapest attach-step entries
      int n_roots = 0;
      for (const auto& en : heaps[m]) n_roots += en.is_root;
      int keep = beam_size - n_roots;
      if (keep < 0) keep = 0;
      std::vector<BeamEntry> roots, rest;
      roots.reserve(n_roots);
      rest.reserve(heaps[m].size());
      for (const auto& en : heaps[m])
        (en.is_root ? roots : rest).push_back(en);
      if ((int)rest.size() > keep) {
        std::sort(rest.begin(), rest.end(), entry_less);
        rest.resize(keep);
      }
      roots.insert(roots.end(), rest.begin(), rest.end());
      heaps[m].swap(roots);
    }
  }

  *mt_pos = rng.idx;
}

}  // namespace

// ---------------------------------------------------------------------------
// Round-based REFINE-ON PQ beam search (the reference's full search loop:
// ar_sampling_nosize.py:138-143 refine on every pop + :199-200 gates).
//
// C++ owns everything the host does between device dispatches: the
// per-molecule priority queues, fleet formation, the packed-result walk
// (swap commit + assembly gates, sampling/refine_hook.py collect_batch) and
// the lattice expansions (sampling/beam.py run_rounds). Python owns ONLY the
// fused device check per round: tk_rsearch_step returns the active fleet
// (mol index + wids row + adjacency, ready to pad and ship), Python runs
// RefineHook._fused_fn and feeds the ONE packed f32 result matrix back in.
//
// Bit-exactness contract with the Python pipelined search
// (lattice.py _sample_refine_pipelined; pinned in tests/test_runtime.py):
//   - priorities are IEEE doubles accumulated in the same association order
//     (refine requeue: logp + (dlogp + tiebreak); expansion:
//     (logp + (-lp)) + tiebreak), with the walk's total/new_total kept in
//     float32 exactly like the numpy unpack;
//   - the rng tiebreak stream CONTINUES the group's random.Random Mersenne
//     state, drawn in run_rounds order (changed requeues in fleet order,
//     then per-child expansion draws);
//   - refine swaps append leaf-side chain links, and the chain walk is
//     FIRST-wins (most recent assignment), so a node's wid history costs
//     one arena slot per swap instead of an O(n) copy per candidate.
// ---------------------------------------------------------------------------

namespace {

struct RChain {
  int64_t parent;   // arena index, -1 = chain end
  int32_t node;     // typed node (target[step] for expansions, swap node)
  int32_t wid;
};

struct REntry {
  double logp;
  uint64_t push;
  int32_t t;        // nodes assigned (swaps never change it)
  int64_t chain;
  uint8_t is_root;  // last_edge is None (init state or root-typing child)
};

inline bool rentry_less(const REntry& a, const REntry& b) {
  return a.logp != b.logp ? a.logp < b.logp : a.push < b.push;
}

inline void rchain_wids(const std::vector<RChain>& arena, int64_t chain,
                        std::vector<int64_t>& w) {
  // leaf-to-root, FIRST-wins: swap links sit leaf-side of the node's
  // original assignment, so the most recent wid is seen first
  std::fill(w.begin(), w.end(), (int64_t)-1);
  for (int64_t c = chain; c >= 0; c = arena[c].parent)
    if (w[arena[c].node] < 0) w[arena[c].node] = arena[c].wid;
}

struct RSearch {
  int32_t n_mol = 0, k = 0, beam_size = 0, max_n = 0;
  double check_frac = 0.1;
  int32_t retry_final_gate = 1;
  GateCB gate = nullptr;        // search gate (candidates + final)
  GateCB hook_gate = nullptr;   // refine-walk gate (RefineHook.can_assemble)
  // borrowed lattice pointers — the Python wrapper keeps them alive
  const int32_t* sizes = nullptr;
  const int64_t* offsets = nullptr;
  const int32_t* focal = nullptr;
  const int32_t* target = nullptr;
  const uint8_t* attach = nullptr;
  const int64_t* top_wid = nullptr;
  const float* top_logp = nullptr;
  std::vector<uint32_t> mt;
  PyMT rng{nullptr, 0};
  std::vector<std::vector<RChain>> arenas;
  std::vector<std::vector<REntry>> heaps;
  std::vector<int64_t> budget;
  std::vector<uint8_t> finished;
  uint64_t push_count = 0;
  GateMemo gate_memo, hook_memo;
  // current fleet (run_rounds' to_expand, fleet order) + its active subset
  std::vector<int32_t> fleet_mol;
  std::vector<REntry> fleet_entry;
  std::vector<int32_t> active;   // active fleet positions == device rows
  std::vector<int64_t> out_wids_v;
  std::vector<uint8_t> ok_v;
  std::vector<double> logp_v;
  std::vector<int64_t> wids_scratch, nei_scratch;
};

void rs_prune(RSearch& S, int m) {
  // beam.py _prune: keep ALL root-step entries + the (beam - #roots)
  // cheapest attach-step entries
  auto& heap = S.heaps[m];
  int n_roots = 0;
  for (const auto& e : heap) n_roots += e.is_root;
  int keep = S.beam_size - n_roots;
  if (keep < 0) keep = 0;
  std::vector<REntry> roots, rest;
  roots.reserve(n_roots);
  rest.reserve(heap.size());
  for (const auto& e : heap) (e.is_root ? roots : rest).push_back(e);
  if ((int)rest.size() > keep) {
    std::sort(rest.begin(), rest.end(), rentry_less);
    rest.resize(keep);
  }
  roots.insert(roots.end(), rest.begin(), rest.end());
  heap.swap(roots);
}

void rs_expand(RSearch& S, int m, const REntry& e) {
  const int n = S.sizes[m];
  const int64_t off = S.offsets[m];
  S.budget[m] -= 1;
  const int64_t row = (off + e.t) * S.k;
  const int kk = S.beam_size < S.k ? S.beam_size : S.k;
  const uint8_t att = S.attach[off + e.t];
  const bool need_wids = S.gate && att;
  if (need_wids) {
    S.wids_scratch.assign(n, -1);
    rchain_wids(S.arenas[m], e.chain, S.wids_scratch);
  }
  for (int c = 0; c < kk; ++c) {
    double lp = (double)S.top_logp[row + c];
    if (lp < -1e8) continue;             // outside restricted support
    if (need_wids) {
      // per-candidate gate on the CHILD's focal node, BEFORE the tiebreak
      // draw (beam.py:253-255)
      S.wids_scratch[S.target[off + e.t]] = S.top_wid[row + c];
      bool ok = gate_node(S.gate, S.gate_memo, S.wids_scratch, S.focal,
                          S.target, S.attach, off, e.t + 1,
                          S.focal[off + e.t], S.nei_scratch);
      S.wids_scratch[S.target[off + e.t]] = -1;
      if (!ok) continue;
    }
    double child = e.logp + (-lp) + 1e-8 * S.rng.res53();
    S.arenas[m].push_back(RChain{e.chain, S.target[off + e.t],
                                 (int32_t)S.top_wid[row + c]});
    S.heaps[m].push_back(REntry{child, ++S.push_count, e.t + 1,
                                (int64_t)S.arenas[m].size() - 1,
                                (uint8_t)(att ? 0 : 1)});
  }
  rs_prune(S, m);
}

// Walk the previous round's packed results (RefineHook.collect_batch +
// run_rounds' checked loop): commit the first improving, gate-passing swap
// per ACTIVE row and requeue it; everything else goes to `expand_list` in
// fleet order.
void rs_apply(RSearch& S, const float* packed, int32_t Kc,
              std::vector<int32_t>& expand_list) {
  size_t arow = 0;
  for (size_t f = 0; f < S.fleet_mol.size(); ++f) {
    const int m = S.fleet_mol[f];
    const REntry& e = S.fleet_entry[f];
    const bool is_active =
        arow < S.active.size() && S.active[arow] == (int32_t)f;
    bool changed = false;
    if (is_active) {
      const float* row = packed + arow * (size_t)(1 + 4 * Kc);
      ++arow;
      const float total = row[0];         // float32 walk arithmetic, exactly
      const int n = S.sizes[m];           // like the numpy unpack
      const int64_t off = S.offsets[m];
      for (int kc = 0; kc < Kc; ++kc) {
        if (!(row[1 + 2 * Kc + kc] > 0.5f)) continue;     // valid flag
        const float new_total = row[1 + 3 * Kc + kc];
        if (new_total <= total) continue;
        const int node = (int32_t)row[1 + kc];
        const int wid = (int32_t)row[1 + Kc + kc];
        S.wids_scratch.assign(n, -1);
        rchain_wids(S.arenas[m], e.chain, S.wids_scratch);
        S.wids_scratch[node] = wid;
        if (S.hook_gate &&
            !gate_node(S.hook_gate, S.hook_memo, S.wids_scratch, S.focal,
                       S.target, S.attach, off, e.t, node, S.nei_scratch))
          continue;
        // run_rounds: state.logp += (dlogp + uniform) — one added pair
        const double dlogp = (double)(total - new_total);
        S.arenas[m].push_back(RChain{e.chain, node, wid});
        S.heaps[m].push_back(REntry{
            e.logp + (dlogp + 1e-8 * S.rng.res53()), ++S.push_count, e.t,
            (int64_t)S.arenas[m].size() - 1, e.is_root});
        changed = true;
        break;
      }
    }
    if (!changed) expand_list.push_back((int32_t)f);
  }
}

// Advance to the next ACTIVE fleet; returns its row count (0 = search done).
int32_t rs_next_fleet(RSearch& S, int32_t* fleet_mol_out, int64_t* fleet_wids,
                      float* fleet_adj) {
  while (true) {
    S.fleet_mol.clear();
    S.fleet_entry.clear();
    S.active.clear();
    bool any = false;
    std::vector<std::pair<int, REntry>> pops;
    for (int m = 0; m < S.n_mol; ++m) {
      if (S.finished[m] || S.heaps[m].empty() || S.budget[m] <= 0) {
        if (!S.arenas[m].empty() || !S.heaps[m].empty()) {
          std::vector<RChain>().swap(S.arenas[m]);
          std::vector<REntry>().swap(S.heaps[m]);
        }
        continue;
      }
      any = true;
      size_t mi = 0;
      for (size_t i = 1; i < S.heaps[m].size(); ++i)
        if (rentry_less(S.heaps[m][i], S.heaps[m][mi])) mi = i;
      pops.emplace_back(m, S.heaps[m][mi]);
      S.heaps[m].erase(S.heaps[m].begin() + mi);
    }
    if (!any) return 0;

    for (auto& pe : pops) {
      const int m = pe.first;
      const REntry& e = pe.second;
      const int n = S.sizes[m];
      if (e.t >= n) {          // completed: accept on pop if final gate ok
        bool accept = true;
        S.wids_scratch.assign(n, -1);
        rchain_wids(S.arenas[m], e.chain, S.wids_scratch);
        if (S.gate) {
          for (int i = 0; i < n && accept; ++i)
            accept = gate_node(S.gate, S.gate_memo, S.wids_scratch, S.focal,
                               S.target, S.attach, S.offsets[m], e.t, i,
                               S.nei_scratch);
        }
        if (accept) {
          S.finished[m] = 1;
          S.ok_v[m] = 1;
          S.logp_v[m] = e.logp;
          for (int i = 0; i < n; ++i)
            S.out_wids_v[S.offsets[m] + i] = S.wids_scratch[i];
          std::vector<RChain>().swap(S.arenas[m]);
          std::vector<REntry>().swap(S.heaps[m]);
        } else if (!S.retry_final_gate) {
          S.budget[m] = 0;     // reference: molecule yields nothing
        }
        continue;
      }
      S.fleet_mol.push_back(m);
      S.fleet_entry.push_back(e);
    }
    if (S.fleet_mol.empty()) continue;   // only done-pops this round

    // hook act filter (dispatch_batch): n_assigned * check_frac > 1
    for (size_t f = 0; f < S.fleet_mol.size(); ++f)
      if ((double)S.fleet_entry[f].t * S.check_frac > 1.0)
        S.active.push_back((int32_t)f);
    if (S.active.empty()) {
      // no device work: check_batch returns all-unchanged, whole fleet
      // expands immediately
      for (size_t f = 0; f < S.fleet_mol.size(); ++f)
        rs_expand(S, S.fleet_mol[f], S.fleet_entry[f]);
      continue;
    }

    for (size_t r = 0; r < S.active.size(); ++r) {
      const int f = S.active[r];
      const int m = S.fleet_mol[f];
      const int n = S.sizes[m];
      const int64_t off = S.offsets[m];
      fleet_mol_out[r] = m;
      int64_t* wrow = fleet_wids + r * (size_t)S.max_n;
      S.wids_scratch.assign(n, -1);
      rchain_wids(S.arenas[m], S.fleet_entry[f].chain, S.wids_scratch);
      for (int i = 0; i < n; ++i) wrow[i] = S.wids_scratch[i];
      for (int i = n; i < S.max_n; ++i) wrow[i] = -1;  // pad reads unassigned
      float* arow2 = fleet_adj + r * (size_t)S.max_n * S.max_n;
      std::memset(arow2, 0, sizeof(float) * (size_t)S.max_n * S.max_n);
      for (int32_t s = 0; s < S.fleet_entry[f].t; ++s) {
        if (!S.attach[off + s]) continue;
        const int a = S.focal[off + s], b = S.target[off + s];
        arow2[(size_t)a * S.max_n + b] = 1.f;
        arow2[(size_t)b * S.max_n + a] = 1.f;
      }
    }
    return (int32_t)S.active.size();
  }
}

}  // namespace

extern "C" {

// Create a refine-search over one molecule group. Lattice pointers are
// BORROWED (caller keeps the arrays alive until tk_rsearch_destroy).
// mt_state (624 u32) + mt_pos: the group rng's CPython Mersenne state
// (copied in; read back via tk_rsearch_finish).
void* tk_rsearch_create(
    int32_t n_mol, int32_t k, int32_t beam_size, int32_t max_exp_factor,
    int32_t max_n, double check_frac,
    const int32_t* sizes, const int64_t* offsets,
    const int32_t* focal, const int32_t* target, const uint8_t* attach,
    const int64_t* top_wid, const float* top_logp,
    const uint32_t* mt_state, int32_t mt_pos,
    GateCB gate, GateCB hook_gate, int32_t retry_final_gate) {
  RSearch* S = new RSearch();
  S->n_mol = n_mol;
  S->k = k;
  S->beam_size = beam_size;
  S->max_n = max_n;
  S->check_frac = check_frac;
  S->retry_final_gate = retry_final_gate;
  S->gate = gate;
  S->hook_gate = hook_gate;
  S->sizes = sizes;
  S->offsets = offsets;
  S->focal = focal;
  S->target = target;
  S->attach = attach;
  S->top_wid = top_wid;
  S->top_logp = top_logp;
  S->mt.assign(mt_state, mt_state + 624);
  S->rng = PyMT{S->mt.data(), mt_pos};
  S->arenas.resize(n_mol);
  S->heaps.resize(n_mol);
  S->budget.resize(n_mol);
  S->finished.assign(n_mol, 0);
  S->ok_v.assign(n_mol, 0);
  S->logp_v.assign(n_mol, 0.0);
  const int64_t total = offsets[n_mol - 1] + sizes[n_mol - 1];
  S->out_wids_v.assign(total, -1);
  for (int m = 0; m < n_mol; ++m) {
    S->heaps[m].push_back(REntry{0.0, ++S->push_count, 0, -1, 1});
    S->budget[m] = (int64_t)max_exp_factor * sizes[m];
  }
  return S;
}

// Advance one round: apply the previous fleet's packed check results
// (NULL on the first call), then form the next ACTIVE fleet. Returns the
// fleet row count S (0 = done); writes S rows into fleet_mol (S,),
// fleet_wids (S, max_n) int64 (-1 pad) and fleet_adj (S, max_n, max_n) f32.
// `packed` is (S_prev, 1 + 4*Kc) f32 — RefineHook._fused_fn's layout
// [total, node*K, wid*K, valid*K, new_total*K], rows in fleet-active order.
int32_t tk_rsearch_step(void* handle, const float* packed, int32_t Kc,
                        int32_t* fleet_mol, int64_t* fleet_wids,
                        float* fleet_adj) {
  RSearch& S = *(RSearch*)handle;
  if (packed != nullptr) {
    std::vector<int32_t> expand_list;
    rs_apply(S, packed, Kc, expand_list);
    for (int32_t f : expand_list)
      rs_expand(S, S.fleet_mol[f], S.fleet_entry[f]);
  }
  return rs_next_fleet(S, fleet_mol, fleet_wids, fleet_adj);
}

// Read results + the advanced rng state. out_wids is flattened by `offsets`
// (-1 where unfinished/unassigned).
void tk_rsearch_finish(void* handle, uint32_t* mt_state, int32_t* mt_pos,
                       int64_t* out_wids, uint8_t* out_ok, double* out_logp) {
  RSearch& S = *(RSearch*)handle;
  std::memcpy(mt_state, S.mt.data(), sizeof(uint32_t) * 624);
  *mt_pos = S.rng.idx;
  std::memcpy(out_wids, S.out_wids_v.data(),
              sizeof(int64_t) * S.out_wids_v.size());
  std::memcpy(out_ok, S.ok_v.data(), S.ok_v.size());
  std::memcpy(out_logp, S.logp_v.data(), sizeof(double) * S.logp_v.size());
}

void tk_rsearch_destroy(void* handle) { delete (RSearch*)handle; }

}  // extern "C"

extern "C" {

// Inputs are flattened over molecules (node offsets in `offsets`):
//   focal/target/attach: per-step lattice trajectory (length n per molecule)
//   top_wid/top_logp:    (n, K) per molecule, best-first
// mt_state (624 u32) + mt_pos: CPython Random internal state, updated.
// Outputs: out_wids (-1 where unfinished), out_ok, out_logp.
void tk_beam_search_lattice(
    int32_t n_mol, int32_t k, int32_t beam_size, int32_t max_exp_factor,
    const int32_t* sizes, const int64_t* offsets,
    const int32_t* focal, const int32_t* target, const uint8_t* attach,
    const int64_t* top_wid, const float* top_logp,
    uint32_t* mt_state, int32_t* mt_pos,
    int64_t* out_wids, uint8_t* out_ok, double* out_logp) {
  beam_search_impl(n_mol, k, beam_size, max_exp_factor, sizes, offsets,
                   focal, target, attach, top_wid, top_logp, mt_state,
                   mt_pos, nullptr, 1, out_wids, out_ok, out_logp);
}

// Gated variant: per-candidate focal gate + final all-nodes gate via the
// verdict callback (assembly feasibility depends only on the node wid and
// its sorted typed-neighbor wids — chem/assemble_gate.py).
void tk_beam_search_lattice_gated(
    int32_t n_mol, int32_t k, int32_t beam_size, int32_t max_exp_factor,
    const int32_t* sizes, const int64_t* offsets,
    const int32_t* focal, const int32_t* target, const uint8_t* attach,
    const int64_t* top_wid, const float* top_logp,
    uint32_t* mt_state, int32_t* mt_pos,
    GateCB gate, int32_t retry_final_gate,
    int64_t* out_wids, uint8_t* out_ok, double* out_logp) {
  beam_search_impl(n_mol, k, beam_size, max_exp_factor, sizes, offsets,
                   focal, target, attach, top_wid, top_logp, mt_state,
                   mt_pos, gate, retry_final_gate, out_wids, out_ok,
                   out_logp);
}

}  // extern "C"
