// Native graph compiler — the host-side hot path of lattice/graph
// construction (adjacency tables, greedy vertex coloring, strong (distance-2)
// edge coloring). The reference builds its adjacency in Rust
// (src/classical/graph.rs:69-80); here the device code is JAX/XLA and this
// C++ covers the host-side graph compilation that pure Python does in
// O(N*deg^2) with heavy constant factors (minutes for 256^2 lattices).
//
// Plain C ABI for ctypes. All buffers are caller-allocated numpy arrays.

#include <cstdint>
#include <vector>
#include <algorithm>
#include <tuple>

extern "C" {

// Per-site degree; returns max degree.
int32_t graphc_degrees(int32_t nvars, int32_t nedges, const int32_t* edges,
                       int32_t* deg_out) {
  std::fill(deg_out, deg_out + nvars, 0);
  for (int32_t e = 0; e < nedges; ++e) {
    deg_out[edges[2 * e]]++;
    deg_out[edges[2 * e + 1]]++;
  }
  int32_t mx = 0;
  for (int32_t v = 0; v < nvars; ++v) mx = std::max(mx, deg_out[v]);
  return mx;
}

// Padded adjacency: neigh[nvars*deg] (-1 pad), nj[nvars*deg] (0 pad),
// nbond[nvars*deg] (-1 pad: the edge index of each neighbor). Neighbors are
// sorted by neighbor index per site (matches lattice.adjacency()).
void graphc_adjacency(int32_t nvars, int32_t nedges, const int32_t* edges,
                      const float* js, int32_t deg, int32_t* neigh, float* nj,
                      int32_t* nbond) {
  std::vector<int32_t> fill(nvars, 0);
  std::fill(neigh, neigh + (size_t)nvars * deg, -1);
  std::fill(nj, nj + (size_t)nvars * deg, 0.0f);
  std::fill(nbond, nbond + (size_t)nvars * deg, -1);
  for (int32_t e = 0; e < nedges; ++e) {
    int32_t a = edges[2 * e], b = edges[2 * e + 1];
    neigh[(size_t)a * deg + fill[a]] = b;
    nj[(size_t)a * deg + fill[a]] = js[e];
    nbond[(size_t)a * deg + fill[a]] = e;
    fill[a]++;
    neigh[(size_t)b * deg + fill[b]] = a;
    nj[(size_t)b * deg + fill[b]] = js[e];
    nbond[(size_t)b * deg + fill[b]] = e;
    fill[b]++;
  }
  // Sort each site's neighbor list by neighbor index (stable semantics with
  // the Python implementation).
  std::vector<std::tuple<int32_t, float, int32_t>> row;
  for (int32_t v = 0; v < nvars; ++v) {
    row.clear();
    for (int32_t d = 0; d < fill[v]; ++d)
      row.emplace_back(neigh[(size_t)v * deg + d], nj[(size_t)v * deg + d],
                       nbond[(size_t)v * deg + d]);
    std::sort(row.begin(), row.end());
    for (int32_t d = 0; d < (int32_t)row.size(); ++d) {
      neigh[(size_t)v * deg + d] = std::get<0>(row[d]);
      nj[(size_t)v * deg + d] = std::get<1>(row[d]);
      nbond[(size_t)v * deg + d] = std::get<2>(row[d]);
    }
  }
}

// Greedy vertex coloring in descending-degree order; returns color count.
// Matches lattice.greedy_coloring() semantics.
int32_t graphc_vertex_coloring(int32_t nvars, int32_t nedges,
                               const int32_t* edges, int32_t* colors) {
  std::vector<int32_t> deg(nvars, 0);
  for (int32_t e = 0; e < nedges; ++e) {
    deg[edges[2 * e]]++;
    deg[edges[2 * e + 1]]++;
  }
  // CSR adjacency.
  std::vector<int32_t> start(nvars + 1, 0);
  for (int32_t v = 0; v < nvars; ++v) start[v + 1] = start[v] + deg[v];
  std::vector<int32_t> adj(start[nvars]);
  std::vector<int32_t> fill(nvars, 0);
  for (int32_t e = 0; e < nedges; ++e) {
    int32_t a = edges[2 * e], b = edges[2 * e + 1];
    adj[start[a] + fill[a]++] = b;
    adj[start[b] + fill[b]++] = a;
  }
  std::vector<int32_t> order(nvars);
  for (int32_t v = 0; v < nvars; ++v) order[v] = v;
  std::stable_sort(order.begin(), order.end(),
                   [&](int32_t a, int32_t b) { return deg[a] > deg[b]; });
  std::fill(colors, colors + nvars, -1);
  int32_t ncolors = 0;
  std::vector<char> used;
  for (int32_t v : order) {
    used.assign(ncolors + 1, 0);
    for (int32_t i = start[v]; i < start[v + 1]; ++i) {
      int32_t c = colors[adj[i]];
      if (c >= 0 && c < (int32_t)used.size()) used[c] = 1;
    }
    int32_t c = 0;
    while (c < (int32_t)used.size() && used[c]) ++c;
    colors[v] = c;
    ncolors = std::max(ncolors, c + 1);
  }
  return ncolors;
}

// Greedy strong (distance-2) edge coloring: edges of one color share no
// vertices and no endpoints adjacent to each other's endpoints. Matches
// lattice.greedy_edge_coloring() semantics (edge order, forbidden = colors
// incident to the endpoints or to any of their neighbors).
int32_t graphc_edge_coloring(int32_t nvars, int32_t nedges,
                             const int32_t* edges, int32_t* colors) {
  std::vector<int32_t> deg(nvars, 0);
  for (int32_t e = 0; e < nedges; ++e) {
    deg[edges[2 * e]]++;
    deg[edges[2 * e + 1]]++;
  }
  std::vector<int32_t> start(nvars + 1, 0);
  for (int32_t v = 0; v < nvars; ++v) start[v + 1] = start[v] + deg[v];
  std::vector<int32_t> adj(start[nvars]);
  std::vector<int32_t> fill(nvars, 0);
  for (int32_t e = 0; e < nedges; ++e) {
    int32_t a = edges[2 * e], b = edges[2 * e + 1];
    adj[start[a] + fill[a]++] = b;
    adj[start[b] + fill[b]++] = a;
  }
  // vert_used[v] = bitset over colors of edges incident to v, as epoch-tagged
  // small vectors: store per-vertex color list.
  std::vector<std::vector<int32_t>> vert_used(nvars);
  std::vector<char> used;
  int32_t ncolors = 0;
  for (int32_t e = 0; e < nedges; ++e) {
    used.assign(ncolors + 1, 0);
    int32_t vs[2] = {edges[2 * e], edges[2 * e + 1]};
    for (int32_t k = 0; k < 2; ++k) {
      int32_t v = vs[k];
      for (int32_t c : vert_used[v])
        if (c < (int32_t)used.size()) used[c] = 1;
      for (int32_t i = start[v]; i < start[v + 1]; ++i) {
        for (int32_t c : vert_used[adj[i]])
          if (c < (int32_t)used.size()) used[c] = 1;
      }
    }
    int32_t c = 0;
    while (c < (int32_t)used.size() && used[c]) ++c;
    colors[e] = c;
    ncolors = std::max(ncolors, c + 1);
    vert_used[vs[0]].push_back(c);
    vert_used[vs[1]].push_back(c);
  }
  return ncolors;
}

}  // extern "C"
