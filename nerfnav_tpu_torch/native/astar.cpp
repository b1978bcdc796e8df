// 6-connected grid A* for the planner's warm start.
//
// Same search as nerfnav_tpu_torch/nav/astar.py::astar_python (Euclidean
// heuristic, heap frontier, unit step cost), which the tests hold it
// against path for path: costs are doubles and the frontier pops the least
// (f, g, flat index), the order of the Python heap's (f, g, cell) tuples, so
// ties between equally short paths resolve the same way. Built with g++ at
// first use and loaded through ctypes (nerfnav_tpu_torch/native/__init__.py).

#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>
#include <cmath>
#include <limits>

namespace {

struct Node {
  double f;
  double g;
  int idx;
  bool operator>(const Node& o) const {
    if (f != o.f) return f > o.f;
    if (g != o.g) return g > o.g;
    return idx > o.idx;
  }
};

inline double heuristic(int idx, int gx, int gy, int gz, int ny, int nz) {
  int x = idx / (ny * nz);
  int y = (idx / nz) % ny;
  int z = idx % nz;
  double dx = double(x - gx), dy = double(y - gy), dz = double(z - gz);
  return std::sqrt(dx * dx + dy * dy + dz * dz);
}

}  // namespace

extern "C" {

// Returns path length (cells, inclusive) written into out_path as flat
// indices, or -1 if unreachable, -2 on invalid input (occupied endpoints).
int astar3d(const uint8_t* occ, int nx, int ny, int nz, int sx, int sy, int sz,
            int gx, int gy, int gz, int* out_path, int max_len) {
  const int n = nx * ny * nz;
  const int start = (sx * ny + sy) * nz + sz;
  const int goal = (gx * ny + gy) * nz + gz;
  if (occ[start] || occ[goal]) return -2;

  std::vector<double> g_cost(n, std::numeric_limits<double>::infinity());
  std::vector<int> came(n, -1);
  std::vector<uint8_t> closed(n, 0);
  std::priority_queue<Node, std::vector<Node>, std::greater<Node>> open;

  g_cost[start] = 0.0;
  open.push({heuristic(start, gx, gy, gz, ny, nz), 0.0, start});

  const int dxs[6] = {-1, 1, 0, 0, 0, 0};
  const int dys[6] = {0, 0, -1, 1, 0, 0};
  const int dzs[6] = {0, 0, 0, 0, -1, 1};

  while (!open.empty()) {
    Node cur = open.top();
    open.pop();
    if (closed[cur.idx]) continue;
    closed[cur.idx] = 1;
    if (cur.idx == goal) {
      // reconstruct (reversed), then flip
      std::vector<int> rev;
      for (int c = goal; c != -1; c = came[c]) rev.push_back(c);
      int len = int(rev.size());
      if (len > max_len) return -3;
      for (int i = 0; i < len; ++i) out_path[i] = rev[len - 1 - i];
      return len;
    }
    int x = cur.idx / (ny * nz);
    int y = (cur.idx / nz) % ny;
    int z = cur.idx % nz;
    for (int k = 0; k < 6; ++k) {
      int xx = x + dxs[k], yy = y + dys[k], zz = z + dzs[k];
      if (xx < 0 || xx >= nx || yy < 0 || yy >= ny || zz < 0 || zz >= nz)
        continue;
      int nidx = (xx * ny + yy) * nz + zz;
      if (occ[nidx] || closed[nidx]) continue;
      double ng = cur.g + 1.0;
      if (ng < g_cost[nidx]) {
        g_cost[nidx] = ng;
        came[nidx] = cur.idx;
        open.push({ng + heuristic(nidx, gx, gy, gz, ny, nz), ng, nidx});
      }
    }
  }
  return -1;
}

}  // extern "C"
