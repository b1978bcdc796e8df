"""Grid A* for planner warm starts.

Counterpart of nerfnav_tpu/nav/astar.py: 6-connected A* over a boolean
occupancy grid with a Euclidean heuristic and a heap frontier, on the host.
`astar` runs the native build (nerfnav_tpu_torch/native) and lets a build
failure raise; `astar_python` is the golden the tests hold it against.
"""

import heapq

import numpy as np

_NEIGHBORS = [(-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0), (0, 0, -1), (0, 0, 1)]


def astar_python(occupied: np.ndarray, start, goal):
    """occupied: (H, W, D) bool; start/goal: int index triples. Returns the
    inclusive path as a list of index triples, or None if unreachable.
    Raises ValueError on an occupied endpoint."""
    occupied = np.asarray(occupied, bool)
    start, goal = tuple(int(c) for c in start), tuple(int(c) for c in goal)
    if occupied[start]:
        raise ValueError(f"A* start cell {start} is occupied")
    if occupied[goal]:
        raise ValueError(f"A* goal cell {goal} is occupied")
    shape = occupied.shape

    def h(c):
        return float(np.linalg.norm(np.subtract(c, goal)))

    open_heap = [(h(start), 0.0, start)]
    came, g_cost = {}, {start: 0.0}
    closed = set()
    while open_heap:
        _, g, cur = heapq.heappop(open_heap)
        if cur == goal:
            path = [cur]
            while cur in came:
                cur = came[cur]
                path.append(cur)
            return path[::-1]
        if cur in closed:
            continue
        closed.add(cur)
        for d in _NEIGHBORS:
            nxt = (cur[0] + d[0], cur[1] + d[1], cur[2] + d[2])
            if not all(0 <= nxt[i] < shape[i] for i in range(3)):
                continue
            if occupied[nxt] or nxt in closed:
                continue
            ng = g + 1.0
            if ng < g_cost.get(nxt, np.inf):
                g_cost[nxt] = ng
                came[nxt] = cur
                heapq.heappush(open_heap, (ng + h(nxt), ng, nxt))
    return None


def astar(occupied, start, goal):
    """The native search; a failed build raises."""
    from nerfnav_tpu_torch.native import astar_native

    return astar_native(occupied, start, goal)
