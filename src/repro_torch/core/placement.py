"""Topology-aware placement: where a task's ranks land, not just how many.

The paper's heterogeneous runtime keeps devices busy across pipelines, but
WHICH devices a task gets matters as much as how many: a ProcessExecutor
task whose ranks straddle worker processes pays for every collective through
the parent hub, while the same task packed into one worker runs on a single
local sub-mesh and never touches the hub (the Cylon observation that
communicator-group locality dominates join/sort cost).

Two pieces:

* :class:`Topology` — an executor's locality report, ``node -> [handles]``.
  The virtual executor synthesizes nodes (``SimOptions.devices_per_node``),
  the thread executor is one node, the process executor reports one node per
  worker interpreter.
* :func:`plan` — the placement policy: given ``n``, the free list, a
  topology, and the retry-exclusion set, choose the exact devices.

Policies:

* ``SPREAD`` (default) — the historical flat allocation: first ``n`` free
  devices in pool order, devices in ``exclude`` last.  Bit-for-bit the
  behaviour of ``ResourceManager.allocate`` before the placement layer
  existed, so every existing schedule reproduces exactly.
* ``PACK`` — minimize the number of distinct nodes.  If any single node can
  host all ``n`` ranks, pick the *best-fit* such node (fewest free devices,
  preferring nodes with enough non-excluded devices); otherwise fill from
  the emptiest-first (largest free count) nodes so the task spans as few
  nodes as possible.

Both policies are exclude-aware: devices a previous attempt failed on are
chosen only when nothing else fits (the scheduler's retry-with-exclusion
contract).
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence

PACK = "pack"
SPREAD = "spread"
PLACEMENTS = (SPREAD, PACK)


class Topology:
    """Locality report: ordered mapping of node id -> device handles.

    Node ids are opaque strings (worker ids for the process executor,
    synthetic ``n0/n1/...`` for simulated nodes).  A device missing from
    every node is treated as its own single-device node — the conservative
    choice: pack will never co-locate two devices it knows nothing about.
    """

    def __init__(self, nodes: Mapping[str, Sequence]):
        self.nodes: dict[str, tuple] = {k: tuple(v) for k, v in nodes.items()}
        self._node_of = {d: k for k, devs in self.nodes.items() for d in devs}

    @property
    def n_nodes(self) -> int:
        return len(self.nodes)

    def node_of(self, device) -> Optional[str]:
        """Node id hosting ``device`` (None when unmapped)."""
        return self._node_of.get(device)

    def group(self, devices: Sequence) -> dict:
        """Group ``devices`` by node, preserving order within each node.
        Unmapped devices each become their own synthetic single-device node
        (keys ``?0``, ``?1``, ...)."""
        out: dict[str, list] = {}
        unknown = 0
        for d in devices:
            node = self._node_of.get(d)
            if node is None:
                node = f"?{unknown}"
                unknown += 1
            out.setdefault(node, []).append(d)
        return out

    def __repr__(self):
        inner = ", ".join(f"{k}:{len(v)}" for k, v in self.nodes.items())
        return f"Topology({inner})"


def _exclude_last(devices: Sequence, exclude: set) -> list:
    if not exclude:
        return list(devices)
    return [d for d in devices if d not in exclude] + \
           [d for d in devices if d in exclude]


def plan(n: int, free: Sequence, topology: Optional[Topology] = None,
         policy: Optional[str] = None, exclude: Sequence = ()) -> list:
    """Choose ``n`` devices from ``free`` under ``policy``.

    ``free`` is the pool's free list in its native order and must hold at
    least ``n`` devices (the caller — ``ResourceManager.allocate_placed`` —
    checks under its lock).  Returns the chosen devices, preserving the
    within-node free-list order so schedules stay deterministic.
    """
    policy = policy or SPREAD
    if policy not in PLACEMENTS:
        raise ValueError(
            f"unknown placement policy {policy!r}; expected one of "
            f"{PLACEMENTS}")
    if n > len(free):
        # the pool normally checks under its lock; an elastic retire racing
        # a direct plan() call must fail loudly, not silently under-allocate
        raise ValueError(f"plan: want {n} devices, free list has {len(free)}")
    exclude = set(exclude)
    if policy == SPREAD or topology is None or topology.n_nodes <= 1:
        # the historical flat path (one node degenerates to it as well)
        return _exclude_last(free, exclude)[:n]

    clean = [d for d in free if d not in exclude]
    if exclude and len(clean) >= n:
        # enough untainted devices exist: pack over them EXCLUSIVELY, so
        # excluded devices are chosen only when nothing else fits — the
        # retry-with-exclusion contract outranks packing one extra rank
        return _pack(n, clean, topology, set())
    return _pack(n, free, topology, exclude)


def _pack(n: int, free: Sequence, topology: Topology, exclude: set) -> list:
    groups = topology.group(free)
    # within a node, clean (non-excluded) devices first
    ordered = {node: _exclude_last(devs, exclude)
               for node, devs in groups.items()}
    node_order = {node: i for i, node in enumerate(ordered)}

    def n_clean(node):
        return sum(1 for d in ordered[node] if d not in exclude)

    # 1) best-fit single node: fewest free devices among those that fit,
    #    preferring nodes with n clean devices; ties broken by pool order
    fits = [node for node, devs in ordered.items() if len(devs) >= n]
    if fits:
        def fit_key(node):
            return (n_clean(node) < n, len(ordered[node]), node_order[node])
        return ordered[min(fits, key=fit_key)][:n]

    # 2) spanning: most clean devices first (taint only when unavoidable),
    #    then largest-free so the task touches as few nodes as possible
    chosen: list = []
    for node in sorted(ordered, key=lambda k: (-n_clean(k),
                                               -len(ordered[k]),
                                               node_order[k])):
        take = min(n - len(chosen), len(ordered[node]))
        chosen.extend(ordered[node][:take])
        if len(chosen) == n:
            break
    return chosen
