"""Tracker wire protocol + overlay topology math (the port's copy of
``dmlc_tpu/tracker/protocol.py``: same frames, same topology, so workers
of either package join one job).

Wire format (compatible with the reference tracker protocol,
tracker/dmlc_tracker/tracker.py:24-50): native-endian int32 frames;
strings as [len:int32][utf8 bytes]; sessions open with an exchange of
the magic 0xff99.

Topology (tracker.py:165-252 behavior): a binomial tree over ranks
(heap-shaped: children of r are 2r+1, 2r+2; parent (r+1)//2-1) plus a
ring that shares edges with the tree, found by DFS; ranks are then
relabeled to follow ring order so rank r's ring neighbours are
(r-1, r+1) mod n — which is also what makes the contract line up with
ICI torus neighbours when ranks map to mesh coordinates.
"""

from __future__ import annotations

import socket
import struct
from typing import Dict, List, Tuple

MAGIC = 0xFF99

_INT = struct.Struct("@i")


def recover_cmd(gen: int) -> str:
    """Announce command for an elastic re-rendezvous: ``recover@<gen>``
    where ``<gen>`` is the generation the worker's current rank belongs
    to.  The base announce wire format (rank, world, jobid, cmd) is
    untouched — the generation rides inside the free-form command
    string, so the C-ABI workers (cpp/dmlc_collective.cc speaks the
    plain ``start``/``recover`` protocol byte-for-byte) never see it."""
    return f"recover@{int(gen)}"


def parse_worker_cmd(cmd: str):
    """``(base_cmd, announced_gen)`` for an announce command.

    ``recover@3`` → ``("recover", 3)``; ``shutdown@3`` likewise (an
    elastic worker's rank is meaningful only relative to a generation,
    and a finishing worker may not have re-brokered into the newest
    one).  Every other command (including plain ``recover``, which
    means "my rank is from the CURRENT generation" — the reference
    same-rank restart semantics) parses to ``(cmd, None)``."""
    base, sep, gen = cmd.partition("@")
    if sep and base in ("recover", "shutdown") and gen.isdigit():
        return base, int(gen)
    return cmd, None


class FrameSocket:
    """int32/string framing over a TCP socket."""

    def __init__(self, sock: socket.socket):
        self.sock = sock

    def recv_all(self, nbytes: int) -> bytes:
        chunks = []
        got = 0
        while got < nbytes:
            c = self.sock.recv(min(nbytes - got, 65536))
            if not c:
                raise ConnectionError("peer closed mid-frame")
            got += len(c)
            chunks.append(c)
        return b"".join(chunks)

    def recv_int(self) -> int:
        return _INT.unpack(self.recv_all(4))[0]

    def send_int(self, v: int) -> None:
        self.sock.sendall(_INT.pack(v))

    # strings on this protocol are hostnames/jobids/log lines; a length
    # outside this bound is a corrupt or hostile frame, and reading it
    # as a buffer size would stall the tracker mid-allocation
    MAX_STR = 1 << 20

    def send_str(self, s: str) -> None:
        data = s.encode()
        self.send_int(len(data))
        self.sock.sendall(data)

    def recv_str(self) -> str:
        n = self.recv_int()
        if not 0 <= n <= self.MAX_STR:
            raise ConnectionError(f"bad string frame length {n}")
        return self.recv_all(n).decode()

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# Overlay topology
# ---------------------------------------------------------------------------

def binomial_tree(n: int) -> Tuple[Dict[int, List[int]], Dict[int, int]]:
    """Heap-shaped binomial tree: (neighbor_map, parent_map)."""
    tree: Dict[int, List[int]] = {}
    parent: Dict[int, int] = {}
    for r in range(n):
        nbrs = []
        if r > 0:
            nbrs.append((r + 1) // 2 - 1)
        if 2 * r + 1 < n:
            nbrs.append(2 * r + 1)
        if 2 * r + 2 < n:
            nbrs.append(2 * r + 2)
        tree[r] = nbrs
        parent[r] = (r + 1) // 2 - 1  # -1 for root
    return tree, parent


def _dfs_ring(tree: Dict[int, List[int]], parent: Dict[int, int], r: int) -> List[int]:
    """DFS order that tends to share edges with the tree (tracker.py:193-210
    behavior, including the reversed-last-child walk)."""
    children = [v for v in tree[r] if v != parent[r]]
    order = [r]
    for i, v in enumerate(children):
        sub = _dfs_ring(tree, parent, v)
        if i == len(children) - 1:
            sub.reverse()
        order += sub
    return order


def link_maps(n: int):
    """(tree_map, parent_map, ring_map) with ranks relabeled to ring order.

    After relabeling, ring_map[r] == ((r-1) % n, (r+1) % n); tree edges
    are expressed in the new labels.
    """
    if n == 0:
        # an elastic world can shrink to nothing (every member lost or
        # cleanly finished); an empty overlay is valid, not an error
        return {}, {}, {}
    tree, parent = binomial_tree(n)
    order = _dfs_ring(tree, parent, 0)
    assert len(order) == n
    relabel = {old: new for new, old in enumerate(order)}
    tree2 = {relabel[r]: [relabel[v] for v in vs] for r, vs in tree.items()}
    parent2 = {
        relabel[r]: (relabel[p] if p >= 0 else -1) for r, p in parent.items()
    }
    ring2 = {r: ((r - 1) % n, (r + 1) % n) for r in range(n)}
    return tree2, parent2, ring2


def resolve_ip(host: str) -> str:
    return socket.getaddrinfo(host, None)[0][4][0]
