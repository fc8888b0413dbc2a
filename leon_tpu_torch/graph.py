"""Batched de Bruijn graph API of the port (counterpart of leon_tpu/graph.py).

The graph is the classic-addressed Bloom bitset over the canonical solid
k-mers (``DBG``) plus the exact node set (``NodeIndex``, host numpy, as in
the reference): every query is batched over (N, W) u32 k-mer words
(W = ceil(k/16), k <= 255) and runs on the graph's device. The device work
is four hand-written CUDA kernels (csrc/graph.cu):

- K10 ``bloom.dbg_probe``: ``contains``, ``successors``, ``predecessors``
  and everything built on them (degrees, ``is_branching``);
- K11 ``dbg_walk``: the simple-path ``walk`` (graph.py:87-113);
- K12 ``dbg_traverse``: the bubble-crossing ``traverse`` (graph.py:125-237);
- K9 ``gather.gather_words``: the bitset-word gather of the repo's Pallas
  probe script (scripts/probe_pallas_gather.py), beside the API.

Each wrapper launches its kernel for CUDA tensors and takes its plain
PyTorch version (this module's ``*_plain``, a transcription of the
reference's jitted code) only for CPU tensors. Queries take numpy or torch
words and return tensors on the graph's device; ``iter_*``, ``node_rank``
and ``contigs`` return numpy arrays, as the reference does.
``Graph.from_solid`` builds the bitset on the host (build_np_classic) and
runs on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from leon_tpu_torch import kernels, state
from leon_tpu_torch.ops import bloom
from leon_tpu_torch.ops.kmer import need_words_k, shl2, top_mask

_M32 = 0xFFFFFFFF


@dataclass(frozen=True)
class DBG:
    """A probabilistic de Bruijn graph: nodes are the canonical solid
    k-mers present in the classic-addressed Bloom bitset (false positives
    possible, as in the reference)."""

    bitset: torch.Tensor  # (n_words,) int32 holding the u32 words
    k: int
    n_hashes: int
    n_words: int
    seed: int

    @property
    def device(self) -> torch.device:
        return self.bitset.device

    def _words(self, kmers) -> torch.Tensor:
        return state.words_to_torch(kmers, self.device)

    def _probe(self, kmers, mode: str) -> torch.Tensor:
        return bloom.dbg_probe(self.bitset, self._words(kmers), mode, True, self.n_hashes,
                               self.n_words, self.seed, self.k)

    # -- node queries ------------------------------------------------------

    def contains(self, kmers) -> torch.Tensor:
        """(N, W) packed k-mer words (either strand) -> (N,) bool."""
        return self._probe(kmers, "self")

    # -- edge queries ------------------------------------------------------

    def successors(self, kmers) -> torch.Tensor:
        """(N, W) -> (N, 4) bool: which of the 4 forward extensions
        (append base x) are present."""
        return self._probe(kmers, "out")

    def predecessors(self, kmers) -> torch.Tensor:
        """(N, W) -> (N, 4) bool: which of the 4 backward extensions
        (prepend base x) are present."""
        return self._probe(kmers, "in")

    def out_degree(self, kmers) -> torch.Tensor:
        return self.successors(kmers).sum(dim=1)

    def in_degree(self, kmers) -> torch.Tensor:
        return self.predecessors(kmers).sum(dim=1)

    def is_branching(self, kmers) -> torch.Tensor:
        """In-degree or out-degree != 1 (reference Graph::isBranching)."""
        return (self.out_degree(kmers) != 1) | (self.in_degree(kmers) != 1)

    # -- traversal ---------------------------------------------------------

    def walk(self, kmers, max_steps: int):
        """Simple-path extension from N start nodes: follow the unique
        successor, stop for good at the first node whose out-degree is not
        1. Returns (bases (N, max_steps) uint8, n (N,) int32):
        bases[i, :n[i]] are the appended bases; past n[i] each slot repeats
        the stopped node's first successor (0 when it has none)."""
        return dbg_walk(self.bitset, self._words(kmers), self.n_hashes, self.n_words,
                        self.seed, self.k, max_steps)

    def traverse(self, kmers, max_steps: int, bubble_depth: int | None = None):
        """Branch-crossing traversal from N start nodes (reference
        graph.py:125-237): at a fork every successor takes up to
        D = bubble_depth (default k + 1) simple steps; at the first depth
        where every live branch sits on the same node, the first live
        branch's path is emitted and the lane continues from that node;
        dead-ending branches drop out (a single survivor converges at once:
        tip clipping). No convergence, or a dead end, stops the lane.
        Returns (bases (N, max_steps * (D + 2)) uint8, zero past n;
        n (N,) int32)."""
        D = int(bubble_depth) if bubble_depth is not None else self.k + 1
        return dbg_traverse(self.bitset, self._words(kmers), self.n_hashes, self.n_words,
                            self.seed, self.k, max_steps, D)


@dataclass(frozen=True)
class Graph:
    """Full graph façade: probabilistic membership (DBG) plus the exact
    node set (NodeIndex) — whole-graph node and branching iteration, node
    ranks and contigs (reference graph.py:240-304)."""

    dbg: DBG
    index: "NodeIndex"

    @classmethod
    def from_solid(cls, solid_words: np.ndarray, k: int, bits_per_kmer: float = 16.0,
                   n_hashes: int = 4, seed: int = 0, device="cuda") -> "Graph":
        """The graph of a solid set, (n, W) u32 canonical k-mer words (e.g.
        the solid rows of a count run), on `device` (the card unless the
        caller asks for "cpu")."""
        need_words_k(k, "Graph.from_solid")
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but torch sees no CUDA device")
        solid_words = np.asarray(solid_words, dtype=np.uint32)
        n_words = bloom.choose_n_words(max(1, solid_words.shape[0]), bits_per_kmer)
        bits = bloom.build_np_classic(solid_words, n_words, n_hashes, seed, k)
        return cls(dbg=state.dbg_from_reference(bits, k, n_hashes, n_words, seed, device),
                   index=NodeIndex.from_solid(solid_words))

    @property
    def n_nodes(self) -> int:
        return len(self.index)

    def iter_nodes(self, batch: int = 1 << 15):
        """Yields (m, W) u32 numpy batches of the exact node set in sorted
        order (reference Graph::iterator)."""
        words = self.index.sorted_words
        for s in range(0, words.shape[0], batch):
            yield words[s : s + batch]

    def iter_branching(self, batch: int = 1 << 15):
        """Yields (m, W) numpy batches of the nodes whose in- or out-degree
        != 1, judged by the filter (reference Graph::iteratorBranching)."""
        for words in self.iter_nodes(batch):
            mask = self.dbg.is_branching(words).cpu().numpy()
            if mask.any():
                yield words[mask]

    def node_rank(self, words: np.ndarray) -> np.ndarray:
        """(N, W) -> (N,) int64 dense node ids, -1 if absent (exact)."""
        return self.index.lookup(words)

    def contigs(self, max_len: int, batch: int = 1 << 13):
        """Simple-path walks from every node, batch by batch: yields
        (seeds (m, W), bases (m, max_len) uint8, n (m,) int32), numpy."""
        for words in self.iter_nodes(batch):
            bases, n = self.dbg.walk(words, max_len)
            yield words, bases.cpu().numpy(), n.cpu().numpy()


@dataclass(frozen=True)
class NodeIndex:
    """Node -> dense index over the exact solid set by binary search of the
    sorted words (a copy of leon_tpu/graph.py:307-340, host numpy)."""

    sorted_words: np.ndarray  # (n, W) uint32, lexicographic by (MSW..LSW)

    @classmethod
    def from_solid(cls, solid_words: np.ndarray) -> "NodeIndex":
        W = solid_words.shape[1]
        order = np.lexsort(tuple(solid_words[:, j] for j in range(W)))
        return cls(np.ascontiguousarray(solid_words[order]))

    def _as_sortable(self, words: np.ndarray) -> np.ndarray:
        W = words.shape[1]
        dt = np.dtype([(f"w{j}", ">u4") for j in range(W - 1, -1, -1)])
        rec = np.empty(words.shape[0], dtype=dt)
        for j in range(W):
            rec[f"w{j}"] = words[:, j]
        return rec

    def lookup(self, words: np.ndarray) -> np.ndarray:
        """(N, W) -> (N,) int64 index into the solid set, -1 if absent."""
        hay = self._as_sortable(self.sorted_words)
        needles = self._as_sortable(words)
        idx = np.searchsorted(hay, needles)
        idx_c = np.clip(idx, 0, max(0, hay.shape[0] - 1))
        hit = hay.shape[0] > 0
        found = (hay[idx_c] == needles) if hit else np.zeros(len(needles), bool)
        return np.where(found, idx_c, -1)

    def __len__(self) -> int:
        return self.sorted_words.shape[0]


# ---------------------------------------------------------------------------
# K11 dbg_walk and K12 dbg_traverse: wrappers and plain versions
# ---------------------------------------------------------------------------


def _check_walk_args(bitset, words, H: int, n_words: int, k: int, S: int, name: str) -> None:
    bloom.check_probe_args(bitset, words, bloom.OUT, True, H, n_words, k)
    kernels.need(S >= 0, f"{name}: max_steps={S} < 0")


def dbg_walk(bitset: torch.Tensor, words: torch.Tensor, H: int, n_words: int, seed: int,
             k: int, max_steps: int):
    """K11: DBG.walk of (N, W) int32 start words over a classic bitset ->
    (bases (N, S) uint8, n (N,) int32)."""
    _check_walk_args(bitset, words, H, n_words, k, max_steps, "dbg_walk")
    if not kernels.on_cuda(words, "dbg_walk"):
        return dbg_walk_plain(bitset, words, H, n_words, seed, k, max_steps)
    words, bitset = words.contiguous(), bitset.contiguous()
    N, W = words.shape
    bases = torch.empty((N, max_steps), dtype=torch.uint8, device=words.device)
    n = torch.empty(N, dtype=torch.int32, device=words.device)
    tab = kernels.host_tables(bloom.tables(seed, k))
    rc = kernels.lib().lt_dbg_walk(
        words.data_ptr(), N, W, max_steps, k, top_mask(k), tab.ctypes.data,
        bitset.data_ptr(), H, int(n_words), bases.data_ptr(), n.data_ptr(),
        kernels.stream(words))
    kernels.check(rc, "dbg_walk")
    kernels.launches["dbg_walk"] += 1
    return bases, n


def _step_plain(bits, cur, alive, H, n_words, seed, k):
    """One unique-successor step of (M, W) int64 nodes (reference
    graph.py:115-123): (next, advanced, base, successor mask)."""
    succ = bloom.probe_words_plain(bits, cur, bloom.OUT, True, H, n_words, seed, k)
    deg = succ.sum(dim=1)
    uniq = torch.argmax(succ.to(torch.int32), dim=1)  # the first True, 0 if none
    go = alive & (deg == 1)
    nxt = torch.where(go[:, None], shl2(cur, uniq, k), cur)
    return nxt, go, uniq, succ


def dbg_walk_plain(bitset: torch.Tensor, words: torch.Tensor, H: int, n_words: int,
                   seed: int, k: int, max_steps: int):
    """Plain version of dbg_walk: the reference's lax.scan (graph.py:95-113)
    as a loop of from-scratch successor probes."""
    _check_walk_args(bitset, words, H, n_words, k, max_steps, "dbg_walk")
    bits = bitset.to(torch.int64) & _M32
    cur = words.to(torch.int64) & _M32
    N = cur.shape[0]
    alive = torch.ones(N, dtype=torch.bool, device=cur.device)
    bases = torch.zeros((N, max_steps), dtype=torch.uint8, device=cur.device)
    n = torch.zeros(N, dtype=torch.int32, device=cur.device)
    for s in range(max_steps):
        cur, alive, uniq, _ = _step_plain(bits, cur, alive, H, n_words, seed, k)
        bases[:, s] = uniq.to(torch.uint8)
        n += alive.to(torch.int32)
    return bases, n


def dbg_traverse(bitset: torch.Tensor, words: torch.Tensor, H: int, n_words: int, seed: int,
                 k: int, max_steps: int, D: int):
    """K12: DBG.traverse of (N, W) int32 start words with bubble depth D ->
    (bases (N, max_steps * (D + 2)) uint8, n (N,) int32)."""
    _check_walk_args(bitset, words, H, n_words, k, max_steps, "dbg_traverse")
    kernels.need(D >= 1, f"dbg_traverse: bubble_depth={D} < 1")
    if not kernels.on_cuda(words, "dbg_traverse"):
        return dbg_traverse_plain(bitset, words, H, n_words, seed, k, max_steps, D)
    words, bitset = words.contiguous(), bitset.contiguous()
    N, W = words.shape
    out = torch.empty((N, max_steps * (D + 2)), dtype=torch.uint8, device=words.device)
    n = torch.empty(N, dtype=torch.int32, device=words.device)
    tab = kernels.host_tables(bloom.tables(seed, k))
    rc = kernels.lib().lt_dbg_traverse(
        words.data_ptr(), N, W, max_steps, D, k, top_mask(k), tab.ctypes.data,
        bitset.data_ptr(), H, int(n_words), out.data_ptr(), n.data_ptr(),
        kernels.stream(words))
    kernels.check(rc, "dbg_traverse")
    kernels.launches["dbg_traverse"] += 1
    return out, n


def dbg_traverse_plain(bitset: torch.Tensor, words: torch.Tensor, H: int, n_words: int,
                       seed: int, k: int, max_steps: int, D: int):
    """Plain version of dbg_traverse: the reference's nested lax.scans,
    convergence test and ragged compaction (graph.py:146-237), with every
    outer step paying the full 4 x D probe cost."""
    _check_walk_args(bitset, words, H, n_words, k, max_steps, "dbg_traverse")
    kernels.need(D >= 1, f"dbg_traverse: bubble_depth={D} < 1")
    bits = bitset.to(torch.int64) & _M32
    cur = words.to(torch.int64) & _M32
    N, W = cur.shape
    dev = cur.device
    SLOTS = D + 2
    ar = torch.arange(N, device=dev)
    alive = torch.ones(N, dtype=torch.bool, device=dev)
    slots_all, n_all = [], []
    for _ in range(max_steps):
        succ = bloom.probe_words_plain(bits, cur, bloom.OUT, True, H, n_words, seed, k)
        deg = succ.sum(dim=1)
        uniq = torch.argmax(succ.to(torch.int32), dim=1)
        simple = alive & (deg == 1)
        branching = alive & (deg >= 2)

        # bubble attempt from every lane (masked by `branching`)
        bc = torch.stack([shl2(cur, c, k) for c in range(4)])          # (4, N, W)
        ba = succ.T & branching[None, :]                                # (4, N)
        scur, salive, sbase = [], [], []
        for _d in range(D):
            c2, go, uq, _ = _step_plain(bits, bc.reshape(-1, W), ba.reshape(-1), H, n_words,
                                        seed, k)
            bc, ba = c2.reshape(4, N, W), go.reshape(4, N)
            scur.append(bc)
            salive.append(ba)
            sbase.append(uq.reshape(4, N))
        scur = torch.stack(scur)                                        # (D, 4, N, W)
        salive = torch.stack(salive)                                    # (D, 4, N)
        sbase = torch.stack(sbase)                                      # (D, 4, N)

        n_alive = salive.sum(dim=1)                                     # (D, N)
        first = torch.argmax(salive.to(torch.int32), dim=1)             # (D, N)
        ref = torch.take_along_dim(scur, first[:, None, :, None], dim=1)  # (D, 1, N, W)
        same = ((scur == ref) | ~salive[..., None]).all(dim=3).all(dim=1)  # (D, N)
        conv = (n_alive >= 1) & same
        d_star = torch.argmax(conv.to(torch.int32), dim=0)              # (N,)
        has_conv = conv.any(dim=0) & branching
        cbr = torch.argmax(salive[d_star, :, ar].to(torch.int32), dim=1)  # (N,)
        conv_node = ref[d_star, 0, ar]                                  # (N, W)

        slots = torch.zeros((N, SLOTS), dtype=torch.int64, device=dev)
        slots[:, 0] = torch.where(simple, uniq, torch.where(has_conv, cbr, 0))
        chosen = sbase[:, cbr, ar].T                                    # (N, D)
        dmask = torch.arange(D, device=dev)[None, :] <= d_star[:, None]
        slots[:, 1 : D + 1] = torch.where(has_conv[:, None] & dmask, chosen, 0)
        n_emit = torch.where(has_conv, d_star + 2, simple.to(torch.int64))
        cur = torch.where(simple[:, None], shl2(cur, uniq, k),
                          torch.where(has_conv[:, None], conv_node, cur))
        alive = simple | has_conv
        slots_all.append(slots)
        n_all.append(n_emit)

    # compact the ragged per-step emissions into flat per-lane bases
    cap = max_steps * SLOTS
    if not max_steps:
        return (torch.zeros((N, 0), dtype=torch.uint8, device=dev),
                torch.zeros(N, dtype=torch.int32, device=dev))
    slots = torch.stack(slots_all, dim=1)                               # (N, S, SLOTS)
    n_emit = torch.stack(n_all, dim=1)                                  # (N, S)
    base_off = torch.cumsum(n_emit, dim=1) - n_emit
    j = torch.arange(SLOTS, device=dev)[None, None, :]
    dst = torch.where(j < n_emit[:, :, None], base_off[:, :, None] + j, cap).reshape(N, -1)
    out = torch.zeros((N, cap + 1), dtype=torch.int64, device=dev)
    out.scatter_(1, dst, slots.reshape(N, -1))
    return out[:, :cap].to(torch.uint8), n_emit.sum(dim=1).to(torch.int32)
