"""Port parity at 65 <= k <= 255 (W = 5..16 u32 words), the graph API's
walks and its facade: DBG.walk (kernel K11's plain version) and
DBG.traverse (K12's plain version) against leon_tpu.graph.DBG, and
Graph.from_solid with node_rank, iter_nodes, iter_branching and contigs
against leon_tpu.graph.Graph, on test_torch_tensork.py's scenes (a contig,
a SNP bubble and a tip, counted by the port). All exact (tolerance 0).

The reference hashes each candidate from scratch, k table steps unrolled
in its scans: XLA on the CPU takes ~20 s to compile one of them at
k = 127 and over a minute at k = 255. Its scans therefore run as compiled
programs only where that is affordable (traverse at k = 127, default depth) and
otherwise op by op (jax.disable_jit: the same functions, executed
eagerly) over a few steps."""

import jax
import numpy as np
import pytest
import torch

from leon_tpu import graph as ref_graph
from leon_tpu_torch import graph, state
from test_torch_tensork import KS, make_scene


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the plain versions' many small tensor ops
    (see tests/test_torch_graph.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=KS)
def scene(request):
    return make_scene(request.param)


def test_walk_full_arrays(scene):
    q = scene["queries"]
    S = 3
    with jax.disable_jit():
        wb, wn = scene["ref"].walk(q, S)
    pb, pn = scene["port"].walk(q, S)
    assert pb.dtype == torch.uint8 and pn.dtype == torch.int32
    # the whole (N, S) plane: the tail past n repeats the stopped node's argmax
    np.testing.assert_array_equal(pb.numpy(), np.asarray(wb))
    np.testing.assert_array_equal(pn.numpy(), np.asarray(wn))
    assert (pn.numpy() < S).any() and (pn.numpy() == S).any()


# (k, bubble depth, outer steps, run the reference compiled)
TRAVERSE = [(127, None, 2, True), (127, 3, 2, False), (255, 3, 2, False)]


@pytest.mark.parametrize("scene,depth,S,compiled", TRAVERSE, indirect=["scene"],
                         ids=["k127-default", "k127-D3", "k255-D3"])
def test_traverse_full_arrays(scene, depth, S, compiled):
    """Traverse from the four start nodes and a few solid ones. The lane
    from the node 1 step before the tip meets it at step 2: at the default
    depth D = k + 1 (an output row of S * (k + 3) bases) the tip's arm
    dies and the lane crosses; at D = 3 it stops there. (The SNP
    bubble is not crossed: in both packages each of its arms meets a
    candidate whose hash pair equals a solid k-mer's, the hash family's
    rotations being taken mod 32.)"""
    k = scene["k"]
    q = scene["queries"][:12]
    if compiled:
        tb, tn = scene["ref"].traverse(q, S, depth)
    else:
        with jax.disable_jit():
            tb, tn = scene["ref"].traverse(q, S, depth)
    pb, pn = scene["port"].traverse(q, S, depth)
    D = k + 1 if depth is None else depth
    assert tuple(pb.shape) == (q.shape[0], S * (D + 2))
    np.testing.assert_array_equal(pb.numpy(), np.asarray(tb))
    np.testing.assert_array_equal(pn.numpy(), np.asarray(tn))
    assert int(pn[0]) == S  # the contig's first node walks on
    assert (int(pn[2]) > S) == (depth is None)


def test_from_solid_index_and_iteration(scene):
    k, solid = scene["k"], scene["solid"]
    ref = ref_graph.Graph.from_solid(solid, k)
    got = graph.Graph.from_solid(solid, k, device="cpu")
    assert got.dbg.bitset.dtype == torch.int32 and got.dbg.n_words == ref.dbg.n_words
    np.testing.assert_array_equal(state.bitset_from_torch(got.dbg.bitset),
                                  np.asarray(ref.dbg.bitset))
    assert got.n_nodes == ref.n_nodes == len(solid)
    q = scene["queries"]
    ranks = got.node_rank(q)
    np.testing.assert_array_equal(ranks, ref.node_rank(q))
    n0 = len(scene["starts"])
    np.testing.assert_array_equal(ranks[n0 : n0 + len(solid)], np.arange(len(solid)))
    for a, b in zip(got.iter_nodes(batch=64), ref.iter_nodes(batch=64), strict=True):
        np.testing.assert_array_equal(a, b)
    with jax.disable_jit():
        br = list(got.iter_branching(batch=1024))
        assert br
        for a, b in zip(br, ref.iter_branching(batch=1024), strict=True):
            np.testing.assert_array_equal(a, b)
        n_contigs = 0
        for (sa, ba, na), (sb, bb, nb) in zip(got.contigs(max_len=2, batch=1024),
                                              ref.contigs(max_len=2, batch=1024), strict=True):
            np.testing.assert_array_equal(sa, sb)
            np.testing.assert_array_equal(ba, bb)
            np.testing.assert_array_equal(na, nb)
            n_contigs += len(sa)
    assert n_contigs == len(solid)
