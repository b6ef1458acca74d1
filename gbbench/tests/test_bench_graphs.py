"""The generators: the same seed gives the same edges, at the expected
counts, on the device they are asked for."""

import pytest
import torch

from gbbench import catalog, graph

CONFIGS = ["graph500-kron", "gap-urand"]
WEIGHTS = {"uniform_0_1": (0.0, 1.0 - 2**-24), "uniform_1_255": (1, 255)}


def cfg_of(name):
    return catalog.load_json(catalog.HERE / "configs" / f"{name}.json")


@pytest.mark.parametrize("name", CONFIGS)
def test_same_seed_same_edges(name):
    cfg = cfg_of(name)
    a = graph.generate(cfg, 2**33 + 5, "cpu", scale=9)
    b = graph.generate(cfg, 2**33 + 5, "cpu", scale=9)
    c = graph.generate(cfg, 2**33 + 6, "cpu", scale=9)
    assert torch.equal(a.src, b.src) and torch.equal(a.dst, b.dst)
    assert torch.equal(a.w, b.w)
    assert not torch.equal(a.src, c.src)


@pytest.mark.parametrize("name", CONFIGS)
def test_counts_and_types(name):
    cfg = cfg_of(name)
    e = graph.generate(cfg, 11, "cpu", scale=10)
    assert e.n == 1 << 10
    assert e.generated == cfg["edge_factor"] << 10
    assert e.src.dtype == e.dst.dtype == torch.int32
    assert e.w.dtype == torch.float32
    assert bool((e.src != e.dst).all())            # self loops dropped
    assert e.src.numel() > 0.95 * e.generated
    assert 0 <= int(e.src.min()) and int(e.src.max()) < e.n
    lo, hi = WEIGHTS[cfg["weights"]]
    assert float(e.w.min()) >= lo and float(e.w.max()) <= hi
    rows, cols, vals = graph.stored(e, cfg)
    assert rows.numel() == 2 * e.src.numel()       # both directions


def test_kronecker_is_skewed_and_uniform_is_not():
    deg = {}
    for name in CONFIGS:
        e = graph.generate(cfg_of(name), 3, "cpu", scale=12)
        d = torch.bincount(torch.cat([e.src, e.dst]).long(), minlength=e.n)
        deg[name] = (int(d.max()), float((d == 0).float().mean()))
    assert deg["graph500-kron"][0] > 10 * deg["gap-urand"][0]
    assert deg["graph500-kron"][1] > 0.1 > deg["gap-urand"][1]


def test_kronecker_quadrant_shares():
    """Before the relabelling, bit level 0 of (src, dst) falls in the
    quadrants with the initiator's probabilities."""
    cfg = dict(cfg_of("graph500-kron"), vertex_permutation=False)
    g = torch.Generator().manual_seed(1)
    src, dst = catalog.module("graphs", "kronecker").edges(cfg, 12, g, "cpu")
    q = (src & 1) * 2 + (dst & 1)
    share = torch.bincount(q.long(), minlength=4).double() / q.numel()
    assert torch.allclose(share, torch.tensor(cfg["initiator"],
                                              dtype=torch.float64), atol=0.01)


def test_gap_weights_are_the_integers_1_to_255():
    g = torch.Generator().manual_seed(4)
    w = catalog.module("weights", "uniform_1_255").draw(
        1 << 16, g, "cpu", torch.float32)
    assert w.dtype == torch.float32
    assert torch.equal(w, w.round())
    assert torch.equal(torch.unique(w), torch.arange(1, 256,
                                                     dtype=torch.float32))
