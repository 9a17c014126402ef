"""The selection kernels (`csrc/select_topk.cu`, `ops.select_topk`)
against their plain version (`core.query.select_topk_plain`) on the
card: bitwise in every field of the answer, on integer-valued bounds
with heavy ties in every Lemma-1 class, in step 1's user-major layout
and query-major, and with c and m as 0-d device tensors under CUDA graph
capture and replay. Needs a GPU (skipped elsewhere); run with
`PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_select_card.py`.
This file imports no JAX."""
import pytest
import torch

from repro_torch.core.query import select_topk_plain
from repro_torch.kernels import ops

NS = (1, 10, 1000, 480_189)
KS = (1, 10, 41, 1024)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the selection kernels have no "
                    "CPU mode")
    return torch.device("cuda")


def _bounds(B, n, layout, seed, dev):
    """Integer r_lo in [1, 30), r_up = r_lo + [0, 20) (r_up = r_lo on even
    queries, which makes them guaranteed), est an integer in between, the
    last tenth of the users +inf in all three (the elastic pads): (B, n)
    views, of (n, B) buffers in the user-major layout."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    draw = lambda hi: torch.randint(0, hi, (n, B), generator=g,
                                    device=dev).float()
    lo = 1.0 + draw(29)
    up = lo + draw(20) * (torch.arange(B, device=dev) % 2)
    est = torch.minimum(lo + draw(20), up)
    pad = n // 10
    if pad:
        for x in (lo, up, est):
            x[n - pad:] = torch.inf
    out = (lo.T, up.T, est.T)
    return out if layout == "user-major" else tuple(x.contiguous()
                                                     for x in out)


def _same(got, want, label):
    for f in got._fields:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, (label, f)
        assert torch.equal(a, b), (label, f)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3, 16, 19, 64])
def test_selection_kernel_matches_plain_on_card(B):
    dev = _card()
    for n in NS:
        for layout in ("user-major", "query-major"):
            bounds = _bounds(B, n, layout, B * 7 + n, dev)
            for k in (k for k in KS if k <= n):
                before = dict(ops.LAUNCHES)
                got = ops.select_topk(*bounds, k=k, c=2.0, m_items=60)
                assert ops.LAUNCHES["select_kth"] == \
                    before["select_kth"] + 1
                assert ops.LAUNCHES["select_lemma1"] == \
                    before["select_lemma1"] + 1
                want = select_topk_plain(*bounds, k=k, c=2.0, m_items=60)
                _same(got, want, f"B={B} n={n} k={k} {layout}")
            del bounds
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_selection_kernel_replays_in_a_cuda_graph():
    """c and m as 0-d device tensors, written before each replay of a
    captured selection: each replay is the plain version at those
    values."""
    dev = _card()
    bounds = _bounds(16, 4097, "user-major", 3, dev)
    c = torch.tensor(2.0, device=dev)
    m = torch.tensor(60.0, device=dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        ops.select_topk(*bounds, k=41, c=c, m_items=m)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ops.select_topk(*bounds, k=41, c=c, m_items=m)
    for cv, mv in ((2.0, 60.0), (1.25, 75.0), (3.0, 30.0)):
        c.fill_(cv)
        m.fill_(mv)
        graph.replay()
        torch.cuda.synchronize()
        want = select_topk_plain(*bounds, k=41, c=c, m_items=m)
        _same(out, want, f"replay at c={cv}, m={mv}")
