"""The frozen reference against a brute force at a tiny size, and the int8
tier's guarantee: its bounds contain the f32 bounds."""
import math

import pytest
import torch

from rkbench import inputs
from rkbench.references import rkranks

CFG = {"n_users": 60, "n_items": 90, "d": 8, "tau": 12, "omega": 3, "s": 5,
       "storage": "f32",
       "embeddings": {"kind": "clustered", "n_clusters": 4, "norm_spread": 0.3,
                      "cluster_strength": 1.0}}
K, C = 4, 2.0


@pytest.fixture(scope="module")
def data():
    return inputs.make(CFG, 2**31 + 7, "cpu")


def brute(data, qs, k, c):
    """Definition by loops: Algorithm 1's table cell by cell, the lookup
    and estimate of each (user, query), and the selection by sorting
    (key, index) pairs."""
    users, items = data["users"], data["items"]
    tau, m = CFG["tau"], items.shape[0]
    norms = [float(torch.linalg.norm(items[j])) for j in range(m)]
    order = sorted(range(m), key=lambda j: -norms[j])       # stable
    samples = [items[order[p]] for p in data["positions"].tolist()]
    w = data["weights"].tolist()
    out = []
    for q in qs:
        rows = []
        for u in users:
            s = [float(u @ p) for p in samples]
            lo, hi = min(s), max(s)
            pad = 0.05 * max(hi - lo, 1e-6)
            t = [(lo - pad) + j / (tau - 1) * ((hi + pad) - (lo - pad))
                 for j in range(tau)]
            T = [1 + sum(wi for si, wi in zip(s, w) if si > tj) for tj in t]
            uq = float(u @ q)
            idx = sum(tj <= uq for tj in t)
            r_up = m + 1 if idx == 0 else T[idx - 1]
            r_lo = 1.0 if idx == tau else T[idx]
            rng = t[-1] - t[0]
            if 0 < idx < tau:
                est = r_up + (r_lo - r_up) * (uq - t[idx - 1]) / (
                    t[idx] - t[idx - 1])
            elif idx == tau:
                est = 1 + (r_up - 1) / (1 + tau * (uq - t[-1]) / rng)
            else:
                est = (m + 1) - (m + 1 - r_lo) * math.exp(
                    -tau * (t[0] - uq) / rng)
            est = min(max(est, r_lo), r_up)
            above = max(uq - t[-1], 0.0) / rng
            rows.append((r_lo, r_up, est - 0.5 * above / (1 + above)))
        R_lo = sorted(r[0] for r in rows)[k - 1]
        R_up = sorted(r[1] for r in rows)[k - 1]
        keys = []
        for i, (r_lo, r_up, est) in enumerate(rows):
            if c * R_lo >= R_up:
                key = est
            else:
                cls = 0 if r_up <= c * R_lo else 2 if r_lo > R_up else 1
                key = cls * (m + 2) + est
            keys.append((key, i))
        out.append((rows, [i for _, i in sorted(keys)[:k]]))
    return out


def test_reference_matches_the_brute_force(data):
    ref = rkranks.Reference(data["users"], data["items"], data["positions"],
                            data["weights"], CFG)
    qs = data["items"][[3, 17, 40]]
    r_lo, r_up, est = ref.bounds(qs)
    idx, est_k = ref.query(qs, K, C)
    for b, (rows, top) in enumerate(brute(data, qs, K, C)):
        want = torch.tensor(rows, dtype=torch.float64)
        got = torch.stack([r_lo[b], r_up[b], est[b]], 1).double()
        # f32 against float64 loops: the table cells equal, the estimate
        # within f32 rounding of the interpolation
        assert torch.equal(got[:, :2], want[:, :2].float().double())
        assert torch.allclose(got[:, 2], want[:, 2], rtol=1e-4, atol=1e-4)
        assert idx[b].tolist() == top
        assert torch.equal(est_k[b], est[b][idx[b]])


def test_int8_bounds_contain_the_f32_bounds(data):
    f32 = rkranks.Reference(data["users"], data["items"], data["positions"],
                            data["weights"], CFG)
    i8 = rkranks.Reference(data["users"], data["items"], data["positions"],
                           data["weights"], dict(CFG, storage="int8"))
    qs = data["items"][:16]
    lo32, up32, _ = f32.bounds(qs)
    lo8, up8, est8 = i8.bounds(qs)
    assert bool((lo8 <= lo32).all()) and bool((up8 >= up32).all())
    assert bool((est8 >= lo8 - 0.5).all()) and bool((est8 <= up8).all())


def test_int4_control_is_coarser_than_int8(data):
    cfg = dict(CFG, storage="int8")
    args = (data["users"], data["items"], data["positions"], data["weights"])
    i8 = rkranks.Reference(*args, cfg)
    i4 = rkranks.Reference(*args, cfg, variant="int4")
    qs = data["items"][:16]
    lo8, up8, _ = i8.bounds(qs)
    lo4, up4, _ = i4.bounds(qs)
    assert float((up4 - lo4).mean()) > float((up8 - lo8).mean())


def test_tf32_round():
    x = torch.tensor([1.0, 1.0 + 2.0**-11, 1.0 + 3 * 2.0**-11,
                      -(1.0 + 2.0**-10 + 2.0**-12), 3.0e-3])
    got = rkranks.tf32_round(x)
    # ties to even at the 10th mantissa bit; others to nearest
    assert got[0] == 1.0 and got[1] == 1.0
    assert got[2] == 1.0 + 2 * 2.0**-10
    assert got[3] == -(1.0 + 2.0**-10)
    assert abs(float(got[4]) - 3.0e-3) <= 3.0e-3 * 2.0**-11
    assert torch.equal(rkranks.tf32_round(got), got)
