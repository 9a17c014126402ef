"""The least bytes and operations at the Netflix and Amazon-Kindle shapes
against figures reckoned by hand."""
import pytest
import torch

from rkbench import counts, manifest

F32, INT8 = manifest.storage("f32"), manifest.storage("int8")

N, D, TAU, B, K = 480_189, 200, 500, 16, 10


def test_search_bytes():
    # a 2,000-byte f32 thresholds row: 63 sectors, 7 probed a query
    assert counts.search_bytes(4 * TAU, 1) == 7 * 32
    assert counts.search_bytes(4 * TAU, 8) == 8 * 7 * 32
    assert counts.search_bytes(4 * TAU, 16) == 2000      # the whole row


def test_gather_bytes_counts_distinct_sectors():
    tau = 16                                # 64-byte f32 rows: 2 sectors
    idx = torch.tensor([[0, 16], [8, 9]])
    # row 0 reads T[0] (idx 0 reads no T[-1]) and T[15] (idx 16 no T[16]);
    # row 1 T[7], T[8], T[8], T[9]: flat cells 0, 15, 23, 24, 25, which
    # are sectors 0, 1, 2, 3, 3 at 4 bytes and all sector 0 at 1 byte
    assert counts.gather_bytes(idx, tau, 4) == 4 * 32
    assert counts.gather_bytes(idx, tau, 1) == 32
    # with idx_lo = 0 no T[idx_lo - 1]: cells 0, 24, 25, sectors 0 and 3
    lo = torch.zeros_like(idx)
    assert counts.gather_bytes(idx, tau, 4, lo) == 2 * 32


def test_netflix_f32_counts():
    nbytes, flops = F32.query(N, D, TAU, B, K, table_bytes=0)
    # users 384,151,200 + thresholds searched 960,378,000 + queries 12,800
    # + answers 1,920
    assert nbytes == 1_344_543_920
    assert flops == 3_073_209_600
    s_bytes, s_flops = F32.step1(N, D, TAU, B, table_bytes=0)
    # + the 12·n·B bytes of bounds, - the answers
    assert s_bytes == 384_164_000 + 960_378_000 + 92_196_288
    assert s_flops == 2 * N * D * B + N * B * 9
    # bytes-bound: 0.40 ms before the table's sectors
    assert counts.least_seconds(nbytes, flops) == pytest.approx(
        1_344_543_920 / 3.35e12)


def test_amazon_int8_counts():
    n = 1_406_890
    nbytes, flops = INT8.query(n, D, TAU, B, K, table_bytes=0)
    assert nbytes == n * D + 28 * n + 12_800 + 1_920 == 320_785_640
    s_bytes, _ = INT8.step1(n, D, TAU, B, table_bytes=0)
    assert s_bytes == n * D + 28 * n + 4 * (B * D + B) + 12 * n * B
    assert counts.least_seconds(nbytes, flops) == pytest.approx(
        max(320_785_640 / 3.35e12, 2 * n * D * B / 67e12))


def test_unknown_storage_is_refused():
    with pytest.raises(FileNotFoundError):
        manifest.storage("bf16")
