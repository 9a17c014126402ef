"""The selection's launcher: steps 2-3 of §4.3 (`core.query.select_topk`)
in two stages, `select.kth` (R↓_k, R↑_k) and `select.lemma1` (the
composite key, its k smallest users, the counts), each a scan launch and
a merge launch per 64 of k.

Replaces no TPU kernel: the reference leaves these steps to XLA's `top_k`
and sort. Its source is `csrc/select_topk.cu`, which also says what
bounds it; its public wrapper is `ops.select_topk`, and its plain version
`core.query.select_topk_plain`.

The kernels read the (B, n) bounds through their strides: step 1's
user-major buffers and query-major tensors alike, with no copy. `plan`
asks the library once per shape how many blocks fit on the card, and the
scratch both stages share.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_PLANS: dict[tuple, tuple[int, int]] = {}


def plan(B: int, n: int, k: int, device: torch.device) -> tuple[int, int]:
    """(G, scratch bytes) of a selection of k over (B, n) bounds: G blocks
    along the users of each group of 16 queries."""
    key = (B, n, k, device.index)
    got = _PLANS.get(key)
    if got is None:
        out = (ctypes.c_longlong * 2)()
        with torch.cuda.device(device):
            _build.call("select_topk", "select_plan", B, n, k,
                        ctypes.addressof(out))
        got = _PLANS[key] = (int(out[0]), int(out[1]))
    return got


def _view(x: torch.Tensor) -> tuple:
    return (x.data_ptr(), x.stride(0), x.stride(1))


def kth_kernel_call(r_lo: torch.Tensor, r_up: torch.Tensor, k: int,
                    G: int, scratch: torch.Tensor, R: torch.Tensor) -> None:
    """select.kth: R (2, B) f32 ← the k-th smallest of each query's r_lo
    and r_up. Inputs are checked by the caller."""
    B, n = r_lo.shape
    _build.call("select_topk", "select_kth", *_view(r_lo), *_view(r_up), B,
                n, k, G, R.data_ptr(), scratch.data_ptr(),
                torch.cuda.current_stream(r_lo.device).cuda_stream)


def _scalar(x, offset: float) -> tuple:
    """(device pointer, None) for a 0-d f32 device tensor, read when the
    kernel runs (then `offset` is added there in f32), else (None, the
    f32 value of x + offset)."""
    if isinstance(x, torch.Tensor):
        return x.data_ptr(), 0.0
    return None, float(x + offset)


def lemma1_kernel_call(r_lo: torch.Tensor, r_up: torch.Tensor,
                       est: torch.Tensor, k: int, G: int,
                       scratch: torch.Tensor, R: torch.Tensor, c, m_items,
                       indices: torch.Tensor, est_rank: torch.Tensor,
                       guaranteed: torch.Tensor, counts: torch.Tensor
                       ) -> None:
    """select.lemma1 against R (`kth_kernel_call`'s): indices (B, k)
    int64, est_rank (B, k) f32, guaranteed (B,) bool, counts (2, B) int32
    (n_accepted, n_pruned). `c` and `m_items` are Python numbers or 0-d
    f32 tensors on the bounds' device. Inputs are checked by the
    caller."""
    B, n = r_lo.shape
    c_ptr, c_val = _scalar(c, 0.0)
    m_ptr, big = _scalar(m_items, 2.0)
    _build.call("select_topk", "select_lemma1", *_view(r_lo), *_view(r_up),
                *_view(est), B, n, k, G, R.data_ptr(), c_ptr, c_val, m_ptr,
                big, indices.data_ptr(), est_rank.data_ptr(),
                guaranteed.data_ptr(), counts.data_ptr(), scratch.data_ptr(),
                torch.cuda.current_stream(r_lo.device).cuda_stream)
