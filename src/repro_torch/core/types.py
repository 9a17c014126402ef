"""Core data types of the port.

Counterpart of `repro/core/types.py`: the same configuration fields and
validation, the same `RankTable` / `QueryResult` / `StoredUsers` /
`DeltaCorrection` fields, and the storage tier (`StorageSpec`): f32,
bf16, or int8 with per-row scales. A quantized table and quantized users
carry certified errors that the query folds into its bounds, so that for
every user and query

    r↓_spec ≤ r↓_f32   and   r↑_spec ≥ r↑_f32

(the reference's module docstring gives the proof obligation term by
term). `pack_table`, `pack_users` and `pack_scores` are the one path
from f32 arrays to stored ones. Their int8 codes, scales and offsets,
their bf16 casts and the user rows are bitwise the reference's on the
same inputs; `thr_dev` is measured against the grid rounded once from
double (see `pack_table`).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

# bf16 keeps 8 mantissa bits: a round-to-nearest cast is within 2^-9
# relative; 2^-7 over-covers it, the reciprocal terms included.
EPS_BF16 = 2.0 ** -7

# int8 codes live in [-127, 127]; -128 is left free, as in the reference.
_I8_MAX = 127.0

# Extra widening of int8 comparisons, in quantization steps: covers the
# f32 rounding of the (x - off) / scale transform.
_I8_TRANSFORM_PAD = 1e-4

_KINDS = {"f32": "f32", "float32": "f32", "bf16": "bf16",
          "bfloat16": "bf16", "int8": "int8"}


def f32_scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """`value` rounded once to f32, as a 0-d tensor on `like`'s device.

    A divisor must be a tensor: PyTorch's CUDA division by a Python
    number multiplies by its f32 reciprocal, which is not the IEEE
    quotient that the reference and the kernels compute."""
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def _quant_affine_rows(x: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-row affine int8 quantization: codes in [-127, 127] with
    x ≈ code·scale + offset, |error| ≤ scale/2. Returns (codes (n, τ)
    int8, scale (n, 1) f32, offset (n, 1) f32)."""
    lo = x.amin(dim=1, keepdim=True)
    hi = x.amax(dim=1, keepdim=True)
    off = 0.5 * (lo + hi)
    scale = torch.clamp(hi - lo, min=1e-12) / f32_scalar(2.0 * _I8_MAX, x)
    q = torch.clamp(torch.round((x - off) / scale), -_I8_MAX, _I8_MAX)
    return q.to(torch.int8), scale, off


def _int8_code_grid(tau: int, device) -> torch.Tensor:
    """The uniform code grid -127 + j·254/(τ-1), j < τ, computed in
    double and rounded once to f32 (1, τ)."""
    j = torch.arange(tau, dtype=torch.float64, device=device)
    return (-_I8_MAX + j * (2.0 * _I8_MAX / (tau - 1))).to(
        torch.float32)[None, :]


class StoredUsers(NamedTuple):
    """Spec-space user matrix (bf16/int8 specs; f32 passes the raw array).

    rows:      (n, d) bf16 or int8 stored rows.
    scale:     (n, 1) f32 per-user symmetric scale, int8 only.
    row_slack: (n, 1) f32 certified per-row score-error coefficient:
               |score(stored) − score(f32)| ≤ row_slack · ‖q‖₁.
    """

    rows: torch.Tensor
    scale: Optional[torch.Tensor]
    row_slack: Optional[torch.Tensor]

    @property
    def shape(self):
        return self.rows.shape

    def take_rows(self, idx: torch.Tensor) -> "StoredUsers":
        """Row-gather; the scale and slack vectors travel with their rows."""
        g = lambda a: None if a is None else a[idx]
        return StoredUsers(rows=self.rows[idx], scale=g(self.scale),
                           row_slack=g(self.row_slack))


def stored_rows(users) -> torch.Tensor:
    """The raw row tensor of either a plain (n, d) tensor or StoredUsers."""
    return users.rows if isinstance(users, StoredUsers) else users


def take_user_rows(users, idx: torch.Tensor):
    """Row-gather either user representation (pruned phase B)."""
    if isinstance(users, StoredUsers):
        return users.take_rows(idx)
    return users[idx]


@dataclasses.dataclass(frozen=True)
class StorageSpec:
    """How the user matrix, thresholds and rank table are stored.

    kind "f32": exact, the f32 query path unchanged; "bf16": bf16 rows
    everywhere, bounds certified by a two-sided bucketize of the monotone
    cast and EPS_BF16 widening; "int8": int8 rows with per-user scales
    (symmetric for users, affine for thresholds and table), bounds
    certified by half-step widening and a closed-form bucketize.
    """

    kind: str = "f32"

    def __post_init__(self):
        if self.kind not in ("f32", "bf16", "int8"):
            raise ValueError(f"unknown StorageSpec kind {self.kind!r}; "
                             "expected one of ('f32', 'bf16', 'int8')")

    @classmethod
    def parse(cls, spec) -> "StorageSpec":
        """Coerce a StorageSpec, a kind, or a dtype name ("bfloat16")."""
        if isinstance(spec, StorageSpec):
            return spec
        kind = _KINDS.get(str(spec))
        if kind is None:
            raise ValueError(f"unknown storage spec {spec!r}; expected "
                             f"one of {sorted(_KINDS)}")
        return cls(kind=kind)

    @property
    def is_exact(self) -> bool:
        return self.kind == "f32"

    @property
    def table_dtype(self) -> torch.dtype:
        return {"f32": torch.float32, "bf16": torch.bfloat16,
                "int8": torch.int8}[self.kind]

    def pack_table(self, thresholds: torch.Tensor, table: torch.Tensor,
                   m: int = 0) -> "RankTable":
        """Materialize f32 (n, τ) thresholds/table in spec space.

        For int8, `thr_dev` is the largest deviation per row of the f32
        threshold codes (t - off)/scale from the uniform code grid, so
        that the query's closed-form bucketize is certified. The grid
        here is rounded once from double; the reference builds it with
        `jnp.linspace`, whose f32 values differ from it by up to ~1.5e-5
        codes, so `thr_dev` agrees with the reference's to that, not
        bitwise (the int8 codes, scales and offsets are bitwise equal).
        """
        thresholds = thresholds.to(torch.float32)
        table = table.to(torch.float32)
        if self.kind == "f32":
            return RankTable(thresholds=thresholds, table=table, m=m)
        if self.kind == "bf16":
            return RankTable(thresholds=thresholds.to(torch.bfloat16),
                             table=table.to(torch.bfloat16), m=m)
        thr_q, thr_sc, thr_off = _quant_affine_rows(thresholds)
        tab_q, tab_sc, tab_off = _quant_affine_rows(table)
        grid = _int8_code_grid(thresholds.shape[1], thresholds.device)
        thr_dev = ((thresholds - thr_off) / thr_sc - grid).abs().amax(
            dim=1, keepdim=True)
        return RankTable(thresholds=thr_q, table=tab_q, m=m,
                         thr_scale=thr_sc, thr_off=thr_off,
                         tab_scale=tab_sc, tab_off=tab_off, thr_dev=thr_dev)

    def pack_users(self, users: torch.Tensor) -> Optional[StoredUsers]:
        """Materialize the (n, d) user matrix in spec space; None for f32
        (the raw matrix is the storage). `row_slack` bounds the score
        error per unit of ‖q‖₁: scale/2 for int8, EPS_BF16·‖row‖∞ for
        bf16."""
        users = users.to(torch.float32)
        if self.kind == "f32":
            return None
        if self.kind == "bf16":
            rows = users.to(torch.bfloat16)
            slack = EPS_BF16 * rows.to(torch.float32).abs().amax(
                dim=1, keepdim=True)
            return StoredUsers(rows=rows, scale=None, row_slack=slack + 1e-12)
        scale = torch.clamp(users.abs().amax(dim=1, keepdim=True),
                            min=1e-12) / f32_scalar(_I8_MAX, users)
        rows = torch.clamp(torch.round(users / scale), -_I8_MAX, _I8_MAX)
        return StoredUsers(rows=rows.to(torch.int8), scale=scale,
                           row_slack=0.5 * scale)

    def pack_scores(self, scores: torch.Tensor, pad: int
                    ) -> tuple[torch.Tensor, Optional[torch.Tensor],
                               Optional[torch.Tensor]]:
        """Materialize per-row ascending delta score sets (n, t) in spec
        space, left-padded with `pad` absent-sentinel columns: −inf at
        f32 and bf16, −128 at int8, which no count ever includes.

        Returns (rows, scale, offset); scale and offset (n, 1) f32 are
        per-row affine int8 parameters, None otherwise. The quantization
        is monotone per row, so the rows stay sorted."""
        scores = scores.to(torch.float32)
        if self.kind == "int8":
            rows, scale, off = _quant_affine_rows(scores)
            fill = -128
        else:
            rows = scores if self.kind == "f32" else scores.to(
                torch.bfloat16)
            scale = off = None
            fill = -torch.inf
        if pad:
            rows = torch.cat([torch.full((rows.shape[0], pad), fill,
                                         dtype=rows.dtype,
                                         device=rows.device), rows], dim=1)
        return rows, scale, off


@dataclasses.dataclass(frozen=True)
class RankTableConfig:
    """Static configuration for Algorithm 1 (pre-processing).

    tau: thresholds per user (table columns); omega: norm-stratified
    partitions of P; s: samples per partition; threshold_mode: how
    f_min/f_max is obtained ("sampled", "norm_bound" or "exact");
    range_pad: fractional widening of the sampled range;
    sample_with_replacement: stratified sampling mode; storage_dtype:
    the storage spec ("float32"/"f32", "bfloat16"/"bf16" or "int8").
    """

    tau: int = 500
    omega: int = 10
    s: int = 64
    threshold_mode: str = "sampled"
    range_pad: float = 0.05
    sample_with_replacement: bool = False
    storage_dtype: str = "float32"

    def __post_init__(self):
        if self.tau < 2:
            raise ValueError(f"tau must be >= 2, got {self.tau}")
        if self.omega < 1:
            raise ValueError(f"omega must be >= 1, got {self.omega}")
        if self.s < 1:
            raise ValueError(f"s must be >= 1, got {self.s}")
        if self.threshold_mode not in ("sampled", "norm_bound", "exact"):
            raise ValueError(f"unknown threshold_mode {self.threshold_mode!r}")
        StorageSpec.parse(self.storage_dtype)   # raises on unknown specs

    @property
    def storage(self) -> StorageSpec:
        """The parsed storage spec."""
        return StorageSpec.parse(self.storage_dtype)


class RankTable(NamedTuple):
    """The paper's rank table T (§4.1) plus its per-user thresholds.

    thresholds: (n, tau), ascending along axis 1: f32, bf16, or int8
                codes under the per-row affine (thr_scale, thr_off).
    table:      (n, tau), non-increasing along axis 1 (Eq. 1): f32,
                bf16, or int8 codes under (tab_scale, tab_off).
    m:          |P| as a Python int (the out-of-range upper bound is m+1).
    thr_scale/thr_off/tab_scale/tab_off: (n, 1) f32 per-row affine
                parameters, int8 only (None otherwise).
    thr_dev:    (n, 1) f32, int8 only: the largest deviation of each
                row's f32 thresholds from the uniform code grid, in code
                units; it certifies the closed-form bucketize.
    """

    thresholds: torch.Tensor
    table: torch.Tensor
    m: int
    thr_scale: Optional[torch.Tensor] = None
    thr_off: Optional[torch.Tensor] = None
    tab_scale: Optional[torch.Tensor] = None
    tab_off: Optional[torch.Tensor] = None
    thr_dev: Optional[torch.Tensor] = None

    @property
    def n(self) -> int:
        return self.thresholds.shape[0]

    @property
    def tau(self) -> int:
        return self.thresholds.shape[1]

    @property
    def spec_kind(self) -> str:
        """The storage kind, derived from the tensors themselves."""
        if self.thr_scale is not None:
            return "int8"
        if self.thresholds.dtype == torch.bfloat16:
            return "bf16"
        return "f32"

    _QUANT_FIELDS = ("thr_scale", "thr_off", "tab_scale", "tab_off",
                     "thr_dev")

    def take_rows(self, idx: torch.Tensor) -> "RankTable":
        """Row-gather every row-aligned field; the int8 vectors travel
        with their rows."""
        g = lambda a: None if a is None else a[idx]
        return RankTable(thresholds=self.thresholds[idx],
                         table=self.table[idx], m=self.m,
                         **{f: g(getattr(self, f))
                            for f in self._QUANT_FIELDS})

    def set_rows(self, idx: torch.Tensor, rows: "RankTable") -> "RankTable":
        """A new table with the packed rows `rows` (`StorageSpec.
        pack_table`) in rows `idx`: the upsert path. Out of place, so
        that a snapshot that still holds this table sees it unchanged
        (and the pruned backend's summaries, cached by tensor identity,
        stay valid); the int8 vectors are per row, so the update stays
        local."""
        s = lambda a, b: None if a is None else a.index_copy(0, idx, b)
        return RankTable(
            thresholds=s(self.thresholds,
                         rows.thresholds.to(self.thresholds.dtype)),
            table=s(self.table, rows.table.to(self.table.dtype)), m=self.m,
            **{f: s(getattr(self, f), getattr(rows, f))
               for f in self._QUANT_FIELDS})

    def append_rows(self, rows: "RankTable") -> "RankTable":
        """A new table with the packed rows `rows` appended (user appends)."""
        c = lambda a, b: None if a is None else torch.cat([a, b])
        return RankTable(
            thresholds=c(self.thresholds,
                         rows.thresholds.to(self.thresholds.dtype)),
            table=c(self.table, rows.table.to(self.table.dtype)), m=self.m,
            **{f: c(getattr(self, f), getattr(rows, f))
               for f in self._QUANT_FIELDS})


class DeltaCorrection(NamedTuple):
    """Query-time correction for a mutated index (`repro_torch.index`).

    The rank table is built over a frozen base item set P₀; inserted
    items A and deleted base items D shift every rank exactly:

        r(q, u, P') = r(q, u, P₀) + #{a ∈ A : u·a > u·q}
                                  − #{p ∈ D : u·p > u·q}

    for P' = (P₀ \\ D) ∪ A, so the bounds move by exact counts
    (`rank_table.apply_delta_corrections`). The score sets are sorted per
    row, so a count is one search per (user, query).

    add_scores: (n, n_add) ascending per row, u·a for every a ∈ A, in
                spec space (f32, bf16, or int8 codes under (add_scale,
                add_off)), left-padded with the absent sentinel (−inf,
                −128) to a power-of-two width. Quantized sets give
                certified count ranges instead of exact counts.
    del_scores: (n, n_del) the same for every p ∈ D.
    user_live:  (n,) bool; False rows are deleted users, whose bounds
                and estimate read +inf.
    m_new:      |P'| = |P₀| − |D| + |A| as a Python int.
    add_scale/add_off/del_scale/del_off: (n, 1) f32, int8 only.
    """

    add_scores: torch.Tensor
    del_scores: torch.Tensor
    user_live: torch.Tensor
    m_new: int
    add_scale: Optional[torch.Tensor] = None
    add_off: Optional[torch.Tensor] = None
    del_scale: Optional[torch.Tensor] = None
    del_off: Optional[torch.Tensor] = None

    @property
    def n_add(self) -> int:
        return self.add_scores.shape[1]

    @property
    def n_del(self) -> int:
        return self.del_scores.shape[1]

    def take_rows(self, idx: torch.Tensor) -> "DeltaCorrection":
        """Row-gather the per-user fields (pruned phase B)."""
        g = lambda a: None if a is None else a[idx]
        return DeltaCorrection(
            add_scores=self.add_scores[idx], del_scores=self.del_scores[idx],
            user_live=self.user_live[idx], m_new=self.m_new,
            add_scale=g(self.add_scale), add_off=g(self.add_off),
            del_scale=g(self.del_scale), del_off=g(self.del_off))

    def selection_m(self) -> int:
        """The `m_items` of the §4.3 selection key on the delta path: the
        class offset must exceed the shifted estimate range
        [1 − n_del, m + 1 + n_add], whose width is at most m_new + 2·n_del
        for the PADDED widths, so the padding is part of the result."""
        return self.m_new + 2 * self.n_del


class QueryResult(NamedTuple):
    """Output of one c-approximate reverse k-ranks query (§4.3); with a
    leading B axis on every field for a batch.

    indices (k,) int64 best-first; est_rank (k,) f32; r_lo/r_up (n,) f32;
    R_lo_k/R_up_k () f32; guaranteed () bool (c·R↓_k ≥ R↑_k);
    n_accepted/n_pruned () int32 (Lemma 1 (1) and (2)).
    """

    indices: torch.Tensor
    est_rank: torch.Tensor
    r_lo: torch.Tensor
    r_up: torch.Tensor
    R_lo_k: torch.Tensor
    R_up_k: torch.Tensor
    guaranteed: torch.Tensor
    n_accepted: torch.Tensor
    n_pruned: torch.Tensor


def kth_smallest(x: torch.Tensor, k: int) -> torch.Tensor:
    """k-th smallest value along the last axis (k is 1-indexed).

    Values only, so the tie order of `topk` does not matter. Not
    `torch.kthvalue`: on CUDA it reduces each row in one block, 2.5 ms
    for a row of 480,189 users on an H100 against 0.14 ms for `topk`.
    """
    return torch.topk(x, k, dim=-1, largest=False).values[..., k - 1]


def partition_sizes(m: int, omega: int) -> tuple[int, ...]:
    """Sizes of the ω norm-descending partitions of P (Alg. 1 line 3):
    the first (m mod ω) buckets carry one extra item."""
    base = m // omega
    extra = m % omega
    return tuple(base + (1 if l < extra else 0) for l in range(omega))
