"""Crash-safe index persistence: atomic snapshot spills and a mutation WAL.

Counterpart of `repro/index/persist.py`, with the same durability model.
The engine's durable state is a large, rarely changing build output and
a small, hot stream of mutations, so they are persisted apart:

  spill  — one ATOMIC file per published rebuild epoch
           (``spill-<epoch:016d>``): written to a temp name, flushed,
           fsynced, then `os.replace`d, and the directory fsynced, so a
           reader never sees a half-written spill under its final name.
           The content is CRC32-framed with a u64 length, so a spill torn
           anyway (a crash between rename and data sync, bit rot, an
           injected ``persist.spill`` fault) is detected and skipped,
           never loaded. Rank-table arrays are stored as packed (int8
           codes; bf16 as raw uint16 bits, viewed back with
           `torch.Tensor.view(torch.bfloat16)`). What re-derives
           deterministically is not stored: the samples and the norm
           order from (base items, positions, weights) through
           `BaseIndex.create`, the spec-space users from `pack_users`,
           the delta correction from `build_correction`.
  WAL    — an append-only log per spill epoch (``wal-<epoch:016d>.log``)
           of the four mutations (insert_items / delete_items /
           upsert_users / delete_users), one CRC-framed record each,
           fsynced per append. Recovery replays it through the engine's
           own mutation API, so every invariant of the live path holds
           on the recovered engine; inserted ids are checked against the
           recorded ones, and a divergence is a `PersistError`.

Where the port differs from the reference:

  * The sampling state. The reference spills its JAX build key and
    re-derives the samples from it. A torch generator is consumed by its
    draw, so the port spills the current base's `positions` and
    `weights`, and the state of the build's generator from before its
    draw (`ReverseKRanksEngine.build` keeps it as (device, state)) as a
    uint8 array with its device type, or nothing for an engine built
    from given positions and weights. With them a restored engine's
    later `rebuild()` draws what the spilling engine's would.
  * The spill magic is the port's own (``RKTSPIL1``): a spill of the JAX
    package (``RKRSPIL1``) is refused with `PersistError`, as any other
    unusable spill is.
  * The WAL keeps the reference's framing and record layout (``RKW1``,
    CRC, length, an npz payload with a JSON ``meta``), so each package
    reads the other's log.
  * A spill at Netflix size is about 2.3 GB at f32: the frame's header
    and the payload are written one after the other, never concatenated
    into a second host copy. The bytes on disk are the same.
  * Restore is bitwise on the device type that spilled. On another
    device type the correction and the packed users are recomputed by
    another library's products, and the generator's state cannot be
    carried over (a restored engine then needs
    `rebuild(positions=, weights=)`).

Durability model: the durable point is (newest valid spill) + (its WAL
prefix up to the first torn record). A torn WAL TAIL, the expected
artifact of a crash mid-append, truncates to the last complete record; a
corrupt INTERIOR record (an intact record follows a bad one), a sequence
gap or an unknown op means the log cannot be trusted, and recovery
raises `PersistError`. A torn NEWEST spill falls back to the previous
spill epoch (its own WAL is still on disk); `keep_spills` bounds how
many durable points are kept.

A WAL WRITE failure at runtime (disk full, an injected
``persist.wal_write`` fault) does not take serving down: it is logged,
counted (``persist_wal_errors_total``), and the WAL is disarmed until
the next spill re-baselines durability. A spill whose write fails
(`OSError`) disarms the WAL the same way and counts there too: the
snapshot it failed to baseline may number its users otherwise than the
previous spill, so durability is the previous spill and the WAL records
written before the failure.

Fault sites (`repro_torch.serve.faults`): ``persist.spill`` (mode
"torn" truncates the spill mid-write) and ``persist.wal_write`` (the
append raises), one flag check each when injection is off.
"""
from __future__ import annotations

import dataclasses
import io
import json
import logging
import os
import re
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.types import RankTable, RankTableConfig
from repro_torch.device import resolve_device
from repro_torch.index import delta as delta_mod
from repro_torch.index.snapshot import IndexSnapshot
from repro_torch.obs import registry as obs
from repro_torch.serve import faults

log = logging.getLogger(__name__)

SPILL_MAGIC = b"RKTSPIL1"       # 8 bytes; the port's own spill format
REFERENCE_SPILL_MAGIC = b"RKRSPIL1"     # the JAX package's, refused here
WAL_MAGIC = b"RKW1"             # 4 bytes; the reference's WAL framing
_SPILL_HDR = len(SPILL_MAGIC) + 4 + 8       # magic + crc32 + u64 length
_WAL_HDR = len(WAL_MAGIC) + 4 + 8

WAL_OPS = ("insert_items", "delete_items", "upsert_users", "delete_users")

# RankTable fields spilled as arrays (m goes in the meta; the int8 fields
# are absent at f32 and bf16)
_RT_FIELDS = ("thresholds", "table", "thr_scale", "thr_off", "tab_scale",
              "tab_off", "thr_dev")


class PersistError(RuntimeError):
    """The durable state is unusable (no valid spill, a corrupt WAL
    interior, a replay divergence, a spill of another package): rebuild
    from the master copy. Recovery never degrades to a maybe-wrong
    index."""


@dataclasses.dataclass(frozen=True)
class WalRecord:
    """One decoded mutation record, in append order. `arrays` are numpy
    arrays (a bf16 array, which numpy cannot hold, a torch tensor)."""

    op: str
    seq: int
    arrays: Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class RestoredState:
    """What `ReverseKRanksEngine.restore` needs: the spill-point snapshot,
    the generator state of its build ((device, state), or None), and the
    WAL records to replay on top of it."""

    snapshot: IndexSnapshot
    config: RankTableConfig
    generator_state: Optional[Tuple[torch.device, torch.Tensor]]
    next_item_id: int
    wal: List[WalRecord]
    spill_path: str


@dataclasses.dataclass(frozen=True)
class SpillTimes:
    """Where one spill's wall time went: the copies of its arrays to the
    host, the npz encoding and the CRC, and the write with its fsyncs and
    the rename."""

    bytes: int
    d2h_s: float
    encode_s: float
    write_s: float


# --------------------------------------------------------------- encoding
def _encode_array(value) -> tuple:
    """(savez-safe ndarray, true-dtype name). npy has no bf16, so bf16 is
    stored as raw uint16 bits under the name "bfloat16", as the reference
    stores it; tensors are copied to the host."""
    if isinstance(value, torch.Tensor):
        t = value.detach()
        if t.dtype == torch.bfloat16:
            bits = t.contiguous().view(torch.int16).cpu().numpy()
            return bits.view(np.uint16), "bfloat16"
        a = t.cpu().numpy()
    else:
        a = np.asarray(value)
        if a.dtype.name == "bfloat16":      # a bf16 array of another package
            return np.ascontiguousarray(a).view(np.uint16), "bfloat16"
    return a, a.dtype.name


def _decode_array(a: np.ndarray, name: str):
    """The stored array as numpy, or as a torch bf16 tensor."""
    if name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.int16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    return a


def _to_device(a: np.ndarray, name: str, dev: torch.device) -> torch.Tensor:
    x = _decode_array(a, name)
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x))
    return x.to(dev)


def _pack_npz(arrays: Dict[str, np.ndarray]) -> memoryview:
    """The npz bytes, as a view of the encoder's own buffer (no copy)."""
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getbuffer()


def _unpack_npz(payload) -> Dict[str, np.ndarray]:
    with np.load(io.BytesIO(payload), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def _meta_array(meta: dict) -> np.ndarray:
    return np.frombuffer(json.dumps(meta).encode("utf-8"), np.uint8)


def _header(magic: bytes, payload) -> bytes:
    crc = zlib.crc32(payload) & 0xFFFFFFFF
    return (magic + crc.to_bytes(4, "little")
            + len(payload).to_bytes(8, "little"))


def _frame(magic: bytes, payload) -> bytes:
    return _header(magic, payload) + bytes(payload)


# ------------------------------------------------------------ spill codec
def _spill_arrays(snap: IndexSnapshot, next_item_id: int,
                  generator_state) -> Dict[str, np.ndarray]:
    """Every array of a spill on the host, the meta included."""
    if snap.base is None:
        raise PersistError(
            "cannot spill a snapshot without its base item set; build the "
            "engine with ReverseKRanksEngine.build(...)")
    arrays: Dict[str, np.ndarray] = {}
    dtypes: Dict[str, str] = {}

    def put(name, value):
        arrays[name], dtypes[name] = _encode_array(value)

    rt, base, d = snap.rank_table, snap.base, snap.delta
    put("users", snap.users)
    for f in _RT_FIELDS:
        v = getattr(rt, f)
        if v is not None:
            put(f"rt_{f}", v)
    put("base_items", base.items)
    arrays["base_item_ids"] = np.asarray(base.item_ids, np.int64)
    put("base_positions", base.positions)
    put("base_weights", base.weights)
    gen_device = None
    if generator_state is not None:
        gdev, state = generator_state
        gen_device = torch.device(gdev).type
        arrays["generator_state"] = state.cpu().numpy().astype(np.uint8)
    arrays["delta_base_live"] = np.asarray(d.base_live, bool)
    arrays["delta_added_ids"] = np.asarray(d.added_ids, np.int64)
    if d.added_items is not None:
        put("delta_added_items", d.added_items)
    arrays["delta_user_live"] = np.asarray(d.user_live, bool)
    arrays["delta_touched"] = np.asarray(sorted(d.touched_users), np.int64)
    if snap.user_remap is not None:
        arrays["user_remap"] = np.asarray(snap.user_remap, np.int64)
    meta = {"format": 1, "package": "repro_torch", "epoch": int(snap.epoch),
            "next_item_id": int(next_item_id), "m": int(rt.m),
            "generator_device": gen_device,
            "config": dataclasses.asdict(snap.config), "dtypes": dtypes}
    arrays["meta"] = _meta_array(meta)
    return arrays


def _snapshot_from_arrays(arrays: Dict[str, np.ndarray], dev: torch.device):
    """(snapshot, meta, generator state) from decoded spill arrays on
    `dev`. What is not stored re-derives deterministically (module doc),
    so on the device type that spilled the result is bitwise the
    snapshot that was spilled."""
    meta = json.loads(bytes(arrays["meta"]).decode("utf-8"))
    if meta.get("package") != "repro_torch":
        raise PersistError("spill meta names no repro_torch format; "
                           "rebuild from the master copy")
    dt = meta["dtypes"]

    def get(name):
        if name not in arrays:
            return None
        return _to_device(arrays[name], dt.get(name, ""), dev)

    cfg = RankTableConfig(**meta["config"])
    users = get("users")
    rt = RankTable(m=int(meta["m"]),
                   **{f: get(f"rt_{f}") for f in _RT_FIELDS})
    base = delta_mod.BaseIndex.create(
        get("base_items"), np.asarray(arrays["base_item_ids"], np.int64),
        cfg, get("base_positions"), get("base_weights"))
    delta = delta_mod.DeltaState(
        base_live=np.asarray(arrays["delta_base_live"], bool),
        added_ids=np.asarray(arrays["delta_added_ids"], np.int64),
        added_items=get("delta_added_items"),
        user_live=np.asarray(arrays["delta_user_live"], bool),
        touched_users=frozenset(int(i) for i in arrays["delta_touched"]))
    # build_correction returns None on an empty delta, the rule the
    # engine's _publish follows, so a None correction round-trips too
    corr = delta_mod.build_correction(users, base, delta, base.m_base,
                                      spec=cfg.storage)
    remap = (np.asarray(arrays["user_remap"], np.int64)
             if "user_remap" in arrays else None)
    snap = IndexSnapshot(
        epoch=int(meta["epoch"]), users=users, rank_table=rt, config=cfg,
        base=base, delta=delta, corr=corr, user_remap=remap,
        stored_users=cfg.storage.pack_users(users))
    gen = None
    if ("generator_state" in arrays
            and meta.get("generator_device") == dev.type):
        gen = (dev, torch.from_numpy(
            np.array(arrays["generator_state"], np.uint8)))
    return snap, meta, gen


def _read_spill(path: str) -> Dict[str, np.ndarray]:
    with open(path, "rb") as f:
        head = f.read(_SPILL_HDR)
        if head[:len(REFERENCE_SPILL_MAGIC)] == REFERENCE_SPILL_MAGIC:
            raise PersistError(
                f"spill {path!r} was written by the JAX package (magic "
                f"{REFERENCE_SPILL_MAGIC!r}); the port restores only its "
                "own spills")
        if len(head) < _SPILL_HDR or head[:len(SPILL_MAGIC)] != SPILL_MAGIC:
            raise PersistError(
                f"spill {path!r}: bad magic or truncated header")
        crc = int.from_bytes(head[8:12], "little")
        ln = int.from_bytes(head[12:20], "little")
        payload = f.read(ln)
        extra = len(f.read(1))
    if len(payload) < ln or extra:
        have = _SPILL_HDR + len(payload) + extra
        raise PersistError(f"spill {path!r}: torn (have {have}"
                           f"{'+' if extra else ''} bytes, framed length "
                           f"says {_SPILL_HDR + ln})")
    if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
        raise PersistError(f"spill {path!r}: checksum mismatch")
    return _unpack_npz(payload)


# -------------------------------------------------------------- WAL codec
def _wal_payload(op: str, seq: int, arrays: Dict[str, Any]):
    enc: Dict[str, np.ndarray] = {}
    dtypes: Dict[str, str] = {}
    for name, value in arrays.items():
        enc[name], dtypes[name] = _encode_array(value)
    enc["meta"] = _meta_array({"op": op, "seq": int(seq), "dtypes": dtypes})
    return _pack_npz(enc)


def _decode_wal_payload(payload) -> WalRecord:
    arrays = _unpack_npz(payload)
    meta = json.loads(bytes(arrays.pop("meta")).decode("utf-8"))
    out = {k: _decode_array(v, meta["dtypes"].get(k, ""))
           for k, v in arrays.items()}
    return WalRecord(op=meta["op"], seq=int(meta["seq"]), arrays=out)


def _read_wal(path: str) -> List[WalRecord]:
    """Decode records in order. Torn TAIL → accept the prefix (crash
    mid-append); corrupt INTERIOR (an intact frame exists after the bad
    one) → `PersistError` (module doc)."""
    with open(path, "rb") as f:
        data = f.read()
    records: List[WalRecord] = []
    off, n = 0, len(data)
    while off < n:
        ok = False
        if (data[off:off + len(WAL_MAGIC)] == WAL_MAGIC
                and off + _WAL_HDR <= n):
            crc = int.from_bytes(data[off + 4:off + 8], "little")
            ln = int.from_bytes(data[off + 8:off + 16], "little")
            payload = data[off + _WAL_HDR:off + _WAL_HDR + ln]
            ok = (len(payload) == ln
                  and (zlib.crc32(payload) & 0xFFFFFFFF) == crc)
        if not ok:
            if data.find(WAL_MAGIC, off + 1) != -1:
                raise PersistError(
                    f"WAL {path!r}: corrupt interior record at byte {off} "
                    "(intact records follow it); the log cannot be "
                    "trusted — rebuild from the master copy")
            log.warning("WAL %s: torn tail at byte %d of %d; accepting "
                        "the durable prefix of %d record(s)",
                        path, off, n, len(records))
            break
        rec = _decode_wal_payload(payload)
        if rec.seq != len(records):
            raise PersistError(
                f"WAL {path!r}: sequence gap (record #{len(records)} "
                f"carries seq {rec.seq}); rebuild from the master copy")
        if rec.op not in WAL_OPS:
            raise PersistError(f"WAL {path!r}: unknown op {rec.op!r}")
        records.append(rec)
        off += _WAL_HDR + ln
    return records


# --------------------------------------------------------------- persister
class IndexPersister:
    """Owns one durability directory: spills snapshots atomically and
    appends mutation records to the current WAL (module doc).

    Writes are serialized by the engine's mutation lock in normal use; an
    internal lock makes direct use safe too. `spill` ROTATES the WAL:
    records before it are superseded by it, records after it land in the
    fresh log. That is why the engine spills inside the rebuild's locked
    swap: no mutation can fall between the publish and the rotation.
    `last_spill` holds the `SpillTimes` of the latest spill.
    """

    def __init__(self, path, *, keep_spills: int = 2,
                 registry: Optional[obs.MetricsRegistry] = None):
        if keep_spills < 1:
            raise ValueError(f"keep_spills must be >= 1; got {keep_spills}")
        self.dir = str(path)
        os.makedirs(self.dir, exist_ok=True)
        self.keep_spills = int(keep_spills)
        self.last_spill: Optional[SpillTimes] = None
        self._lock = threading.Lock()
        self._wal = None
        self._wal_broken = False
        self._seq = 0
        reg = registry if registry is not None else obs.get_default()
        self._m_spills = reg.counter(
            "persist_spills_total", "atomic snapshot spills written")
        self._m_wal_records = reg.counter(
            "persist_wal_records_total", "mutation records appended")
        self._m_wal_errors = reg.counter(
            "persist_wal_errors_total",
            "WAL appends that failed (durability degraded to last spill)")
        self._m_spill_bytes = reg.gauge(
            "persist_spill_bytes", "size of the most recent spill file")

    # ------------------------------------------------------------- writing
    def spill(self, snap: IndexSnapshot, *, next_item_id: int,
              generator_state=None) -> str:
        """Write ``spill-<epoch>`` atomically, rotate the WAL to a fresh
        ``wal-<epoch>.log``, prune durable points beyond `keep_spills`.
        `generator_state` is the engine's (device, state) of its build's
        generator, or None. Returns the spill path."""
        t0 = time.perf_counter()
        arrays = _spill_arrays(snap, next_item_id, generator_state)
        t1 = time.perf_counter()
        payload = _pack_npz(arrays)
        del arrays
        head = _header(SPILL_MAGIC, payload)
        t2 = time.perf_counter()
        total = len(head) + len(payload)
        keep = total
        if faults.ACTIVE is not None and faults.should_fire("persist.spill"):
            # torn-write chaos: persist a deliberately truncated file, as
            # a crash mid-spill would; recovery must detect it by checksum
            # and fall back, never load it
            keep = max(total // 2, len(SPILL_MAGIC))
        path = os.path.join(self.dir, f"spill-{snap.epoch:016d}")
        tmp = path + ".tmp"
        with self._lock:
            try:
                with open(tmp, "wb") as f:
                    f.write(head[:keep])
                    if keep > len(head):
                        f.write(payload[:keep - len(head)])
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, path)
                self._fsync_dir()
                if self._wal is not None:
                    self._wal.close()
                    self._wal = None
                self._wal = open(
                    os.path.join(self.dir, f"wal-{snap.epoch:016d}.log"),
                    "wb")
            except OSError:
                # the open WAL extends the previous spill; the records of
                # a snapshot this spill failed to baseline (a compacting
                # or reordering rebuild renumbers users) would replay onto
                # the wrong rows: disarm it until a spill succeeds
                self._wal_broken = True
                self._m_wal_errors.inc()
                raise
            self._wal_broken = False    # a fresh baseline re-arms the WAL
            self._seq = 0
            self._m_spills.inc()
            self._m_spill_bytes.set(keep)
            self._prune()
        self.last_spill = SpillTimes(bytes=keep, d2h_s=t1 - t0,
                                     encode_s=t2 - t1,
                                     write_s=time.perf_counter() - t2)
        return path

    def append(self, op: str, arrays: Dict[str, Any]) -> bool:
        """Append one fsynced mutation record to the current WAL. Returns
        False (serving continues, durability degraded to the last spill)
        when no WAL is open or a write failed since the last spill."""
        if op not in WAL_OPS:
            raise ValueError(f"unknown WAL op {op!r}; one of {WAL_OPS}")
        with self._lock:
            if self._wal is None or self._wal_broken:
                return False
            frame = _frame(WAL_MAGIC, _wal_payload(op, self._seq, arrays))
            try:
                if (faults.ACTIVE is not None
                        and faults.should_fire("persist.wal_write")):
                    raise OSError(
                        "injected WAL write failure (persist.wal_write)")
                self._wal.write(frame)
                self._wal.flush()
                os.fsync(self._wal.fileno())
            except OSError:
                self._wal_broken = True
                self._m_wal_errors.inc()
                log.exception(
                    "WAL append failed; serving continues with durability "
                    "degraded to the last spill until the next rebuild "
                    "spills a fresh baseline")
                return False
            self._seq += 1
            self._m_wal_records.inc()
            return True

    def close(self) -> None:
        with self._lock:
            if self._wal is not None:
                self._wal.close()
                self._wal = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ----------------------------------------------------------- internals
    def _fsync_dir(self) -> None:
        try:        # the rename itself must be durable, where supported
            fd = os.open(self.dir, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        except OSError:
            pass

    def _prune(self) -> None:
        for ep in _spill_epochs(self.dir)[:-self.keep_spills]:
            for fn in (f"spill-{ep:016d}", f"wal-{ep:016d}.log"):
                try:
                    os.remove(os.path.join(self.dir, fn))
                except OSError:
                    pass


# --------------------------------------------------------------- recovery
def _spill_epochs(path: str) -> List[int]:
    out = []
    for fn in os.listdir(path):
        m = re.fullmatch(r"spill-(\d{16})", fn)
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


def load_latest(path, *, device=None) -> RestoredState:
    """Load the newest valid durable point of a persistence directory
    onto `device` (the CUDA card unless the caller passes device='cpu'):
    the newest checksum-valid spill and its WAL records. A torn newest
    spill falls back to the previous one (warned); no valid spill at all,
    or a corrupt WAL interior, raises `PersistError`."""
    dev = resolve_device(device)
    path = str(path)
    candidates = _spill_epochs(path)
    if not candidates:
        raise PersistError(f"no spill files in {path!r}")
    last_err: Optional[PersistError] = None
    for ep in reversed(candidates):
        spill_path = os.path.join(path, f"spill-{ep:016d}")
        try:
            arrays = _read_spill(spill_path)
            if "meta" not in arrays:
                raise PersistError(f"spill {spill_path!r}: no meta")
        except PersistError as e:
            log.warning("%s; falling back to the previous durable point",
                        e)
            last_err = e
            continue
        wal_path = os.path.join(path, f"wal-{ep:016d}.log")
        records = _read_wal(wal_path) if os.path.exists(wal_path) else []
        snap, meta, gen = _snapshot_from_arrays(arrays, dev)
        return RestoredState(snapshot=snap, config=snap.config,
                             generator_state=gen,
                             next_item_id=int(meta["next_item_id"]),
                             wal=records, spill_path=spill_path)
    raise PersistError(
        f"no valid spill in {path!r}; rebuild from the master copy"
    ) from last_err


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def replay_record(engine, rec: WalRecord) -> None:
    """Apply one WAL record through the engine's own mutation API (module
    doc); an insert-id divergence raises `PersistError`."""
    a = rec.arrays
    if rec.op == "insert_items":
        got = engine.insert_items(a["vectors"])
        want = np.asarray(_host(a["ids"]), np.int64)
        if not np.array_equal(np.asarray(got, np.int64), want):
            raise PersistError(
                f"WAL replay diverged at record #{rec.seq}: insert_items "
                f"assigned ids {np.asarray(got).tolist()} but the log "
                f"recorded {want.tolist()}")
    elif rec.op == "delete_items":
        engine.delete_items([int(i) for i in _host(a["ids"])])
    elif rec.op == "upsert_users":
        engine.upsert_users(
            a["vectors"],
            indices=([int(i) for i in _host(a["indices"])]
                     if "indices" in a else None))
    elif rec.op == "delete_users":
        engine.delete_users([int(i) for i in _host(a["indices"])])
    else:       # _read_wal already rejects unknown ops; belt and braces
        raise PersistError(f"unknown WAL op {rec.op!r}")
