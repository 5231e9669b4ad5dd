"""Crash-safe streaming ingestion: a WAL-backed live index.

The port of ``repro/index/ingest.py``. :class:`LiveIndex` makes the
inverted index mutable without giving up the immutable compressed
segments everything else is built on. Three layers:

* **Main segment** — an ordinary
  :class:`~repro_torch.index.builder.InvertedIndex` (DP-partitioned
  ``format="auto"`` by default, checksummed), persisted under
  ``segments/seg_<epoch>/`` with a whole-file CRC, and resident on the
  index's device (the card unless the caller asks for the CPU). Every
  query decodes its terms' main-segment blocks there (for the ``auto``
  index mostly kernel 4), and every merge decodes each main list whole.
  Immutable.
* **Delta** — an uncompressed ``doc -> {term: tf}`` map of documents added
  since the last merge, plus a **tombstone set** of main-segment docids
  deleted since. Queries merge main − tombstones ∪ delta at run time.
* **WAL** — every add/delete is appended (and fsynced) to a checksummed
  write-ahead log *before* it is applied in memory or acknowledged
  (:mod:`repro_torch.index.wal`), so a crash at any instant replays to
  exactly the acknowledged state.

**Merge** drains the delta through ``build_index(format="auto")`` into a
fresh segment and commits it with the atomic tmp+fsync+rename protocol
(:mod:`repro_torch.robustness.atomic_io`); the manifest replace is the single
commit point. The sequence is instrumented with named **crash points**
(:data:`CRASH_POINTS`) — the recovery fuzz suite injects a crash at every
one and proves the reopened index answers queries bit-identically to a
rebuilt-from-scratch index. Writes stay live during a merge: the delta is
rotated (frozen) together with the WAL, new ops land in the new WAL +
active delta, and the commit swaps epochs without ever blocking queries —
in-flight readers keep a refcounted :class:`Snapshot` of the old epoch.

Scoring note: query-time BM25 impacts are recomputed from the *merged*
document frequency via :func:`~repro_torch.index.builder.impact_value` and the
raw per-posting tfs persisted next to each segment — never read from the
segment's encoded impact stream, whose quantization was fixed at the df
the term had at merge time. That is what makes a LiveIndex top-k
bit-identical to ``query.topk`` on an index rebuilt from the current
logical state, which is the oracle the fuzz suite checks against.

On-disk layout (``MANIFEST.json``, ``wal_<id>.log``,
``segments/seg_<epoch>/{postings.npz, segment.json}``, the npz keys
``t<term>_arr_<leaf>``, ``_imp_``, ``_cs``, ``_first``, ``_last``,
``_maxi``, ``_tf`` and ``all_docs``) is the reference's: a directory
written by either package opens in the other with the same leaves and
answers. The files are not byte-identical (``np.savez`` stamps zip entry
times), which is why each segment carries its own CRC.

The compressed streams launch their kernels on the caller's current CUDA
stream, and every query's decode comes back to the host before it is
used, so a merge thread and a query thread each see their own work in
order.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from dataclasses import dataclass

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.core.compressed_array import CompressedIntArray, FORMAT_LEAVES
from repro_torch.obs import (counter_inc as _obs_counter_inc,
                             histogram_observe as _obs_histogram_observe,
                             installed as _obs_installed)
from repro_torch.robustness.atomic_io import (
    TMP_PREFIX, atomic_write_json, clean_tmp, crc32_file, fsync_dir,
    fsync_file)
from repro_torch.robustness.validate import SegmentError, WalError

from .builder import (InvertedIndex, TermPostings, build_index,
                      impact_value, quantize_impacts)
from .query import QueryStats, _decode_blocks
from .wal import open_wal, parse_wal_name, read_wal, wal_path

MANIFEST_NAME = "MANIFEST.json"
SEGMENTS_DIR = "segments"

# Named crash points of the merge/commit sequence, in order. The fuzz
# suite injects a crash at every one (tests/test_torch_ingest.py).
CRASH_POINTS = (
    "before_rotate",         # nothing rotated yet
    "after_rotate",          # new WAL exists, delta frozen
    "after_build",           # merged index built in memory only
    "segment_tmp_written",   # segment bytes durable under a tmp name
    "after_segment_rename",  # segment final-named; manifest still old
    "manifest_tmp_written",  # new manifest durable under a tmp name
    "after_manifest",        # COMMIT POINT passed; cleanup not run
    "after_cleanup",         # old WALs/segments removed
)


class CrashPoint(RuntimeError):
    """Injected crash (tests/benchmarks only). The raising ``LiveIndex``
    must be discarded — like a real crash, recovery happens by reopening
    the directory."""

    def __init__(self, name: str):
        self.name = name
        super().__init__(f"injected crash at {name!r}")


def _seg_name(epoch: int) -> str:
    return f"seg_{epoch:08d}"


def _parse_seg_name(name: str) -> int | None:
    if not name.startswith("seg_"):
        return None
    mid = name[4:]
    return int(mid) if mid.isdigit() else None


# ---------------------------------------------------------------------------
# segment persistence
# ---------------------------------------------------------------------------
def _segment_arrays(index: InvertedIndex, tfs: dict) -> dict:
    """Flatten an index (+ raw per-posting tfs) into npz-ready arrays: the
    leaves as the reference stores them (bytes uint8, counts int32, bases
    uint32)."""
    arrays: dict[str, np.ndarray] = {}
    for t, tp in index.terms.items():
        pre = f"t{t}"
        for leaf, a in tp.arr.leaves_numpy().items():
            arrays[f"{pre}_arr_{leaf}"] = a
        if tp.arr.checksums is not None:
            arrays[f"{pre}_arr_cs"] = np.asarray(tp.arr.checksums)
        for leaf, a in tp.impacts.leaves_numpy().items():
            arrays[f"{pre}_imp_{leaf}"] = a
        if tp.impacts.checksums is not None:
            arrays[f"{pre}_imp_cs"] = np.asarray(tp.impacts.checksums)
        arrays[f"{pre}_first"] = tp.first_doc
        arrays[f"{pre}_last"] = tp.last_doc
        arrays[f"{pre}_maxi"] = tp.max_impact
        # raw tfs, NOT the quantized impacts: the live index re-quantizes
        # at query time against the merged df (module docstring)
        arrays[f"{pre}_tf"] = np.asarray(tfs[t], dtype=np.uint32)
    return arrays


def _write_segment_files(seg_dir: str, index: InvertedIndex, tfs: dict,
                         main_docs: np.ndarray, *, epoch: int,
                         merged_wal: int, fsync: bool) -> None:
    """Write ``postings.npz`` + ``segment.json`` into ``seg_dir`` (already
    created, typically a tmp dir awaiting rename)."""
    arrays = _segment_arrays(index, tfs)
    arrays["all_docs"] = np.asarray(main_docs, dtype=np.uint32)
    npz = os.path.join(seg_dir, "postings.npz")
    np.savez(npz, **arrays)
    meta = {
        "version": 1,
        "epoch": int(epoch),
        "merged_wal": int(merged_wal),
        "npz_crc32": crc32_file(npz),
        "n_docs": int(index.n_docs),
        "block_size": int(index.block_size),
        "impact_bits": int(index.impact_bits),
        "format": index.format,
        "has_tf": bool(index.has_tf),
        "n_postings": int(index.n_postings),
        "terms": {str(t): {"format": tp.arr.format,
                           "imp_format": tp.impacts.format,
                           "n": int(tp.arr.n), "df": int(tp.df)}
                  for t, tp in index.terms.items()},
    }
    with open(os.path.join(seg_dir, "segment.json"), "w") as f:
        json.dump(meta, f, indent=1)
    if fsync:
        fsync_file(npz)
        fsync_file(os.path.join(seg_dir, "segment.json"))
        fsync_dir(seg_dir)


def write_epoch(directory: str, index: InvertedIndex, tfs: dict,
                all_docs: np.ndarray, *, epoch: int, merged_wal: int = 0,
                manifest: dict | None = None, fsync: bool = True,
                point=None, on_commit=None) -> dict:
    """Commit ``index`` (its raw ``tfs`` and ``all_docs``) as epoch
    ``epoch`` of the live index in ``directory`` — ``LiveIndex.merge``'s
    commit, and how a live index starts from an index built elsewhere.

    The segment's files land under a tmp name and are renamed to their
    final name; then the manifest (``manifest`` — default a fresh one from
    the index's geometry — naming this segment and ``merged_wal``) is
    written under a tmp name and replaced atomically: the commit point.
    ``point(name)`` runs at ``segment_tmp_written``,
    ``after_segment_rename`` and ``manifest_tmp_written``, and
    ``on_commit()`` right after the replace. Returns the new manifest."""
    point = point or (lambda name: None)
    seg_nm = _seg_name(epoch)
    seg_parent = os.path.join(directory, SEGMENTS_DIR)
    os.makedirs(seg_parent, exist_ok=True)
    tmp = os.path.join(seg_parent, f"{TMP_PREFIX}{seg_nm}_{os.getpid()}")
    os.makedirs(tmp)
    _write_segment_files(tmp, index, tfs, all_docs, epoch=epoch,
                         merged_wal=merged_wal, fsync=fsync)
    point("segment_tmp_written")
    os.rename(tmp, os.path.join(seg_parent, seg_nm))
    if fsync:
        fsync_dir(seg_parent)
    point("after_segment_rename")

    if manifest is None:
        manifest = {"version": 1, "epoch": 0, "segments": [],
                    "merged_wal": 0, "n_docs": int(index.n_docs),
                    "block_size": int(index.block_size),
                    "format": index.format,
                    "impact_bits": int(index.impact_bits),
                    "checksum": any(tp.arr.checksums is not None
                                    for tp in index.terms.values())}
    man = dict(manifest)
    man.update(epoch=int(epoch), segments=[seg_nm],
               merged_wal=int(merged_wal))
    mtmp = os.path.join(directory,
                        f"{TMP_PREFIX}{MANIFEST_NAME}_{os.getpid()}")
    with open(mtmp, "w") as f:
        json.dump(man, f, indent=1)
        f.flush()
        if fsync:
            os.fsync(f.fileno())
    point("manifest_tmp_written")
    os.replace(mtmp, os.path.join(directory, MANIFEST_NAME))  # THE commit
    if on_commit is not None:
        on_commit()
    if fsync:
        fsync_dir(directory)
    return man


def read_segment_meta(seg_dir: str) -> dict:
    """Parse + CRC-verify a segment dir's metadata (raises SegmentError)."""
    try:
        with open(os.path.join(seg_dir, "segment.json")) as f:
            meta = json.load(f)
    except (OSError, ValueError) as e:
        raise SegmentError(
            f"segment {seg_dir!r}: metadata unreadable ({e})") from e
    npz = os.path.join(seg_dir, "postings.npz")
    try:
        crc = crc32_file(npz)
    except OSError as e:
        raise SegmentError(
            f"segment {seg_dir!r}: postings.npz missing ({e})") from e
    if crc != meta.get("npz_crc32"):
        raise SegmentError(
            f"segment {seg_dir!r}: postings.npz CRC "
            f"{crc:#010x} != manifest {meta.get('npz_crc32'):#010x} — "
            "truncated or corrupt")
    return meta


def load_segment(seg_dir: str, *, device=None, seconds: dict | None = None):
    """Load a segment: ``(InvertedIndex, tfs {term: int64[]}, all_docs)``,
    the compressed streams placed on ``device`` (default: the card).

    Every failure mode — unreadable/garbage json, missing/truncated/
    bit-flipped npz (whole-file CRC), missing term keys — raises a typed
    :class:`SegmentError`; a segment never loads partially. ``seconds``, a
    dict, receives the host seconds of the CRC check (``crc``), of reading
    the arrays (``load``) and of placing them on the device (``upload``).
    """
    dev = resolve_device(device)
    t0 = time.perf_counter()
    meta = read_segment_meta(seg_dir)
    t1 = time.perf_counter()
    try:
        with np.load(os.path.join(seg_dir, "postings.npz")) as data:
            host = {k: data[k] for k in data.files}
    except Exception as e:  # zipfile.BadZipFile / OSError / ValueError
        raise SegmentError(
            f"segment {seg_dir!r}: postings.npz unreadable ({e})") from e
    t2 = time.perf_counter()
    index = InvertedIndex(terms={}, n_docs=int(meta["n_docs"]),
                          block_size=int(meta["block_size"]),
                          format=meta["format"],
                          impact_bits=int(meta["impact_bits"]),
                          has_tf=bool(meta["has_tf"]))
    tfs: dict[int, np.ndarray] = {}

    def stream(pre: str, fmt: str, *, differential: bool, n: int):
        return CompressedIntArray.from_operands(
            {leaf: host[f"{pre}_{leaf}"] for leaf in FORMAT_LEAVES[fmt]},
            format=fmt, block_size=index.block_size,
            differential=differential, n=n,
            checksums=host.get(f"{pre}_cs"), device=dev)

    try:
        for ts, tm in meta["terms"].items():
            t = int(ts)
            pre = f"t{t}"
            n = int(tm["n"])
            arr = stream(f"{pre}_arr", tm["format"], differential=True, n=n)
            imp = stream(f"{pre}_imp", tm["imp_format"], differential=False,
                         n=n)
            index.terms[t] = TermPostings(
                term=t, arr=arr, first_doc=host[f"{pre}_first"],
                last_doc=host[f"{pre}_last"], df=int(tm["df"]),
                impacts=imp, max_impact=host[f"{pre}_maxi"])
            tfs[t] = host[f"{pre}_tf"].astype(np.int64)
        all_docs = host["all_docs"].astype(np.int64)
    except KeyError as e:
        raise SegmentError(
            f"segment {seg_dir!r}: npz missing array {e} — metadata and "
            "payload disagree") from e
    if seconds is not None:
        seconds.update(crc=t1 - t0, load=t2 - t1,
                       upload=time.perf_counter() - t2)
    return index, tfs, all_docs


# ---------------------------------------------------------------------------
# snapshot (consistent read view)
# ---------------------------------------------------------------------------
@dataclass
class Snapshot:
    """A consistent read view of one epoch, refcounted by the owner.

    Cheap to take: dicts are pointer-copied (add/delete never mutate an
    inner per-doc term map in place — they replace whole entries), and
    the main index/tfs are immutable. Release via ``LiveIndex.release``
    (or use ``search(...)`` which scopes one internally) so the owner's
    epoch accounting sees readers drain after a swap.
    """

    epoch: int
    state: str
    main: InvertedIndex
    main_tfs: dict
    tombstones: np.ndarray  # sorted int64, against main
    delta_docs: dict  # active delta: doc -> {term: tf}
    frozen_docs: dict  # frozen delta (mid-merge), doc -> {term: tf}
    frozen_tomb: frozenset  # tombstones against frozen docs (mid-merge)

    def delta_term(self, term: int):
        """Sorted ``(docs int64, tfs int64)`` of the delta layers' postings
        for ``term`` (frozen − frozen tombstones, plus active)."""
        rows = [(d, tmap[term]) for d, tmap in self.frozen_docs.items()
                if term in tmap and d not in self.frozen_tomb]
        rows += [(d, tmap[term]) for d, tmap in self.delta_docs.items()
                 if term in tmap]
        rows.sort()
        if not rows:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        a = np.asarray(rows, dtype=np.int64)
        return a[:, 0], a[:, 1]

    def delta_doc_ids(self) -> np.ndarray:
        """Sorted docids served from the delta layers (delta-hit set)."""
        ids = set(self.delta_docs)
        ids.update(d for d in self.frozen_docs if d not in self.frozen_tomb)
        return np.fromiter(sorted(ids), dtype=np.int64, count=len(ids))


# ---------------------------------------------------------------------------
# the live index
# ---------------------------------------------------------------------------
class LiveIndex:
    """Mutable inverted index over ``directory`` (see module docstring).

    Opening the directory *is* recovery: clean orphan tmps, reconcile the
    manifest with whatever segments/WALs a crash left behind (adopting a
    committed-but-uncleaned segment — roll-forward — when its WALs are
    already gone), load + CRC-verify the main segment and place it on
    ``device`` (default: the card), then replay the unmerged WAL suffix
    into the delta (``state == "replaying"`` until done). Every add/delete
    is WAL-appended and fsynced before it is acknowledged.
    ``recovery_seconds`` holds the host seconds of the reopen's steps
    (``crc``, ``load``, ``upload``, ``replay``).
    """

    def __init__(self, directory: str, *, n_docs: int | None = None,
                 block_size: int | None = None, format: str | None = None,
                 impact_bits: int | None = None, checksum: bool | None = None,
                 fsync: bool = True, plan="auto", replay_hook=None,
                 device=None):
        self.dir = os.path.abspath(directory)
        self.device = resolve_device(device)
        self.plan = plan
        self.fsync = fsync
        self.recovery_seconds = {"crc": 0.0, "load": 0.0, "upload": 0.0,
                                 "replay": 0.0}
        self.state = "replaying"
        self._lock = threading.Lock()
        # Writer lock, ordered strictly before self._lock. Held across one
        # mutation's exists-check + WAL append + in-memory apply, and by
        # merge()'s rotate and commit sections — so an op's WAL record and
        # its delta placement always land on the same side of a rotation,
        # and two adds of the same doc serialize (second one rejected).
        self._wlock = threading.Lock()
        self._refs: dict[int, int] = {}
        self._delta: dict[int, dict[int, int]] = {}
        self._tombstones: set[int] = set()  # against the main segment
        self._frozen: dict[int, dict[int, int]] | None = None
        self._frozen_tomb: set[int] = set()  # against frozen docs, mid-merge
        self.counters = {"acked_ops": 0, "replayed_ops": 0, "merges": 0,
                         "rolled_forward": 0, "wal_bytes_truncated": 0}
        os.makedirs(os.path.join(self.dir, SEGMENTS_DIR), exist_ok=True)
        self._recover(n_docs=n_docs, block_size=block_size, format=format,
                      impact_bits=impact_bits, checksum=checksum,
                      replay_hook=replay_hook)
        with self._lock:
            self.state = "serving"

    # -- recovery ----------------------------------------------------------
    def _manifest_path(self) -> str:
        return os.path.join(self.dir, MANIFEST_NAME)

    def _seg_dir(self, name: str) -> str:
        return os.path.join(self.dir, SEGMENTS_DIR, name)

    def _write_manifest(self, man: dict) -> None:
        atomic_write_json(self._manifest_path(), man, fsync=self.fsync)

    def _recover(self, *, n_docs, block_size, format, impact_bits,
                 checksum, replay_hook):
        seg_parent = os.path.join(self.dir, SEGMENTS_DIR)
        clean_tmp(self.dir)
        clean_tmp(seg_parent)

        man = None
        if os.path.exists(self._manifest_path()):
            try:
                with open(self._manifest_path()) as f:
                    man = json.load(f)
            except (OSError, ValueError) as e:
                # the manifest is the commit point: if it is garbage we
                # cannot know which epoch was acknowledged — detect.
                raise SegmentError(f"manifest unreadable ({e})") from e

        present = {e: nm for nm in os.listdir(seg_parent)
                   if (e := _parse_seg_name(nm)) is not None}
        wal_ids = sorted(i for nm in os.listdir(self.dir)
                         if (i := parse_wal_name(nm)) is not None)
        man_epoch = int(man["epoch"]) if man else 0
        man_merged = int(man["merged_wal"]) if man else 0

        orphans = sorted(e for e in present if e > man_epoch)
        if orphans:
            # a segment newer than the manifest: either an uncommitted
            # merge (crash before the manifest replace — its WALs replay
            # it, discard) or a committed merge whose manifest write we
            # can no longer see (stale/rolled-back manifest) with the
            # drained WALs already cleaned — adopt it (roll forward).
            e = max(orphans)
            try:
                ometa = read_segment_meta(self._seg_dir(present[e]))
            except SegmentError:
                ometa = None
            covered = int(ometa["merged_wal"]) if ometa else None
            needed = (set(range(man_merged + 1, covered + 1))
                      if covered is not None else set())
            wals_ok = covered is not None and needed <= set(wal_ids)
            # even with the orphan's own metadata unreadable, a WAL chain
            # that is contiguous from the manifest's watermark reproduces
            # every acknowledged op — a committed merge never changes the
            # logical state, so replaying past it is harmless
            full_history = bool(wal_ids) and wal_ids[0] == man_merged + 1 \
                and wal_ids == list(range(wal_ids[0], wal_ids[-1] + 1))
            if wals_ok or (ometa is None and full_history):
                # WAL history fully reproduces the orphan: plain replay
                for eo in orphans:
                    shutil.rmtree(self._seg_dir(present.pop(eo)))
            elif ometa is not None:
                man = {"version": 1, "epoch": e, "segments": [present[e]],
                       "merged_wal": covered, "n_docs": ometa["n_docs"],
                       "block_size": ometa["block_size"],
                       "format": ometa["format"],
                       "impact_bits": ometa["impact_bits"],
                       "checksum": (man["checksum"] if man
                                    else checksum is None or bool(checksum))}
                self._write_manifest(man)
                self.counters["rolled_forward"] = 1
                man_epoch, man_merged = e, covered
                for eo in orphans[:-1]:
                    shutil.rmtree(self._seg_dir(present.pop(eo)))
            else:
                raise SegmentError(
                    f"segment epoch {e} is newer than the manifest "
                    f"(epoch {man_epoch}) but corrupt, and the WALs that "
                    "produced it are gone — history unrecoverable")

        if man is None:
            if n_docs is None:
                raise ValueError(
                    "creating a new LiveIndex requires n_docs (the fixed "
                    "docid universe — impacts depend on it)")
            man = {"version": 1, "epoch": 0, "segments": [],
                   "merged_wal": 0, "n_docs": int(n_docs),
                   "block_size": 128 if block_size is None else int(block_size),
                   "format": "auto" if format is None else format,
                   "impact_bits": (8 if impact_bits is None
                                   else int(impact_bits)),
                   "checksum": checksum is None or bool(checksum)}
            self._write_manifest(man)
        else:
            # a recovered manifest is authoritative for the index geometry;
            # an explicit constructor argument that disagrees is a caller
            # bug (a different n_docs is a different docid universe) —
            # never silently reopen with parameters other than requested
            given = {"n_docs": n_docs, "block_size": block_size,
                     "format": format, "impact_bits": impact_bits,
                     "checksum": checksum}
            norm = {"checksum": bool, "format": str}
            clash = {k: (v, man[k]) for k, v in given.items()
                     if v is not None
                     and norm.get(k, int)(v) != norm.get(k, int)(man[k])}
            if clash:
                raise ValueError(
                    "constructor arguments conflict with the recovered "
                    "manifest: " + ", ".join(
                        f"{k}={v!r} != manifest {m!r}"
                        for k, (v, m) in sorted(clash.items())))

        self.manifest = man
        self.epoch = int(man["epoch"])
        self.n_docs = int(man["n_docs"])
        self.block_size = int(man["block_size"])
        self.format = man["format"]
        self.impact_bits = int(man["impact_bits"])
        self.checksum = bool(man["checksum"])
        merged_wal = int(man["merged_wal"])

        for nm in man["segments"]:
            if _parse_seg_name(nm) not in present:
                raise SegmentError(
                    f"manifest names segment {nm!r} which does not exist")
        listed = {_parse_seg_name(nm) for nm in man["segments"]}
        for e, nm in list(present.items()):
            if e not in listed:  # cleanup crashed mid-way: finish it
                shutil.rmtree(self._seg_dir(nm))

        if man["segments"]:
            self.main, self.main_tfs, self._main_docs = load_segment(
                self._seg_dir(man["segments"][0]), device=self.device,
                seconds=self.recovery_seconds)
            if self.main.n_docs != self.n_docs:
                raise SegmentError(
                    f"segment n_docs {self.main.n_docs} != manifest "
                    f"{self.n_docs}")
        else:
            self.main = build_index({}, format=self.format,
                                    block_size=self.block_size,
                                    n_docs=self.n_docs,
                                    impact_bits=self.impact_bits,
                                    device=self.device)
            self.main_tfs = {}
            self._main_docs = np.zeros(0, np.int64)

        # stale WALs (≤ merged watermark) are already baked into the
        # segment — a crash during post-commit cleanup leaves them behind
        for i in [i for i in wal_ids if i <= merged_wal]:
            os.remove(wal_path(self.dir, i))
        wal_ids = [i for i in wal_ids if i > merged_wal]
        if wal_ids and wal_ids != list(range(wal_ids[0], wal_ids[-1] + 1)):
            raise WalError(f"WAL sequence has gaps: {wal_ids}", format="wal")
        if wal_ids and wal_ids[0] != merged_wal + 1:
            raise WalError(
                f"oldest unmerged WAL is {wal_ids[0]}, expected "
                f"{merged_wal + 1} — history lost", format="wal")

        replayed: list[dict] = []
        for i in wal_ids[:-1] if wal_ids else []:
            p = wal_path(self.dir, i)
            ops, valid = read_wal(p)
            if valid != os.path.getsize(p):
                # only the *newest* WAL can have a torn tail: this one was
                # rotated away, meaning every record in it was acked
                raise WalError(
                    f"rotated WAL {i} has a torn tail — acknowledged "
                    "records lost", format="wal")
            replayed.extend(ops)
        active_id = wal_ids[-1] if wal_ids else merged_wal + 1
        before = (os.path.getsize(wal_path(self.dir, active_id))
                  if os.path.exists(wal_path(self.dir, active_id)) else 0)
        tail_ops, self.wal = open_wal(wal_path(self.dir, active_id),
                                      fsync=self.fsync)
        self.counters["wal_bytes_truncated"] = before - self.wal.tell()
        replayed.extend(tail_ops)
        self.wal_id = active_id

        t0 = time.perf_counter()
        for i, op in enumerate(replayed):
            self._apply(op, replay=True)
            if replay_hook is not None:
                # hook gets the half-open index: queries already work
                # (state == "replaying" marks them degraded)
                replay_hook(self, i, op)
        self.recovery_seconds["replay"] = time.perf_counter() - t0
        self.counters["replayed_ops"] = len(replayed)
        tele = _obs_installed()
        if tele is not None:
            # one structured crash-recovery record per reopen: what the WAL
            # replay found is capacity/incident data, not a counter
            tele.registry.record_event(
                "ingest_recovery", epoch=self.epoch,
                replayed_ops=len(replayed),
                rolled_forward=self.counters["rolled_forward"],
                wal_bytes_truncated=self.counters["wal_bytes_truncated"])
            reg = tele.registry
            reg.counter("ingest_replayed_ops_total").inc(len(replayed))
            if self.counters["rolled_forward"]:
                reg.counter("ingest_rolled_forward_total").inc()

    # -- membership --------------------------------------------------------
    def _in_main(self, doc: int) -> bool:
        i = int(np.searchsorted(self._main_docs, doc))
        return i < self._main_docs.size and int(self._main_docs[i]) == doc

    def _exists(self, doc: int) -> bool:
        if doc in self._delta:
            return True
        if self._frozen is not None and doc in self._frozen \
                and doc not in self._frozen_tomb:
            return True
        return doc not in self._tombstones and self._in_main(doc)

    def __contains__(self, doc: int) -> bool:
        return self._exists(int(doc))

    @property
    def n_delta_docs(self) -> int:
        return len(self._delta) + (len(self._frozen) if self._frozen else 0)

    @property
    def n_pending(self) -> int:
        """Ops not yet drained into a segment (delta docs + tombstones)."""
        return self.n_delta_docs + len(self._tombstones) \
            + len(self._frozen_tomb)

    def doc_count(self) -> int:
        n = int(self._main_docs.size) - len(self._tombstones) + \
            len(self._delta)
        if self._frozen is not None:
            n += len(self._frozen) - len(self._frozen_tomb)
        return n

    # -- mutation (WAL-append before ack) ----------------------------------
    def add(self, doc: int, terms) -> None:
        """Add document ``doc`` with ``{term: tf}`` postings. Durable (WAL
        appended + fsynced) before this returns. The doc must not
        currently exist — delete first to replace."""
        doc = int(doc)
        if not (0 <= doc < self.n_docs):
            raise ValueError(f"doc {doc} outside universe [0, {self.n_docs})")
        tmap = {int(t): int(tf) for t, tf in dict(terms).items()}
        if not tmap:
            raise ValueError("a document needs ≥1 term")
        for t, tf in tmap.items():
            if t < 0 or tf < 1:
                raise ValueError(f"bad posting term={t} tf={tf}")
        op = {"op": "add", "doc": doc,
              "terms": {str(t): tf for t, tf in sorted(tmap.items())}}
        # one critical section per mutation: the exists-check, the WAL
        # append and the delta placement must all see the same WAL/delta
        # generation, or a concurrent rotation could strand the op's only
        # durable record in a WAL the merge is about to retire
        with self._wlock:
            if self._exists(doc):
                raise ValueError(
                    f"doc {doc} already exists — delete it first")
            self.wal.append(op)  # durability point: ack only after this
            self._apply(op, replay=False)
            self.counters["acked_ops"] += 1

    def delete(self, doc: int) -> None:
        """Delete document ``doc``. Durable before this returns."""
        doc = int(doc)
        op = {"op": "del", "doc": doc}
        with self._wlock:
            if not self._exists(doc):
                raise KeyError(f"doc {doc} does not exist")
            self.wal.append(op)
            self._apply(op, replay=False)
            self.counters["acked_ops"] += 1

    def _apply(self, op: dict, *, replay: bool) -> None:
        """Apply one (already durable) op to the in-memory delta state.
        Replay uses the same code path as live application — that is the
        identity the crash oracle depends on. A replayed op that
        contradicts the index means the log and segments diverged:
        typed ``WalError``, never a silent wrong answer."""
        doc = int(op["doc"])
        if op["op"] == "add":
            tmap = {int(t): int(tf) for t, tf in op["terms"].items()}
            if replay and (self._exists(doc) or not tmap):
                raise WalError(
                    f"replayed add of existing doc {doc} — WAL/segment "
                    "divergence", format="wal")
            with self._lock:
                self._delta[doc] = tmap
        else:
            with self._lock:
                if doc in self._delta:
                    del self._delta[doc]
                elif self._frozen is not None and doc in self._frozen \
                        and doc not in self._frozen_tomb:
                    self._frozen_tomb.add(doc)
                elif doc not in self._tombstones and self._in_main(doc):
                    self._tombstones.add(doc)
                else:
                    raise WalError(
                        f"replayed delete of absent doc {doc} — "
                        "WAL/segment divergence", format="wal")

    # -- snapshots ---------------------------------------------------------
    def snapshot(self) -> Snapshot:
        """Refcounted consistent read view (release when done)."""
        with self._lock:
            tomb = np.fromiter(sorted(self._tombstones), dtype=np.int64,
                               count=len(self._tombstones))
            snap = Snapshot(
                epoch=self.epoch, state=self.state, main=self.main,
                main_tfs=self.main_tfs, tombstones=tomb,
                delta_docs=dict(self._delta),
                frozen_docs=dict(self._frozen) if self._frozen else {},
                frozen_tomb=frozenset(self._frozen_tomb))
            self._refs[snap.epoch] = self._refs.get(snap.epoch, 0) + 1
        return snap

    def release(self, snap: Snapshot) -> None:
        with self._lock:
            self._refs[snap.epoch] -= 1
            if self._refs[snap.epoch] == 0:
                del self._refs[snap.epoch]

    def readers(self) -> dict[int, int]:
        """Epoch → live reader count (old epochs drain after a swap)."""
        with self._lock:
            return dict(self._refs)

    # -- queries -----------------------------------------------------------
    def _term_merged(self, snap: Snapshot, term: int, stats):
        """One term's logical postings under ``snap``: sorted
        ``(docs int64, tfs int64, delta_docs int64)`` merging the decoded
        main blocks (− tombstones) with the delta layers."""
        tp = snap.main.terms.get(term)
        if tp is not None and tp.df:
            docs_m = _decode_blocks(tp, 0, tp.n_blocks, plan=self.plan,
                                    stats=stats,
                                    use_skip=True).astype(np.int64)
            tfs_m = snap.main_tfs[term]
            if snap.tombstones.size:
                pos = np.searchsorted(snap.tombstones, docs_m)
                pos = np.minimum(pos, snap.tombstones.size - 1)
                dead = snap.tombstones[pos] == docs_m
                if stats is not None:
                    stats.tombstones_applied += int(dead.sum())
                docs_m, tfs_m = docs_m[~dead], tfs_m[~dead]
        else:
            docs_m = np.zeros(0, np.int64)
            tfs_m = np.zeros(0, np.int64)
        d_docs, d_tfs = snap.delta_term(term)
        if stats is not None:
            stats.delta_postings += int(d_docs.size)
        if d_docs.size:
            docs = np.concatenate([docs_m, d_docs])
            tfs = np.concatenate([tfs_m, d_tfs])
            order = np.argsort(docs, kind="stable")
            docs, tfs = docs[order], tfs[order]
        else:
            docs, tfs = docs_m, tfs_m
        return docs, tfs, d_docs

    def search(self, terms, *, mode: str = "or", k: int = 10,
               stats: QueryStats | None = None, snap: Snapshot | None = None):
        """Query the live logical state: ``mode`` "and"/"or" return sorted
        uint32 docids; "topk" returns ``(docids uint32 [≤k], scores int32
        [≤k])`` — each bit-identical to ``index.query`` on an index
        rebuilt from scratch from the same logical state (the fuzz
        oracle's definition of correct)."""
        own = snap is None
        if own:
            snap = self.snapshot()
        try:
            if stats is not None and snap.state == "replaying":
                stats.mark_degraded("replaying")
            terms = list(dict.fromkeys(terms))
            if not terms:
                raise ValueError("query needs ≥1 term")
            merged = [self._term_merged(snap, t, stats) for t in terms]
            if mode == "and":
                live = [docs for docs, _, _ in merged]
                if any(d.size == 0 for d in live):
                    out = np.zeros(0, np.int64)
                else:
                    out = live[0]
                    for d in live[1:]:
                        out = np.intersect1d(out, d, assume_unique=True)
                self._count_delta_hits(snap, out, merged, stats)
                return out.astype(np.uint32)
            if mode == "or":
                parts = [docs for docs, _, _ in merged if docs.size]
                out = (np.unique(np.concatenate(parts)) if parts
                       else np.zeros(0, np.int64))
                self._count_delta_hits(snap, out, merged, stats)
                return out.astype(np.uint32)
            if mode == "topk":
                parts = [docs for docs, _, _ in merged if docs.size]
                cand = (np.unique(np.concatenate(parts)) if parts
                        else np.zeros(0, np.int64))
                scores = np.zeros(cand.size, np.int64)
                for t, (docs, tfs, _d) in zip(terms, merged):
                    if docs.size == 0:
                        continue
                    base = impact_value(self.n_docs, int(docs.size),
                                        self.impact_bits)
                    q = quantize_impacts(base, tfs, self.impact_bits)
                    scores[np.searchsorted(cand, docs)] += q
                order = np.lexsort((cand, -scores))[:int(k)]
                top = cand[order]
                self._count_delta_hits(snap, top, merged, stats)
                return (top.astype(np.uint32),
                        scores[order].astype(np.int32))
            raise ValueError(f"unknown mode {mode!r}; expected "
                             "'and'/'or'/'topk'")
        finally:
            if own:
                self.release(snap)

    @staticmethod
    def _count_delta_hits(snap, result, merged, stats):
        if stats is None or len(result) == 0:
            return
        dd = np.unique(np.concatenate(
            [d for _, _, d in merged if d.size] or [np.zeros(0, np.int64)]))
        if dd.size:
            stats.delta_hits += int(
                np.isin(np.asarray(result, dtype=np.int64), dd).sum())

    # -- materialization (merge drain + test oracle) -----------------------
    def _merged_lists(self, *, frozen: dict, tombstones: set,
                      frozen_tomb: set = frozenset(),
                      extra: dict | None = None):
        """Term-major logical postings: main (− ``tombstones``) merged with
        ``frozen`` (− ``frozen_tomb``) and ``extra``. Returns
        ``(lists {term: int64 docs}, tfs {term: int64})`` with empty terms
        omitted — exactly what ``build_index`` (or the rebuild oracle)
        consumes."""
        extra = extra or {}
        delta_terms: dict[int, list] = {}
        for src, tomb in ((frozen, frozen_tomb), (extra, frozenset())):
            for d, tmap in src.items():
                if d in tomb:
                    continue
                for t, tf in tmap.items():
                    delta_terms.setdefault(t, []).append((d, tf))
        tomb_arr = np.fromiter(sorted(tombstones), dtype=np.int64,
                               count=len(tombstones))
        lists: dict[int, np.ndarray] = {}
        tfs: dict[int, np.ndarray] = {}
        for t in sorted(set(self.main.terms) | set(delta_terms)):
            tp = self.main.terms.get(t)
            if tp is not None and tp.df:
                docs_m = tp.arr.decode(plan=self.plan).astype(np.int64)
                tfs_m = self.main_tfs[t]
                if tomb_arr.size:
                    pos = np.minimum(np.searchsorted(tomb_arr, docs_m),
                                     tomb_arr.size - 1)
                    keep = tomb_arr[pos] != docs_m
                    docs_m, tfs_m = docs_m[keep], tfs_m[keep]
            else:
                docs_m = np.zeros(0, np.int64)
                tfs_m = np.zeros(0, np.int64)
            rows = sorted(delta_terms.get(t, []))
            if rows:
                a = np.asarray(rows, dtype=np.int64)
                docs = np.concatenate([docs_m, a[:, 0]])
                tfv = np.concatenate([tfs_m, a[:, 1]])
                order = np.argsort(docs, kind="stable")
                docs, tfv = docs[order], tfv[order]
            else:
                docs, tfv = docs_m, tfs_m
            if docs.size:
                lists[t] = docs
                tfs[t] = tfv
        return lists, tfs

    def materialize(self):
        """Current *logical* state as ``(lists, tfs)`` — what a rebuilt-
        from-scratch index would be built from (the fuzz oracle)."""
        with self._lock:
            frozen = dict(self._frozen) if self._frozen else {}
            ftomb = set(self._frozen_tomb)
            tomb = set(self._tombstones)
            extra = dict(self._delta)
        return self._merged_lists(frozen=frozen, tombstones=tomb,
                                  frozen_tomb=ftomb, extra=extra)

    # -- merge (the 8-crash-point sequence) --------------------------------
    def merge(self, *, crash_at: str | None = None, step_hook=None) -> dict:
        """Drain the delta into a fresh compressed segment and commit it.

        Writes stay live throughout (they land in the rotated WAL + active
        delta) and queries never block — the manifest replace is the
        single commit point, after which the in-memory epoch swaps.
        ``crash_at`` raises :class:`CrashPoint` at the named point
        (tests); ``step_hook(name)`` runs at every point (mid-merge query
        parity checks). See :data:`CRASH_POINTS`.
        """
        if crash_at is not None and crash_at not in CRASH_POINTS:
            raise ValueError(f"unknown crash point {crash_at!r}")
        with self._lock:
            if self.state == "merge_in_progress":
                raise RuntimeError("merge already in progress")
            self.state = "merge_in_progress"
        t_merge0 = time.perf_counter()

        # merge-phase duration histograms: the crash points already name
        # the phase boundaries, so each point() observes the time since the
        # previous one under the phase that just finished
        _phase = {"t0": time.perf_counter(), "prev": "merge_start"}

        def point(name: str) -> None:
            now = time.perf_counter()
            _obs_histogram_observe("ingest_merge_phase_seconds",
                                   now - _phase["t0"], phase=name)
            _phase["t0"], _phase["prev"] = now, name
            if step_hook is not None:
                step_hook(name)
            if crash_at == name:
                raise CrashPoint(name)

        rotated = committed = False
        try:
            point("before_rotate")
            old_wal_id = self.wal_id
            new_id = old_wal_id + 1
            _, new_writer = open_wal(wal_path(self.dir, new_id),
                                     fsync=self.fsync)
            with self._wlock:  # no writer mid-append while the WAL swaps
                with self._lock:
                    self.wal.close()
                    self.wal, self.wal_id = new_writer, new_id
                    self._frozen = self._delta
                    self._delta = {}
                    rot_tomb = set(self._tombstones)
                    self._frozen_tomb = set()
            rotated = True
            point("after_rotate")

            frozen = self._frozen
            lists, tfs = self._merged_lists(frozen=frozen,
                                            tombstones=rot_tomb)
            new_index = build_index(
                lists, tfs=tfs, format=self.format,
                block_size=self.block_size, n_docs=self.n_docs,
                impact_bits=self.impact_bits, checksum=self.checksum,
                device=self.device)
            all_docs = np.unique(np.concatenate(
                list(lists.values()) or [np.zeros(0, np.int64)]))
            point("after_build")

            def commit():
                nonlocal committed
                committed = True

            new_epoch = self.epoch + 1
            seg_parent = os.path.join(self.dir, SEGMENTS_DIR)
            man = write_epoch(self.dir, new_index, tfs, all_docs,
                              epoch=new_epoch, merged_wal=old_wal_id,
                              manifest=self.manifest, fsync=self.fsync,
                              point=point, on_commit=commit)
            point("after_manifest")

            tfs_np = {t: np.asarray(v, dtype=np.int64)
                      for t, v in tfs.items()}
            with self._wlock:  # writers' _exists must see main+tombstones
                with self._lock:  # swap atomically with the epoch
                    self.main = new_index
                    self.main_tfs = tfs_np
                    self._main_docs = all_docs.astype(np.int64)
                    self.manifest = man
                    self.epoch = new_epoch
                    # tombstones drained into the segment retire; deletes
                    # that raced the merge (incl. of frozen docs, now in
                    # main) stay
                    self._tombstones = (self._tombstones - rot_tomb) \
                        | self._frozen_tomb
                    self._frozen = None
                    self._frozen_tomb = set()

            for nm in os.listdir(self.dir):
                i = parse_wal_name(nm)
                if i is not None and i <= old_wal_id:
                    os.remove(os.path.join(self.dir, nm))
            for nm in os.listdir(seg_parent):
                e = _parse_seg_name(nm)
                if e is not None and e != new_epoch:
                    shutil.rmtree(self._seg_dir(nm))
            point("after_cleanup")
            self.counters["merges"] += 1
            _obs_counter_inc("ingest_merges_total")
            _obs_histogram_observe("ingest_merge_seconds",
                                   time.perf_counter() - t_merge0)
            with self._lock:
                self.state = "serving"
            return {"epoch": new_epoch, "drained_docs": len(frozen),
                    "drained_tombstones": len(rot_tomb),
                    "n_postings": int(new_index.n_postings),
                    "bits_per_int": (round(new_index.bits_per_int, 2)
                                     if new_index.n_postings else 0.0)}
        except CrashPoint:
            # injected crash: the object is dead by contract — recovery
            # reopens the directory. Leave state at merge_in_progress so
            # misuse of the carcass is loud.
            raise
        except BaseException:
            # a real pre-commit failure (build error, disk full, step_hook
            # raise) committed nothing: un-rotate so the in-memory state is
            # exactly what serving + a retried merge expect, and discard
            # the attempt's on-disk leftovers (tmp dirs, an uncommitted
            # final-named segment) so the retry's names are free — the
            # same sweep recovery performs on reopen. Post-commit the
            # epochs may have half-swapped — stay loud like a crash.
            if not committed:
                self._rollback_merge(rotated)
                seg_parent = os.path.join(self.dir, SEGMENTS_DIR)
                clean_tmp(self.dir)
                clean_tmp(seg_parent)
                for nm in os.listdir(seg_parent):
                    e = _parse_seg_name(nm)
                    if e is not None and e > self.epoch:
                        shutil.rmtree(self._seg_dir(nm), ignore_errors=True)
            raise

    def _rollback_merge(self, rotated: bool) -> None:
        """Restore ``serving`` after a merge failed before its commit
        point. Frozen delta docs fold back into the active delta (a
        concurrent add of a frozen doc was rejected, so no collisions) and
        frozen tombstones simply erase their docs — the logical state is
        untouched. The rotated WAL stays active: the op history is split
        across old + new WALs, both above the unchanged ``merged_wal``
        watermark, so recovery and the next rotation handle it as usual."""
        with self._wlock:
            with self._lock:
                if rotated and self._frozen is not None:
                    for d, tmap in self._frozen.items():
                        if d not in self._frozen_tomb:
                            self._delta[d] = tmap
                    self._frozen = None
                    self._frozen_tomb = set()
                self.state = "serving"

    def close(self) -> None:
        self.wal.close()
