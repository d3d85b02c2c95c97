"""Taken from ``masa_tpu/core/sra.py`` (the JAX reference).  Rows in
the packed formats ("MSRP", "MSRQ") decode through the port's
``ops/wavefront.decode_packed_row``, so a work directory checkpointed by
masa_tpu on its device resumes here without JAX.  A lazy row
(``put_lazy``) bound for disk lands there as masa_tpu writes it, in the
device's delta form with its anchors ("MSRQ", ``write_row_packed``), once
its asynchronous copy of the packed bytes is done; an eager ``put``
writes the partition's own codec.  A window of a stored row is read from
its file alone: a "none" row by one seek, an "MSRQ" row from its nearest
anchor (``read_row_window``).

SRA — the special rows area store: simultaneously the linear-space
algorithm's data structure and the crash-safe checkpoint format.

Mirrors the reference design (sra/SpecialRowsArea.cpp, SpecialRowsPartition
.cpp, SpecialRow{File,RAM}.cpp): one directory per (stage, id, deep) area,
one subdirectory per partition named by its hex coordinates, one file per
special row.  RAM vs disk placement is budgeted proportionally; resume
re-seeds from the last complete row; truncation drops rows behind a found
crosspoint.

Row file format (original, not the reference's): little-endian
    magic "MSR2" | u8 codec | int64 row_index | int64 count | payload
where codec indexes io.rowcodec.CODECS (none/8bit/4bit/vlc — the
reference's SRA compression strategy enums, configs/Configs.hpp:35-41,
actually wired here).  Written via tmp+rename so a partial row never
looks complete.  Legacy "MSR1" (uncompressed int32 pairs) still reads.
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np

from masa_tpu_torch.io.rowcodec import CODECS, decode_row, encode_row
from masa_tpu_torch.ops.wavefront import ANCHOR_STRIDE, decode_packed_row
from masa_tpu_torch.utils import trace

MAGIC = b"MSR2"
MAGIC_V1 = b"MSR1"
MAGIC_PACKED = b"MSRP"
MAGIC_ANCHORED = b"MSRQ"

# in-flight lazy rows pin device snapshots; bound the pinned bytes
_PENDING_CAP = 2 << 30

# absolute-value anchors every ANCHOR_STRIDE cells inside MSRQ rows
# (ops/wavefront.ANCHOR_STRIDE, packed with the row on its device): the
# index by which stage 2 decodes a window of a disk row instead of all of it

# "MSR2" | u8 codec | int64 row | int64 count, then the payload; a "none"
# payload is a one-array blob (u8 count, u8 dtype, int64 length) of
# (H, F) int32 pairs, so cell k of the row sits at _NONE_CELLS + 8 k
_HEADER = 4 + 17
_NONE_CELLS = _HEADER + 10


def _row_path(dirpath: str, r: int) -> str:
    return os.path.join(dirpath, f"row.{r:010d}.bin")


def _write_file(dirpath: str, r: int, *parts) -> int:
    """Write row ``r``'s file from its parts, bytes or contiguous arrays,
    in order (tmp + rename, so a partial row never looks complete);
    returns the file's bytes."""
    tmp = _row_path(dirpath, r) + ".tmp"
    with trace.span("rows.write"):
        with open(tmp, "wb") as fh:
            for part in parts:
                fh.write(part)
        os.replace(tmp, _row_path(dirpath, r))
    return sum(memoryview(part).nbytes for part in parts)


def write_row(dirpath: str, r: int, h: np.ndarray, f: np.ndarray,
              codec: str = "none") -> int:
    with trace.span("rows.pack"):
        body = encode_row(codec, h, f)
    return _write_file(dirpath, r, MAGIC + struct.pack(
        "<Bqq", CODECS.index(codec), r, len(h)), body)


def write_row_packed(dirpath: str, r: int, lazy) -> int:
    """Persist a manager.LazyFullRow in the device's 4-bit delta form (two
    nibbles a byte and the escapes at full width) with absolute anchors
    every ANCHOR_STRIDE cells: no encode on the host, about an eighth of
    the int32 pair's bytes, and a window decodes from its nearest anchor
    (read_row_window).  Returns the file's bytes."""
    (uh, mih, mvh), (uf, mif, mvf) = lazy.packed()
    anc_h, anc_f = lazy.anchors(ANCHOR_STRIDE)
    head = MAGIC_ANCHORED + struct.pack(
        "<qqqqqqqqqq", r, lazy.count, lazy.border_h, lazy.border_f, len(uh),
        len(mih), len(uf), len(mif), ANCHOR_STRIDE, len(anc_h))
    return _write_file(dirpath, r, head, *(
        np.ascontiguousarray(x, t) for x, t in (
            (uh, np.uint8), (mih, np.int64), (mvh, np.int64),
            (uf, np.uint8), (mif, np.int64), (mvf, np.int64),
            (anc_h, np.int64), (anc_f, np.int64))))


def _packed_floor(count: int) -> int:
    """The fewest bytes the MSRQ file of a row of ``count`` cells takes:
    its head, nibbles and anchors (its escapes come with the row)."""
    nj = count - 1
    return 4 + 80 + 2 * ((nj + 1) // 2) + 16 * -(-nj // ANCHOR_STRIDE)


def _parse_anchored(raw: bytes):
    """Field views into an MSRQ blob: (count, bh0, bf0, stride,
    (uh, mih, mvh, anc_h), (uf, mif, mvf, anc_f))."""
    (ridx, count, bh0, bf0, nuh, neh, nuf, nef,
     stride, nanc) = struct.unpack_from("<qqqqqqqqqq", raw, 4)
    off = 4 + 80
    uh = np.frombuffer(raw, np.uint8, nuh, offset=off); off += nuh
    mih = np.frombuffer(raw, np.int64, neh, offset=off); off += 8 * neh
    mvh = np.frombuffer(raw, np.int64, neh, offset=off); off += 8 * neh
    uf = np.frombuffer(raw, np.uint8, nuf, offset=off); off += nuf
    mif = np.frombuffer(raw, np.int64, nef, offset=off); off += 8 * nef
    mvf = np.frombuffer(raw, np.int64, nef, offset=off); off += 8 * nef
    anc_h = np.frombuffer(raw, np.int64, nanc, offset=off); off += 8 * nanc
    anc_f = np.frombuffer(raw, np.int64, nanc, offset=off)
    return (count, bh0, bf0, stride,
            (uh, mih, mvh, anc_h), (uf, mif, mvf, anc_f))


def _decode_window(u, mi, mv, anc, stride: int, bus_lo: int, bus_hi: int
                   ) -> np.ndarray:
    """Decode bus positions [bus_lo, bus_hi) of a 4-bit delta stream
    from the nearest preceding anchor — O(window + stride) instead of
    O(n).  Nibble p lives at byte p//2 (low nibble for even p); escapes
    (mi, mv) force absolute values exactly like decode_packed_row."""
    if bus_hi <= bus_lo:
        return np.empty(0, np.int64)
    a = (bus_lo // stride) * stride
    # nibbles for delta positions (a, bus_hi)
    b0, b1 = (a + 1) // 2, (bus_hi + 1) // 2
    seg = np.asarray(u[b0:b1], np.uint8)
    lo_n = (seg & 0xF).astype(np.int64)
    hi_n = (seg >> 4).astype(np.int64)
    lo_n[lo_n > 7] -= 16
    hi_n[hi_n > 7] -= 16
    dh = np.empty(2 * len(seg), np.int64)
    dh[0::2] = lo_n
    dh[1::2] = hi_n
    need = dh[(a + 1) - 2 * b0 : bus_hi - 2 * b0]
    out = np.empty(bus_hi - a, np.int64)
    out[0] = anc[a // stride]
    np.cumsum(need, out=out[1:])
    out[1:] += out[0]
    s_lo = int(np.searchsorted(mi, a + 1))
    s_hi = int(np.searchsorted(mi, bus_hi))
    if s_hi > s_lo:
        mm = (mi[s_lo:s_hi] - a).astype(np.int64)
        corr = np.asarray(mv[s_lo:s_hi], np.int64) - out[mm]
        add = np.zeros(bus_hi - a, np.int64)
        add[mm] = np.diff(np.concatenate([[0], corr]))
        out += np.cumsum(add)
    return out[bus_lo - a :]


def read_row(dirpath: str, r: int) -> tuple[np.ndarray, np.ndarray]:
    with open(_row_path(dirpath, r), "rb") as fh:
        raw = fh.read()
    if raw[:4] == MAGIC_ANCHORED:
        (count, bh0, bf0, _stride, ph, pf) = _parse_anchored(raw)
        nj = count - 1
        h = np.empty(count, np.int64)
        f = np.empty(count, np.int64)
        h[0], f[0] = bh0, bf0
        h[1:] = decode_packed_row(ph[0], ph[1], ph[2], nj)
        f[1:] = decode_packed_row(pf[0], pf[1], pf[2], nj)
        return h, f
    if raw[:4] == MAGIC_PACKED:
        (ridx, count, bh0, bf0, nuh, neh, nuf, nef) = struct.unpack_from(
            "<qqqqqqqq", raw, 4)
        nj = count - 1
        off = 4 + 64
        uh = np.frombuffer(raw, np.uint8, nuh, offset=off); off += nuh
        mih = np.frombuffer(raw, np.int64, neh, offset=off); off += 8 * neh
        mvh = np.frombuffer(raw, np.int64, neh, offset=off); off += 8 * neh
        uf = np.frombuffer(raw, np.uint8, nuf, offset=off); off += nuf
        mif = np.frombuffer(raw, np.int64, nef, offset=off); off += 8 * nef
        mvf = np.frombuffer(raw, np.int64, nef, offset=off)
        h = np.empty(count, np.int64)
        f = np.empty(count, np.int64)
        h[0], f[0] = bh0, bf0
        h[1:] = decode_packed_row(uh, mih, mvh, nj)
        f[1:] = decode_packed_row(uf, mif, mvf, nj)
        return h, f
    if raw[:4] == MAGIC_V1:
        ridx, count = struct.unpack_from("<qq", raw, 4)
        data = np.frombuffer(raw, np.int32, count * 2, offset=20).reshape(
            count, 2
        )
        return data[:, 0].astype(np.int64), data[:, 1].astype(np.int64)
    if raw[:4] != MAGIC:
        raise IOError(f"corrupt special row {r} in {dirpath}")
    codec_id, ridx, count = struct.unpack_from("<Bqq", raw, 4)
    return decode_row(CODECS[codec_id], raw[21:], count)


def read_row_window(dirpath: str, r: int, lo: int, hi: int
                    ) -> tuple[np.ndarray, np.ndarray]:
    """(h[lo:hi], f[lo:hi]) of the stored row in FULL-ROW indexing
    (element 0 = border).  A "none" row reads only those cells from its
    file and MSRQ rows decode only O(hi-lo) cells from their anchor
    index; other formats fall back to the full decode."""
    with open(_row_path(dirpath, r), "rb") as fh:
        head = fh.read(_HEADER)
        if head[:4] == MAGIC and head[4] == CODECS.index("none"):
            count = struct.unpack_from("<q", head, 13)[0]
            hi = min(hi, count)
            if hi <= lo:
                return np.empty(0, np.int64), np.empty(0, np.int64)
            fh.seek(_NONE_CELLS + 8 * lo)
            data = np.frombuffer(fh.read(8 * (hi - lo)), np.int32)
            return (data[0::2].astype(np.int64),
                    data[1::2].astype(np.int64))
        raw = head + fh.read()
    if raw[:4] != MAGIC_ANCHORED:
        h, f = read_row(dirpath, r)
        return h[lo:hi], f[lo:hi]
    (count, bh0, bf0, stride, ph, pf) = _parse_anchored(raw)
    hi = min(hi, count)
    if hi <= lo:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    bus_lo, bus_hi = max(lo - 1, 0), hi - 1
    hw = _decode_window(ph[0], ph[1], ph[2], ph[3], stride, bus_lo, bus_hi)
    fw = _decode_window(pf[0], pf[1], pf[2], pf[3], stride, bus_lo, bus_hi)
    if lo == 0:
        hw = np.concatenate([[bh0], hw])
        fw = np.concatenate([[bf0], fw])
    return hw, fw


class SpecialRowsPartition:
    """Special rows of one partition, with a RAM budget and disk spill.

    Implements the same protocol as stages.core.SpecialRowStore so the
    traceback machinery is storage-agnostic."""

    def __init__(self, dirpath: str, i0: int, j0: int, i1: int, j1: int,
                 ram_limit: int = 1 << 30, disk_limit: int = 1 << 40,
                 codec: str = "none",
                 row_init: int | None = None, col_init: int | None = None):
        self.dir = dirpath
        self.i0, self.j0, self.i1, self.j1 = i0, j0, i1, j1
        self.ram_limit = ram_limit
        self.disk_limit = disk_limit
        self.codec = codec
        # border init types (the reference encodes them in the
        # C%08X.INIT_* / R%08X.INIT_* filenames,
        # sra/SpecialRowsPartition.cpp:129-175) so a resumed traceback
        # can rebuild the partition's init conditions without recompute
        self.row_init = row_init
        self.col_init = col_init
        self._ram: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        self._disk: set[int] = set()
        self._ram_bytes = 0
        self._disk_bytes = 0
        # disk-destined lazy rows whose async device->host transfer is
        # still in flight: [(r, LazyFullRow)], drained opportunistically
        self._pending: list = []
        self._pending_bytes = 0  # their int32 bytes, pinned on the device
        self._pending_floor = 0  # the least their files will take
        os.makedirs(dirpath, exist_ok=True)
        self._load_meta()
        self._save_meta()
        self._scan()

    def _load_meta(self):
        meta = os.path.join(self.dir, "meta.json")
        if self.row_init is None and os.path.exists(meta):
            with open(meta) as f:
                m = json.load(f)
            self.row_init = m.get("row_init")
            self.col_init = m.get("col_init")

    def _save_meta(self):
        tmp = os.path.join(self.dir, "meta.json.tmp")
        with open(tmp, "w") as f:
            json.dump({"i0": self.i0, "j0": self.j0,
                       "i1": self.i1, "j1": self.j1,
                       "row_init": self.row_init,
                       "col_init": self.col_init}, f)
        os.replace(tmp, os.path.join(self.dir, "meta.json"))

    def _scan(self):
        for name in os.listdir(self.dir):
            if name.startswith("row.") and name.endswith(".bin"):
                self._disk.add(int(name[4:-4]))
                self._disk_bytes += os.path.getsize(
                    os.path.join(self.dir, name)
                )

    # --- SpecialRowStore protocol -----------------------------------

    def put(self, r: int, h: np.ndarray, f: np.ndarray) -> None:
        """RAM-preferred proportional placement (the reference's counter
        scheme, sra/SpecialRowsPartition.cpp:316-333): each row goes to
        whichever store is proportionally LESS full (usage/limit), RAM on
        ties — so RAM (fast resume reads) and disk (crash persistence)
        fill at the rate their budgets allow, and the faster store is
        exhausted first rather than last."""
        nbytes = 8 * len(h) + 20
        disk_used = self._disk_bytes + self._pending_floor
        ram_fits = self._ram_bytes + nbytes <= self.ram_limit
        disk_fits = disk_used + nbytes <= self.disk_limit
        ram_frac = ((self._ram_bytes + nbytes) / self.ram_limit
                    if self.ram_limit else 2.0)
        disk_frac = ((disk_used + nbytes) / self.disk_limit
                     if self.disk_limit else 2.0)
        if ram_fits and (ram_frac <= disk_frac or not disk_fits):
            # int32 pairs: 8 bytes/cell, the footprint the flush-ladder
            # formula (m*n*8/limit) and `nbytes` charge for — the kernel
            # computes in int32, so scores always fit
            self._ram[r] = (np.asarray(h, np.int32),
                            np.asarray(f, np.int32))
            self._ram_bytes += nbytes
        elif disk_fits:
            self._wrote(r, write_row(self.dir, r, h, f, self.codec))
        # else: dropped — the flush ladder sized the interval so this
        # cannot happen unless limits were lowered mid-run.

    def put_lazy(self, r: int, lazy) -> None:
        """Lazy placement (manager.LazyFullRow): a RAM-destined row keeps
        its device snapshot and never crosses to the host unless read (a
        RAM row is not crash persistence anyway); a disk-destined row
        starts its asynchronous packed copy to the host now and is written
        in the device's packed form once the bytes land
        (``write_row_packed``, drained on later puts and at finalize), so
        stage 1 neither waits on the copy nor encodes the row."""
        nbytes = 8 * lazy.count + 20
        # in-flight rows charge the disk budget NOW (the write lands in
        # _drain later; without the charge a burst of lazy puts would
        # oversubscribe the budget by the transfer window), at the least
        # their files will take: a row stays in flight until its launch's
        # rows have all come (ops/strips.RowPacker), and a charge of its
        # int32 bytes would move the launch's later rows to RAM
        disk_used = self._disk_bytes + self._pending_floor
        ram_fits = self._ram_bytes + nbytes <= self.ram_limit
        disk_fits = disk_used + nbytes <= self.disk_limit
        ram_frac = ((self._ram_bytes + nbytes) / self.ram_limit
                    if self.ram_limit else 2.0)
        disk_frac = ((disk_used + nbytes) / self.disk_limit
                     if self.disk_limit else 2.0)
        if ram_fits and (ram_frac <= disk_frac or not disk_fits):
            self._ram[r] = lazy
            self._ram_bytes += nbytes
        elif disk_fits:
            lazy.start()
            self._pending.append((r, lazy))
            self._pending_bytes += nbytes
            self._pending_floor += _packed_floor(lazy.count)
            self._drain(block=False)
            # every in-flight row pins its device snapshots: cap the
            # queue in BYTES (blocking on the oldest) so slow copies
            # cannot pile chromosome-scale rows into device memory
            while self._pending_bytes > _PENDING_CAP and self._pending:
                self._write_pending()

    def _drain(self, block: bool) -> None:
        while self._pending and (block or self._pending[0][1].ready()):
            self._write_pending()

    def _write_pending(self) -> None:
        """Write the oldest in-flight row, waiting for its copy."""
        r, lazy = self._pending.pop(0)
        self._pending_bytes -= 8 * lazy.count + 20
        self._pending_floor -= _packed_floor(lazy.count)
        self._wrote(r, write_row_packed(self.dir, r, lazy))

    def _wrote(self, r: int, nbytes: int) -> None:
        """Book row ``r``'s file of ``nbytes``, just written, on disk
        (the trace counter ``rows.bytes``)."""
        self._disk_bytes += nbytes
        self._disk.add(r)
        trace.count("rows.bytes", nbytes)

    def finalize(self) -> None:
        self._drain(block=True)

    def get(self, r: int) -> tuple[np.ndarray, np.ndarray]:
        if r in self._ram:
            v = self._ram[r]
            if not isinstance(v, tuple):
                v = self._ram[r] = v.rows32()
            return v[0].astype(np.int64), v[1].astype(np.int64)
        for rp, lazy in self._pending:
            if rp == r:
                return lazy.full_rows()
        return read_row(self.dir, r)

    def get_window(self, r: int, lo: int, hi: int
                   ) -> tuple[np.ndarray, np.ndarray]:
        """(h[lo:hi], f[lo:hi]) in FULL-ROW indexing, decoding only the
        window for anchored disk rows — the stage-2 match needs a few
        hundred KB of a chromosome-scale row, not all of it."""
        if r in self._ram:
            v = self._ram[r]
            if not isinstance(v, tuple):
                v = self._ram[r] = v.rows32()  # materialize it once
            return (v[0][lo:hi].astype(np.int64),
                    v[1][lo:hi].astype(np.int64))
        for rp, lazy in self._pending:
            if rp == r:
                h, f = lazy.full_rows()
                return h[lo:hi], f[lo:hi]
        return read_row_window(self.dir, r, lo, hi)

    def rows(self) -> list[int]:
        return sorted(set(self._ram) | self._disk
                      | {r for r, _ in self._pending})

    def next_below(self, i: int, min_dist: int = 1) -> int | None:
        cand = [r for r in self.rows() if r <= i - min_dist]
        return max(cand) if cand else None

    def truncate_above(self, i: int) -> None:
        """Drop rows above the found crosspoint
        (SpecialRowsArea::truncatePartition)."""
        for r in [r for r in self._ram if r > i]:
            v = self._ram.pop(r)
            count = v.count if not isinstance(v, tuple) else len(v[0])
            self._ram_bytes -= 8 * count + 20
        for r, lz in self._pending:
            if r > i:
                self._pending_bytes -= 8 * lz.count + 20
                self._pending_floor -= _packed_floor(lz.count)
        self._pending = [(r, lz) for r, lz in self._pending if r <= i]
        gone = [r for r in self._disk if r > i]
        if gone:
            with trace.span("rows.remove"):
                for r in gone:
                    try:
                        os.remove(_row_path(self.dir, r))
                    except OSError:
                        pass
                    self._disk.discard(r)

    def __len__(self):
        return len(self.rows())

    def usage(self) -> dict:
        """The rows in RAM and on disk and the bytes each store charges:
        a RAM row its int32 H and F, a disk row its file (a row whose
        copy is still in flight counts on disk at its int32 bytes)."""
        return {"ram_rows": len(self._ram), "ram_bytes": self._ram_bytes,
                "disk_rows": len(self._disk) + len(self._pending),
                "disk_bytes": self._disk_bytes + self._pending_bytes}

    # --- resume ------------------------------------------------------

    def last_row(self) -> int | None:
        """The resume point: the largest complete persisted row
        (SpecialRowsPartition::continueFromLastRow)."""
        return max(self._disk) if self._disk else None


class SpecialRowsArea:
    """A directory of partitions for one (stage, id, deep)
    (sra/SpecialRowsArea.cpp)."""

    def __init__(self, dirpath: str, ram_limit: int = 1 << 30,
                 disk_limit: int = 1 << 40, codec: str = "none"):
        self.dir = dirpath
        self.ram_limit = ram_limit
        self.disk_limit = disk_limit
        self.codec = codec
        # partition instances are cached so RAM-placed rows stay
        # reachable for the whole process (fresh instances see only the
        # disk rows, which is exactly the crash-resume semantics)
        self._parts: dict[str, SpecialRowsPartition] = {}
        os.makedirs(dirpath, exist_ok=True)

    def _pname(self, i0, j0, i1, j1) -> str:
        return f"{i0:08X}.{j0:08X}.{i1:08X}.{j1:08X}"

    def _open(self, name: str, m: dict) -> SpecialRowsPartition:
        if name not in self._parts:
            self._parts[name] = SpecialRowsPartition(
                os.path.join(self.dir, name),
                m["i0"], m["j0"], m["i1"], m["j1"],
                ram_limit=self.ram_limit, disk_limit=self.disk_limit,
                codec=self.codec,
                row_init=m.get("row_init"), col_init=m.get("col_init"),
            )
        return self._parts[name]

    def create_partition(self, i0, j0, i1, j1,
                         row_init=None, col_init=None
                         ) -> SpecialRowsPartition:
        name = self._pname(i0, j0, i1, j1)
        return self._open(name, {
            "i0": i0, "j0": j0, "i1": i1, "j1": j1,
            "row_init": int(row_init) if row_init is not None else None,
            "col_init": int(col_init) if col_init is not None else None,
        })

    def open_partition(self, i: int, j: int) -> SpecialRowsPartition | None:
        """Find the partition containing (i, j)
        (SpecialRowsArea::openPartition directory scan)."""
        for name in os.listdir(self.dir):
            meta = os.path.join(self.dir, name, "meta.json")
            if not os.path.exists(meta):
                continue
            with open(meta) as f:
                m = json.load(f)
            if m["i0"] <= i <= m["i1"] and m["j0"] <= j <= m["j1"]:
                return self._open(name, m)
        return None

    def partitions(self) -> list[SpecialRowsPartition]:
        out = []
        for name in sorted(os.listdir(self.dir)):
            meta = os.path.join(self.dir, name, "meta.json")
            if os.path.exists(meta):
                with open(meta) as f:
                    m = json.load(f)
                out.append(self._open(name, m))
        return out
