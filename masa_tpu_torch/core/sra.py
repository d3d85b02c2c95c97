"""The special rows area for the port (counterpart of masa_tpu/core/sra.py).

masa_tpu's area is host code and the port reuses it, directory layout,
placement, truncation and resume alike, with one exception: rows stored
in the packed formats ("MSRP", and "MSRQ" when read whole) decode through
``masa_tpu.ops.wavefront.decode_packed_row``, which imports JAX.  These
subclasses read such rows through the port's decoder instead.  masa_tpu's
module is neither edited nor patched, so both packages keep their own
behaviour in one process; a work directory checkpointed by masa_tpu on
its device (packed rows included) resumes under the port.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from masa_tpu.core import sra as _ref
from masa_tpu_torch.ops.wavefront import decode_packed_row


def _read(dirpath: str, r: int) -> bytes:
    with open(_ref._row_path(dirpath, r), "rb") as fh:
        return fh.read()


def _decode_packed(raw: bytes) -> tuple[np.ndarray, np.ndarray]:
    """(h, f) of an MSRP or MSRQ row, border element included."""
    if raw[:4] == _ref.MAGIC_ANCHORED:
        count, bh0, bf0, _stride, ph, pf = _ref._parse_anchored(raw)
        ph, pf = ph[:3], pf[:3]
    else:
        _, count, bh0, bf0, nuh, neh, nuf, nef = struct.unpack_from(
            "<qqqqqqqq", raw, 4)
        off = 4 + 64
        fields = []
        for n_u, n_e in ((nuh, neh), (nuf, nef)):
            u = np.frombuffer(raw, np.uint8, n_u, offset=off)
            off += n_u
            mi = np.frombuffer(raw, np.int64, n_e, offset=off)
            off += 8 * n_e
            mv = np.frombuffer(raw, np.int64, n_e, offset=off)
            off += 8 * n_e
            fields.append((u, mi, mv))
        ph, pf = fields
    h = np.empty(count, np.int64)
    f = np.empty(count, np.int64)
    h[0], f[0] = bh0, bf0
    h[1:] = decode_packed_row(*ph, count - 1)
    f[1:] = decode_packed_row(*pf, count - 1)
    return h, f


def read_row(dirpath: str, r: int) -> tuple[np.ndarray, np.ndarray]:
    """masa_tpu's ``read_row``, packed rows through the port's decoder."""
    raw = _read(dirpath, r)
    if raw[:4] in (_ref.MAGIC_ANCHORED, _ref.MAGIC_PACKED):
        return _decode_packed(raw)
    return _ref.read_row(dirpath, r)


def read_row_window(dirpath: str, r: int, lo: int, hi: int
                    ) -> tuple[np.ndarray, np.ndarray]:
    """masa_tpu's ``read_row_window`` (its anchored window decode is
    NumPy); other formats decode whole through ``read_row``."""
    with open(_ref._row_path(dirpath, r), "rb") as fh:
        anchored = fh.read(4) == _ref.MAGIC_ANCHORED
    if anchored:
        return _ref.read_row_window(dirpath, r, lo, hi)
    h, f = read_row(dirpath, r)
    return h[lo:hi], f[lo:hi]


class SpecialRowsPartition(_ref.SpecialRowsPartition):
    """masa_tpu's partition; rows on disk read through the port's
    decoder."""

    def get(self, r: int) -> tuple[np.ndarray, np.ndarray]:
        if r in self._ram or any(rp == r for rp, _ in self._pending):
            return super().get(r)
        return read_row(self.dir, r)

    def get_window(self, r: int, lo: int, hi: int
                   ) -> tuple[np.ndarray, np.ndarray]:
        if r in self._ram or any(rp == r for rp, _ in self._pending):
            return super().get_window(r, lo, hi)
        return read_row_window(self.dir, r, lo, hi)


class SpecialRowsArea(_ref.SpecialRowsArea):
    """masa_tpu's area, opening the port's partitions."""

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
