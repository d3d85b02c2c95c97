"""The port's special rows area against masa_tpu's, on the CPU.

The port's ``decode_packed_row`` against masa_tpu's on rows that masa_tpu
packs (escapes included); packed rows on disk, in both packed formats,
read back through the port equal to masa_tpu's reading; and the port
leaves masa_tpu's area as it was.  Tolerance: exact equality."""

import os
import struct

import jax.numpy as jnp
import numpy as np
import pytest

from masa_tpu.core import sra as jsra
from masa_tpu.ops import wavefront as jwf
from masa_tpu_torch.core import sra
from masa_tpu_torch.core.job import Job, JobConfig
from masa_tpu_torch.ops import wavefront as wf

INF = 999999999


def packed(row: np.ndarray):
    """masa_tpu's packed form of a row: (u8 nibbles, escape positions,
    escape values)."""
    handle = jwf.pull_row_delta_start(jnp.asarray(row, jnp.int32), len(row))
    return jwf.packed_row_host(handle)


def rows(seed: int, n: int) -> list[np.ndarray]:
    """Rows with small steps, jumps past the 4-bit range, -INF runs and a
    first element far from 0: every escape path of the format."""
    rng = np.random.default_rng(seed)
    smooth = np.cumsum(rng.integers(-3, 4, n)) + 50
    jumpy = smooth.copy()
    jumpy[rng.random(n) < 0.05] += rng.integers(-500, 500)
    neg = jumpy.copy()
    neg[n // 3:n // 2] = -INF
    far = smooth + 123456
    return [x.astype(np.int64) for x in (smooth, jumpy, neg, far)]


@pytest.mark.parametrize("n", [1, 2, 7, 1000, 4097])
def test_decode_packed_row_matches_jax(n):
    escapes = 0
    for row in rows(n, n):
        u, mark, exact = packed(row)
        escapes += len(mark)
        got = wf.decode_packed_row(u, mark, exact, n)
        np.testing.assert_array_equal(
            got, jwf.decode_packed_row(u, mark, exact, n))
        np.testing.assert_array_equal(got, row)
    assert escapes > 0


def write_msrp(dirpath, r, h, f):
    """A row in the legacy packed format (MSRP) as masa_tpu's reader
    parses it (core/sra.py:154-172)."""
    (uh, mih, mvh), (uf, mif, mvf) = packed(h[1:]), packed(f[1:])
    raw = b"".join([
        jsra.MAGIC_PACKED,
        struct.pack("<qqqqqqqq", r, len(h), int(h[0]), int(f[0]), len(uh),
                    len(mih), len(uf), len(mif)),
        uh.tobytes(), mih.astype(np.int64).tobytes(),
        mvh.astype(np.int64).tobytes(), uf.tobytes(),
        mif.astype(np.int64).tobytes(), mvf.astype(np.int64).tobytes()])
    with open(jsra._row_path(dirpath, r), "wb") as fh:
        fh.write(raw)


class Lazy:
    """The LazyFullRow protocol masa_tpu's area persists as MSRQ."""

    def __init__(self, h, f):
        self.h, self.f = h, f
        self.count = len(h)
        self.border_h, self.border_f = int(h[0]), int(f[0])

    def packed(self):
        return packed(self.h[1:]), packed(self.f[1:])

    def anchors(self, stride):
        return self.h[1::stride], self.f[1::stride]


def test_packed_rows_read_back_through_the_port(tmp_path):
    """MSRP and MSRQ rows written by masa_tpu's code read back equal
    through the port's partition, whole and windowed; the other formats
    pass through masa_tpu's reader."""
    part = jsra.SpecialRowsPartition(str(tmp_path / "p"), 0, 0, 10, 4097,
                                     ram_limit=0)
    h, f, g, _ = rows(3, 4098)
    write_msrp(part.dir, 5, h, f)
    jsra.write_row_packed(part.dir, 6, Lazy(h, g))
    jsra.write_row(part.dir, 7, h, g, "4bit")
    mine = sra.SpecialRowsPartition(str(tmp_path / "p"), 0, 0, 10, 4097,
                                    ram_limit=0)
    assert mine.rows() == [5, 6, 7]
    for r, want in ((5, (h, f)), (6, (h, g)), (7, (h, g))):
        got = mine.get(r)
        for x, y, z in zip(got, want, part.get(r)):
            np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(x, z)
        for lo, hi in ((0, 10), (100, 4098), (70000, 70001)):
            for x, y in zip(mine.get_window(r, lo, hi),
                            part.get_window(r, lo, hi)):
                np.testing.assert_array_equal(x, y)


def test_port_area_leaves_masa_tpu_alone(tmp_path):
    """The port's area is a subclass: masa_tpu's module keeps its own
    reader and partitions in the same process."""
    read_row = jsra.read_row
    job = Job(JobConfig(work_dir=str(tmp_path / "w")), device="cpu")
    area = job.sra_area(1, 0)
    part = area.create_partition(0, 0, 10, 10)
    assert type(part) is sra.SpecialRowsPartition
    ref = jsra.SpecialRowsArea(str(tmp_path / "w2"))
    assert type(ref.create_partition(0, 0, 10, 10)) \
        is jsra.SpecialRowsPartition
    assert jsra.read_row is read_row
    assert os.path.isdir(area.dir)
