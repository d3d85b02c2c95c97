"""Taken from ``masa_tpu/io/rowcodec.py`` (the JAX reference).

Special-row compression codecs: none / 8bit / 4bit / vlc.

The reference's config system enumerates these SRA compression strategies
(configs/Configs.hpp:35-41 — COMPRESSION_NONE/8BIT/4BIT/VLC) but never
wires them into the run path; here they are real.  The physics: along a
DP row, H(i,j) - H(i,j-1) is bounded (in [-(open+ext), match] for any
alignment path), so delta encoding collapses H to a few bits per cell;
F is delta-encoded too: F(i, j) derives from the smooth H(i-1, .) row,
so its row deltas are equally bounded, and -INF plateaus delta to zero
(only plateau edges need escapes).

All codecs are exact (lossless roundtrip for arbitrary int64 contents,
including -INF sentinels).  Payload layout per codec is documented on the
encoder.  Encoders/decoders are vectorized NumPy — no Python per-cell
loops.
"""

from __future__ import annotations

import numpy as np

CODECS = ("none", "8bit", "4bit", "vlc")


# --- fixed-width delta with escapes ---------------------------------------


def _enc_i8(v: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """int8 stream with -128 as the escape marker + int64 exception list."""
    small = (v >= -127) & (v <= 127)
    b = np.where(small, v, -128).astype(np.int8)
    return b, v[~small].astype(np.int64)


def _dec_i8(b: np.ndarray, exc: np.ndarray) -> np.ndarray:
    out = b.astype(np.int64)
    out[b == -128] = exc
    return out


def _enc_i4(v: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """nibble stream (two per byte, low nibble first) with -8 as the
    escape marker + int64 exception list."""
    small = (v >= -7) & (v <= 7)
    nib = np.where(small, v, -8).astype(np.int8) & 0xF
    if len(nib) % 2:
        nib = np.concatenate([nib, np.zeros(1, np.int8)])
    packed = (nib[0::2] | (nib[1::2] << 4)).astype(np.uint8)
    return packed, v[~small].astype(np.int64)


def _dec_i4(packed: np.ndarray, n: int, exc: np.ndarray) -> np.ndarray:
    lo = (packed & 0xF).astype(np.int8)
    hi = ((packed >> 4) & 0xF).astype(np.int8)
    # sign-extend 4-bit two's complement
    lo = np.where(lo > 7, lo - 16, lo)
    hi = np.where(hi > 7, hi - 16, hi)
    nib = np.empty(2 * len(packed), np.int64)
    nib[0::2] = lo
    nib[1::2] = hi
    out = nib[:n]
    out[out == -8] = exc
    return out


# --- varint (LEB128 with zigzag) -------------------------------------------


def _enc_vlc(v: np.ndarray) -> np.ndarray:
    """Zigzag + LEB128, vectorized: one pass per byte position (<= 10)."""
    u = (v.astype(np.int64) << 1) ^ (v.astype(np.int64) >> 63)
    u = u.astype(np.uint64)
    if len(u) == 0:
        return np.zeros(0, np.uint8)
    if int(u.max()) < 0x80:
        # the special-row common case: every delta fits one byte
        return u.astype(np.uint8)
    # bytes-per-value by threshold counting (no data-dependent loop)
    nbytes = np.ones(len(u), np.int64)
    for k in range(1, 10):
        nbytes += u >= np.uint64(1 << (7 * k))
    offs = np.cumsum(nbytes) - nbytes
    total = int(nbytes.sum())
    out = np.zeros(total, np.uint8)
    for k in range(10):
        mask = nbytes > k
        if not mask.any():
            break
        byte = ((u[mask] >> np.uint64(7 * k)) & np.uint64(0x7F)).astype(
            np.uint8)
        cont = (nbytes[mask] > k + 1).astype(np.uint8) << 7
        out[offs[mask] + k] = byte | cont
    return out


def _dec_vlc(b: np.ndarray, n: int) -> np.ndarray:
    if n == 0:
        return np.zeros(0, np.int64)
    if len(b) == n:
        # one byte per value (no continuation bits possible)
        u = b.astype(np.uint64)
    else:
        cont = (b & 0x80) != 0
        ends = np.nonzero(~cont)[0]
        assert len(ends) == n, "corrupt varint stream"
        starts = np.empty(n, np.int64)
        starts[0] = 0
        starts[1:] = ends[:-1] + 1
        lens = ends - starts + 1
        payload = (b & np.uint8(0x7F)).astype(np.uint64)
        u = np.zeros(n, np.uint64)
        # one vectorized OR per byte position (values are <= 10 bytes)
        for k in range(int(lens.max())):
            sel = lens > k
            u[sel] |= payload[starts[sel] + k] << np.uint64(7 * k)
    su = u.astype(np.int64)
    return (u >> np.uint64(1)).astype(np.int64) ^ -(su & 1)


# --- public row codec -------------------------------------------------------


def _blob(*arrays: np.ndarray) -> bytes:
    """Self-describing concatenation: u8 count, then per array a
    (u8 dtype-code, i64 length) header + raw bytes."""
    dt = {np.dtype(np.int8): 0, np.dtype(np.uint8): 1,
          np.dtype(np.int64): 2}
    parts = [np.uint8(len(arrays)).tobytes()]
    for a in arrays:
        parts.append(np.uint8(dt[a.dtype]).tobytes())
        parts.append(np.int64(len(a)).tobytes())
        parts.append(a.tobytes())
    return b"".join(parts)


def _unblob(raw: bytes) -> list[np.ndarray]:
    dts = [np.int8, np.uint8, np.int64]
    count = raw[0]
    off = 1
    out = []
    for _ in range(count):
        dt = np.dtype(dts[raw[off]])
        ln = int(np.frombuffer(raw, np.int64, 1, off + 1)[0])
        off += 9
        out.append(np.frombuffer(raw, dt, ln, off))
        off += ln * dt.itemsize
    return out


def _aligned_view(a: np.ndarray, dt) -> np.ndarray:
    """a.view(dt) that never yields an unaligned array: blob payloads sit
    at arbitrary byte offsets inside the file bytes, and NumPy reads of an
    unaligned wide view crawl element-wise (measured ~30x: 6.2 s to decode
    a 5M 'none' row).  The byte-level copy is a plain memcpy."""
    if a.ctypes.data % np.dtype(dt).itemsize:
        a = a.copy()
    return a.view(dt)


def encode_row(codec: str, h: np.ndarray, f: np.ndarray) -> bytes:
    """Encode a special row (H, F integer vectors of equal length; "none"
    stores int32 pairs and takes int32 rows as they are)."""
    if codec == "none":
        data = np.empty((len(h), 2), np.int32)
        data[:, 0] = h
        data[:, 1] = f
        return _blob(data.reshape(-1).view(np.int8))
    h = np.asarray(h, np.int64)
    f = np.asarray(f, np.int64)
    dh = np.diff(h, prepend=np.int64(0))  # dh[0] = h[0]
    df = np.diff(f, prepend=np.int64(0))
    if codec == "8bit":
        bh, eh = _enc_i8(dh)
        bg, eg = _enc_i8(df)
        return _blob(bh, eh.view(np.int8), bg, eg.view(np.int8))
    if codec == "4bit":
        bh, eh = _enc_i4(dh)
        bg, eg = _enc_i4(df)
        return _blob(bh, eh.view(np.int8), bg, eg.view(np.int8))
    if codec == "vlc":
        return _blob(_enc_vlc(dh), _enc_vlc(df))
    raise ValueError(f"unknown row codec {codec!r}")


def decode_row(codec: str, raw: bytes, n: int
               ) -> tuple[np.ndarray, np.ndarray]:
    """Decode a payload back to (H, F), each of length n."""
    parts = _unblob(raw)
    if codec == "none":
        data = _aligned_view(parts[0], np.int32).reshape(n, 2)
        return data[:, 0].astype(np.int64), data[:, 1].astype(np.int64)
    if codec == "8bit":
        bh, eh, bg, eg = parts
        dh = _dec_i8(bh, _aligned_view(eh, np.int64))
        df = _dec_i8(bg, _aligned_view(eg, np.int64))
    elif codec == "4bit":
        bh, eh, bg, eg = parts
        dh = _dec_i4(bh, n, _aligned_view(eh, np.int64))
        df = _dec_i4(bg, n, _aligned_view(eg, np.int64))
    elif codec == "vlc":
        dh = _dec_vlc(parts[0], n)
        df = _dec_vlc(parts[1], n)
    else:
        raise ValueError(f"unknown row codec {codec!r}")
    return np.cumsum(dh), np.cumsum(df)
