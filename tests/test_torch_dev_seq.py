"""The port's device sequence cache against masa_tpu's, on the CPU.

Counterpart of tests/test_dev_seq.py, case for case, over
``masa_tpu_torch.ops.wavefront.dev_seq`` and its family (CPU tensors
stand for the card).  Every view's content is held against masa_tpu's
``dev_seq`` for the same array and direction (masa_tpu pads its int32
views with a sentinel, the port its uint8 views with PAD_CHAR; the
sequence part must be equal).  Then what the port adds: the upload and
flip counts, the key's device, and the users of the cache (the aligner,
stage 4's views, the reverse march's seeding).  Tolerance: exact
equality."""

import numpy as np
import pytest

from masa_tpu.ops import wavefront as jwf
from masa_tpu_torch.core.aligner import CUDAAligner
from masa_tpu_torch.ops import batched_mm
from masa_tpu_torch.ops import wavefront as wf
from masa_tpu_torch.stages import core
from masa_tpu_torch.types import (AlignmentStart, Crosspoint,
                                  CrosspointType, InitType, ScoreParams)

SENT = jwf.A_SENTINEL


@pytest.fixture(autouse=True)
def _fresh_cache():
    saved = wf._DEV_SEQ_CACHE, dict(wf.dev_seq_counts)
    jsaved = jwf._DEV_SEQ_CACHE
    wf._DEV_SEQ_CACHE = None
    jwf._DEV_SEQ_CACHE = None
    wf.dev_seq_counts.update(uploads=0, flips=0)
    yield
    wf._DEV_SEQ_CACHE = saved[0]
    wf.dev_seq_counts.update(saved[1])
    jwf._DEV_SEQ_CACHE = jsaved


def _arr(n, seed=0):
    return np.random.default_rng(seed).integers(
        0, 4, size=n, dtype=np.int32).astype(np.uint8)


def ref_view(a, pad, reverse=False):
    """masa_tpu's view of the same array and direction, its sequence part
    as uint8."""
    return np.asarray(jwf.dev_seq(a, SENT, pad, reverse))[:len(a)].astype(
        np.uint8)


class TestDevSeqCache:
    def test_upload_content_and_padding(self):
        a = _arr(100)
        d = wf.dev_seq(a, "cpu", pad=16).numpy()
        assert len(d) == 116
        np.testing.assert_array_equal(d[:100], a)
        np.testing.assert_array_equal(d[:100], ref_view(a, 16))
        assert (d[100:] == wf.PAD_CHAR).all()
        assert wf.dev_seq_counts == {"uploads": 1, "flips": 0}

    def test_reverse_serves_from_forward_by_device_flip(self):
        a = _arr(257, seed=1)
        wf.dev_seq(a, "cpu", pad=8)
        # peek must produce the reversed view WITHOUT an upload (the
        # forward twin exists), and the content must be flipped
        p = wf.dev_seq_peek(a, "cpu", pad=8, reverse=True)
        assert p is not None
        p = p.numpy()
        np.testing.assert_array_equal(p[:257], a[::-1])
        np.testing.assert_array_equal(p[:257], ref_view(a, 8, True))
        assert (p[257:] == wf.PAD_CHAR).all()
        assert wf.dev_seq_counts == {"uploads": 1, "flips": 1}

    def test_forward_serves_from_reverse_by_device_flip(self):
        a = _arr(64, seed=2)
        wf.dev_seq(a, "cpu", pad=4, reverse=True)
        d = wf.dev_seq(a, "cpu", pad=4, reverse=False).numpy()
        np.testing.assert_array_equal(d[:64], a)
        np.testing.assert_array_equal(d[:64], ref_view(a, 4))
        assert wf.dev_seq_counts == {"uploads": 1, "flips": 1}

    def test_larger_pad_serves_smaller_request(self):
        a = _arr(50, seed=3)
        big = wf.dev_seq(a, "cpu", pad=100)
        n_entries = len(wf._DEV_SEQ_CACHE)
        small = wf.dev_seq(a, "cpu", pad=10)
        assert small is big                    # same device buffer
        assert len(wf._DEV_SEQ_CACHE) == n_entries
        assert wf.dev_seq_counts["uploads"] == 1

    def test_peek_without_any_entry_is_none(self):
        a = _arr(10, seed=4)
        assert wf.dev_seq_peek(a, "cpu", pad=0) is None
        assert jwf.dev_seq_peek(a, SENT, pad=0) is None

    def test_seed_reversed_keys_on_the_reversed_host_array(self):
        fwd = _arr(300, seed=5)
        rev = np.ascontiguousarray(fwd[::-1])
        wf.dev_seq(fwd, "cpu", pad=16)
        wf.dev_seq_seed_reversed(fwd, rev, "cpu", pad=16)
        # a consumer passing the REVERSED host array hits the seeded entry
        # (forward direction of rev == content of rev)
        hit = wf.dev_seq_peek(rev, "cpu", pad=16)
        assert hit is not None
        np.testing.assert_array_equal(hit.numpy()[:300], rev)
        np.testing.assert_array_equal(hit.numpy()[:300], ref_view(rev, 16))
        assert wf.dev_seq_counts == {"uploads": 1, "flips": 1}

    def test_seed_reversed_without_forward_entry_is_a_noop(self):
        fwd = _arr(20, seed=6)
        rev = np.ascontiguousarray(fwd[::-1])
        wf.dev_seq_seed_reversed(fwd, rev, "cpu", pad=0)
        assert wf.dev_seq_peek(rev, "cpu", pad=0) is None
        assert wf.dev_seq_counts == {"uploads": 0, "flips": 0}

    def test_distinct_arrays_do_not_collide(self):
        a = _arr(128, seed=7)
        b = _arr(128, seed=8)
        wf.dev_seq(a, "cpu", pad=0)
        db = wf.dev_seq(b, "cpu", pad=0).numpy()
        np.testing.assert_array_equal(db[:128], b)
        np.testing.assert_array_equal(db[:128], ref_view(b, 0))

    def test_lru_stays_bounded(self):
        keep = [_arr(64, seed=100 + i) for i in range(14)]
        for x in keep:
            wf.dev_seq(x, "cpu", pad=0)
            jwf.dev_seq(x, SENT, pad=0)
        assert len(wf._DEV_SEQ_CACHE) <= wf.DEV_SEQ_ENTRIES == 10
        # the same entries as masa_tpu's: the last ten, oldest first
        assert [k[:2] for k in wf._DEV_SEQ_CACHE] == \
            [k[:2] for k in jwf._DEV_SEQ_CACHE]


def test_lru_is_bounded_in_bytes(monkeypatch):
    """The byte bound (masa_tpu's 2 GiB, here shrunk) drops the oldest
    views first."""
    monkeypatch.setattr(wf, "DEV_SEQ_BYTES", 250)
    keep = [_arr(100, seed=200 + i) for i in range(3)]
    for x in keep:
        wf.dev_seq(x, "cpu")
    assert len(wf._DEV_SEQ_CACHE) == 2
    assert wf.dev_seq_peek(keep[0], "cpu") is None
    assert wf.dev_seq_peek(keep[2], "cpu") is not None


def test_a_view_is_not_the_host_array():
    """The view is a copy: writing the host array after the upload leaves
    it (and the entry keeps the host array, so its address is not taken
    by another array while the entry lives)."""
    a = _arr(40, seed=9)
    view = wf.dev_seq(a, "cpu")
    want = a.copy()
    a[:] = 0
    np.testing.assert_array_equal(view.numpy(), want)
    assert any(host is a for _, host in wf._DEV_SEQ_CACHE.values())


def test_the_aligner_takes_its_views_from_the_cache():
    """CUDAAligner.set_sequences copies each array once: a second aligner
    on the same arrays, and the reverse march's seeded reversed arrays,
    copy nothing."""
    s0, s1 = _arr(500, seed=10), _arr(700, seed=11)
    first = CUDAAligner(wf.StripConfig(), "cpu")
    first.set_sequences(s0, s1)
    assert wf.dev_seq_counts == {"uploads": 2, "flips": 0}
    again = CUDAAligner(wf.StripConfig(), "cpu")
    again.set_sequences(s0, s1)
    assert again._dev0 is first._dev0 and again._dev1 is first._dev1
    rev = (np.ascontiguousarray(s0[::-1]), np.ascontiguousarray(s1[::-1]))
    for fwd, r in zip((s0, s1), rev):
        wf.dev_seq_seed_reversed(fwd, r, "cpu")
    again.set_sequences(*rev)
    assert wf.dev_seq_counts == {"uploads": 2, "flips": 2}
    np.testing.assert_array_equal(again._dev1.numpy(), s1[::-1])


def test_stage4_views_come_from_the_cache():
    """ops/batched_mm._DevSeqs: the forward views are stage 1's and the
    reversed ones flips of them (masa_tpu's four dev_seq views)."""
    s0, s1 = _arr(300, seed=12), _arr(400, seed=13)
    CUDAAligner(wf.StripConfig(), "cpu").set_sequences(s0, s1)
    views = batched_mm._DevSeqs(s0, s1, "cpu")
    assert wf.dev_seq_counts == {"uploads": 2, "flips": 2}
    for rev in (False, True):
        a, b = views.views(rev)
        np.testing.assert_array_equal(a.numpy(), s0[::-1] if rev else s0)
        np.testing.assert_array_equal(b.numpy(), s1[::-1] if rev else s1)
        np.testing.assert_array_equal(a.numpy(), ref_view(s0, 0, rev))


def test_reverse_march_seeds_the_reversed_views(dna, homolog):
    """Stage 1's forward copies serve the whole march: its hops copy no
    sequence from the host, the reversed views are two flips."""
    s0 = dna(1500, seed=14)
    s1 = homolog(s0, seed=15)
    p = ScoreParams()
    cache = core.DevRowCache(1 << 30)
    res = core.forward_pass(
        s0, s1, p, core.Recurrence.SMITH_WATERMAN, InitType.WITH_ZEROES,
        InitType.WITH_ZEROES, special_every=256, backend="kernel",
        device="cpu", dev_cache=cache)
    assert wf.dev_seq_counts == {"uploads": 2, "flips": 0}
    ep = Crosspoint(res.best_i, res.best_j, res.best, CrosspointType.MATCH)
    core.reverse_march(s0, s1, p, ep, res.specials, InitType.WITH_ZEROES,
                       InitType.WITH_ZEROES, AlignmentStart.ANYWHERE,
                       backend="kernel", device="cpu", dev_cache=cache)
    assert wf.dev_seq_counts == {"uploads": 2, "flips": 2}


def test_views_of_one_buffer_do_not_collide():
    """Two views with one pointer and one length but other strides are
    two keys (the port keys the strides beside masa_tpu's fields)."""
    buf = _arr(200, seed=20)
    a, b = buf[:100], buf[::2]
    assert a.__array_interface__["data"][0] == \
        b.__array_interface__["data"][0] and len(a) == len(b)
    wf.dev_seq(a, "cpu")
    np.testing.assert_array_equal(wf.dev_seq(b, "cpu").numpy(), b)
    assert wf.dev_seq_counts["uploads"] == 2
