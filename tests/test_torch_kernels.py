"""What surrounds the Hopper kernels and runs on any host: the strip
kernel's and the batched kernels' block geometry rules, the wrappers'
refusal of CPU tensors, the build's naming.  The kernels themselves run only on a card
(``tests/test_torch_cuda.py``)."""

import os
import re

import numpy as np
import pytest
import torch

from masa_tpu_torch.ops import kernels

SMS = 132  # an H100's SMs


@pytest.mark.parametrize("h,nj,want", [
    (1 << 20, 1 << 20, (8, 8)),    # the stage-1 launch: 2048-row blocks
    (8192, 16384, (2, 4)),         # a stage-2 hop: 32 blocks of 256 rows
    (8192, 1 << 20, (2, 4)),
    (200_000, 300, (4, 8)),        # fills the SMs at 4 rows a thread
    (512, 4096, (2, 8)),           # one block, no global hand-off
    (300, 5, (2, 5)),
    (1, 1, (2, 1)),
])
def test_strip_geometry_rule(h, nj, want):
    assert kernels.strip_geometry(h, SMS) == want


@pytest.mark.parametrize("h", [1, 63, 64, 65, 512, 513, 8192, 65536,
                               135167, 135168, 270335, 270336, 1 << 22])
@pytest.mark.parametrize("sms", [1, 108, 132])
def test_strip_geometry_is_launchable(h, sms):
    """Every height maps to a shape the kernel has (alpha 8, 4 or 2; 1 to
    8 compute warps), one block when the strip fits one, and never fewer
    blocks than SMs unless blocks are already at 4 warps or fewer."""
    alpha, warps = kernels.strip_geometry(h, sms)
    assert alpha in (8, 4, 2) and 1 <= warps <= 8
    rows = 32 * alpha * warps
    n_sub = -(-h // rows)
    if h <= 512:
        assert n_sub == 1 and rows - 32 * alpha < h
    if warps == 8 and n_sub > 1:
        assert n_sub >= sms
    if alpha > 2:
        assert h >= rows * sms


def test_wrappers_refuse_cpu_tensors():
    a = torch.zeros(4, dtype=torch.uint8)
    x = torch.zeros(4, dtype=torch.int32)
    kw = dict(match=1, mismatch=-3, gap_open=3, gap_ext=2)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.strip_cuda(a, a, x, x, x, x, 0, sw=True, **kw)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.batched_strip_cuda(a, a, [[0, 1, 0, 1, 0, 0]], 4, **kw)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.batched_strip_fixed_cuda(a[None], a[None], x[None], x[None],
                                         x[None], x[None], x[:1], **kw)
    assert kernels.strip_cuda.launches == 0


def test_build_names_follow_source_and_defines(tmp_path, monkeypatch):
    """A library is named by the hash of its source and of the cell's
    header it includes, and by the variant's defines, lives under the
    build directory, and an existing one is not rebuilt (no compiler is
    needed to find it)."""
    import hashlib

    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path))
    files = [kernels.SOURCES["strip"], os.path.join(
        os.path.dirname(kernels.SOURCES["strip"]), "gotoh_cell.cuh")]
    assert kernels.source_files("strip") == files
    src = b""
    for name in files:
        with open(name, "rb") as fh:
            src += fh.read()
    names = {}
    for defines in ((), ("MASA_PROFILE",)):
        digest = hashlib.sha256(
            src + " ".join(defines).encode()).hexdigest()[:16]
        path = tmp_path / f"libstrip_{digest}.so"
        path.write_bytes(b"")
        assert kernels.build("strip", defines) == str(path)
        names[defines] = path
    assert names[()] != names[("MASA_PROFILE",)]
    assert sorted(os.listdir(tmp_path)) == sorted(
        p.name for p in names.values())


def test_launch_events_are_off_by_default():
    assert kernels.event_log is None
    assert kernels.drain_events() == {}


def test_build_digest_covers_included_files(tmp_path, monkeypatch):
    """A library's name follows every file its source includes by a quoted
    name, directly or through another: an edit to a shared header renames
    (rebuilds) every kernel that includes it."""
    (tmp_path / "k.cu").write_text(
        '#include <cuda_runtime.h>\n  #  include "common.cuh"\nint k;\n')
    (tmp_path / "common.cuh").write_text('#include "deep/ring.cuh"\n')
    (tmp_path / "deep").mkdir()
    (tmp_path / "deep" / "ring.cuh").write_text("// ring\n")
    (tmp_path / "lone.cu").write_text("int lone;\n")
    monkeypatch.setattr(kernels, "SOURCES", {
        "k": str(tmp_path / "k.cu"), "lone": str(tmp_path / "lone.cu")})
    assert kernels.source_files("k") == [
        str(tmp_path / "k.cu"), str(tmp_path / "common.cuh"),
        str(tmp_path / "deep" / "ring.cuh")]
    before = kernels.source_digest("k"), kernels.source_digest("lone")
    (tmp_path / "deep" / "ring.cuh").write_text("// ring, edited\n")
    assert kernels.source_digest("k") != before[0]
    assert kernels.source_digest("lone") == before[1]
    assert kernels.source_digest("k", ("X",)) != kernels.source_digest("k")


@pytest.mark.parametrize("name", sorted(kernels.SOURCES))
def test_every_include_of_a_kernel_is_in_its_digest(name):
    """Each quoted include of the shipped sources exists and is one of the
    files the digest reads."""
    files = kernels.source_files(name)
    assert files[0] == kernels.SOURCES[name]
    for path in files:
        with open(path) as fh:
            for inc in re.findall(r'#\s*include\s*"([^"]+)"', fh.read()):
                assert os.path.normpath(os.path.join(
                    os.path.dirname(path), inc)) in files


# level shapes of stage 4 on a 1M pair, the equal-shape kernel's measured
# shape, and launches with stragglers: (heights, (alpha, warps, per_block))
GEOMETRY_TABLE = [
    ([4096] * 128, (8, 16, 1)),    # a whole block of 16 warps per half
    ([2048] * 256, (8, 8, 1)),
    ([1024] * 512, (8, 4, 1)),
    ([512] * 1024, (8, 2, 2)),
    ([256] * 2048, (8, 1, 4)),     # a warp per element, four to a block
    ([128] * 4096, (4, 1, 4)),     # rows a thread fall to keep lanes full
    ([64] * 8192, (2, 1, 4)),
    ([1], (2, 1, 4)),
    ([255], (2, 4, 1)),            # fewer warps than SMs: 2 rows a thread
    ([127], (2, 2, 2)),
    ([512, 256, 509, 300, 256, 512, 400], (2, 8, 1)),  # a last level's few
    ([512] * 40, (4, 4, 1)),       # a warp per SM at 4 rows a thread
    ([9000] * 3, (4, 32, 1)),      # taller than a block: chained sub-strips
    ([9000] * 8, (8, 16, 1)),
    ([64] * 1000 + [4096] * 3, (2, 1, 4)),   # tall stragglers chain
    ([4096] * 100 + [3, 1, 70], (8, 16, 1)),  # short stragglers idle warps
    ([4096, 4000, 4100, 3900] * 32, (8, 16, 1)),
    (list(range(1, 301)), (4, 2, 2)),  # mixed: the middle row's height
]


@pytest.mark.parametrize("heights,want", GEOMETRY_TABLE,
                         ids=[f"{len(h)}x{h[0]}" for h, _ in GEOMETRY_TABLE])
def test_batched_geometry_rule(heights, want):
    assert tuple(kernels.batched_geometry(heights, SMS)[:3]) == want


@pytest.mark.parametrize("heights", [h for h, _ in GEOMETRY_TABLE]
                         + [[1, 4097, 31, 33, 256, 257, 2049, 64, 65]],
                         ids=lambda h: f"{len(h)}x{h[0]}")
@pytest.mark.parametrize("sms", [1, 132])
def test_batched_geometry_is_launchable(heights, sms):
    """Every launch maps to a shape the kernels take; every element has a
    place in a block; the dispatch order is a permutation, tallest first,
    whose inverse restores the caller's order; the lanes of a warp are
    filled at the height the shape follows."""
    h = np.asarray(heights)
    geo = kernels.batched_geometry(heights, sms)
    assert geo.alpha in kernels.BATCHED_MAX_WARPS
    assert 1 <= geo.warps and 1 <= geo.per_block
    assert geo.warps * geo.per_block <= kernels.BATCHED_MAX_WARPS[geo.alpha]
    blocks = -(-len(h) // geo.per_block)
    assert blocks * geo.per_block >= len(h)
    assert sorted(geo.order.tolist()) == list(range(len(h)))
    assert (np.diff(h[geo.order]) <= 0).all()
    inverse = np.empty_like(geo.order)
    inverse[geo.order] = np.arange(len(h))
    assert (h[geo.order][inverse] == h).all()
    # the height the shape follows lies among the elements', its warps
    # cover it (or are a whole block) and their lanes are full
    rows = 32 * geo.alpha * geo.warps
    if h.min() == h.max():
        assert rows >= h[0] or \
            geo.warps == kernels.BATCHED_MAX_WARPS[geo.alpha]
        assert geo.alpha == 2 or 32 * geo.alpha <= h[0]
        assert rows - 32 * geo.alpha < h[0]  # no warp without a row
    else:
        assert rows - 32 * geo.alpha < h.max()


@pytest.mark.parametrize("heights", [h for h, _ in GEOMETRY_TABLE]
                         + [[1, 4097, 31, 33, 256, 257, 2049, 64, 65]],
                         ids=lambda h: f"{len(h)}x{h[0]}")
def test_batched_items_own_every_row_once(heights):
    """The item table cuts every element into sub-strips of the geometry's
    rows: each row of each element in exactly one item, an element's
    sub-strips one after another from 0, tallest element first, a counter
    per sub-strip of a chained element (consecutive, so the sub-strip
    above has the counter before), none for the others."""
    h = np.asarray(heights)
    B = len(h)
    elems = np.stack([np.arange(B), h, np.arange(B) + 7, np.arange(B) % 5,
                      np.arange(B) % 3, (np.arange(B) + 1) % 3],
                     1).astype(np.int32)
    geo = kernels.batched_geometry(h, SMS)
    items, counters = kernels.batched_items(elems, geo)
    assert items.dtype == np.int32 and items.shape[1] == 9
    assert (items[:, :6] == elems[items[:, 6]]).all()
    covered = np.zeros(B, np.int64)
    seen = []
    for k, (out, sub, ctr) in enumerate(items[:, 6:].tolist()):
        rows = min(geo.rows, h[out] - sub * geo.rows)
        assert rows >= 1
        covered[out] += rows
        if sub == 0:
            seen.append(out)
        else:  # right after the sub-strip above, its counter the one before
            assert items[k - 1, 6] == out and items[k - 1, 7] == sub - 1
            assert items[k - 1, 8] == ctr - 1
        assert (ctr >= 0) == (h[out] > geo.rows)
    assert (covered == h).all()
    assert seen == geo.order.tolist()
    used = items[items[:, 8] >= 0, 8]
    assert used.tolist() == list(range(counters))


@pytest.mark.parametrize("bad", [[], [0], [5, -1]])
def test_batched_geometry_refuses_bad_heights(bad):
    with pytest.raises(ValueError, match="heights"):
        kernels.batched_geometry(bad, SMS)


def test_batched_sweep_has_no_block_barrier():
    """The batched kernels' source holds one ``__syncthreads()``, after the
    counters are zeroed and outside the sweep, and both entries call the
    one ``element`` sweep."""
    with open(kernels.SOURCES["batched_strip"]) as fh:
        code = re.sub(r"//[^\n]*", "", fh.read())
    assert code.count("__syncthreads()") == 1
    carve = code[code.index("Shared carve("):code.index("size_t shared_bytes")]
    assert "__syncthreads()" in carve
    sweep = code[code.index("void element("):code.index("Shared carve(")]
    assert "__syncthreads" not in sweep and "for (int c0" in sweep
    assert code.count("element<A>(jb, bd, sc, sh, wl, wpe, lane);") == 2
