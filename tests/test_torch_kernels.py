"""What surrounds the Hopper kernels and runs on any host: the strip
kernel's block geometry rule, the wrappers' refusal of CPU tensors, the
build's naming.  The kernels themselves run only on a card
(``tests/test_torch_cuda.py``)."""

import os

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
    """A library is named by its source's hash and the variant's defines,
    lives under the build directory, and an existing one is not rebuilt
    (no compiler is needed to find it)."""
    import hashlib

    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path))
    with open(kernels.SOURCES["strip"], "rb") as fh:
        src = fh.read()
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
