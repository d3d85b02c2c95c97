"""Device listing and selection (counterpart of masa_tpu/utils/devices.py,
without the JAX compile cache).

The port keeps no global device: every entry point takes a ``device``
and resolves it here.  A CUDA request on a host without a GPU raises; the
CPU is used only when the caller asks for it."""

from __future__ import annotations

import torch


def list_devices() -> list[dict]:
    """The visible CUDA devices, then the host CPU."""
    out = [{"id": k, "platform": "gpu",
            "kind": torch.cuda.get_device_name(k)}
           for k in range(torch.cuda.device_count())]
    out.append({"id": 0, "platform": "cpu", "kind": "cpu"})
    return out


def resolve_device(device) -> torch.device:
    """``device`` ("cuda", "cuda:1", "cpu" or a torch.device) as a
    torch.device, checked to exist."""
    d = torch.device(device)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch strips on the host")
        if d.index is not None and d.index >= torch.cuda.device_count():
            raise RuntimeError(f"no CUDA device {d.index} "
                               f"({torch.cuda.device_count()} visible)")
    elif d.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return d

