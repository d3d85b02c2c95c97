"""Device listing, weighting and selection (counterpart of
masa_tpu/utils/devices.py, the cuda_util analogue, src/cuda_util.cpp:191-305,
without the JAX compile cache).

The port keeps no global device: every entry point takes a ``device``
and resolves it here.  A CUDA request on a host without a GPU raises; the
CPU is used only when the caller asks for it."""

from __future__ import annotations

import torch

# rounds of the int32 burst that device_weights times on each card
# (masa_tpu's: the wavefront cell's max/add/select mix, not a matmul)
BURST_ROUNDS = 48


def process_index() -> int:
    """This process's rank when a torch.distributed group is up, else 0."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and \
        dist.is_initialized() else 0


def list_devices() -> list[dict]:
    """The visible CUDA devices, then the host CPU, each with the process
    that lists it."""
    p = process_index()
    out = [{"id": k, "platform": "gpu",
            "kind": torch.cuda.get_device_name(k), "process": p}
           for k in range(torch.cuda.device_count())]
    out.append({"id": 0, "platform": "cpu", "kind": "cpu", "process": p})
    return out


def format_device_list() -> str:
    """``--list-devices``: masa_tpu's lines."""
    lines = ["available devices:"]
    for d in list_devices():
        lines.append(f"  [{d['id']}] {d['platform']} {d['kind']} "
                     f"(process {d['process']})")
    return "\n".join(lines)


def _burst(x: torch.Tensor) -> torch.Tensor:
    y = x
    for _ in range(BURST_ROUNDS):
        y = torch.maximum(y + 3, x - y)
        y = torch.where(y > 0, y - 2, y + 1)
    return y


def device_weights(probe: bool = False, reps: int = 3) -> list[float]:
    """Relative throughput weights of the compute devices, for column
    splitting (getGPUWeights feeding --fork, src/cuda_util.cpp:191): one
    per CUDA card, or one for the CPU when there is none.  Uniform by
    default; ``probe=True`` on two or more cards times masa_tpu's int32
    burst on each (CUDA events, the least of ``reps`` after a warm run) and
    returns weights normalised to the slowest card."""
    count = torch.cuda.device_count()
    if not probe or count < 2:
        return [1.0] * max(count, 1)
    rates = []
    for k in range(count):
        dev = torch.device("cuda", k)
        x = torch.ones((256, 512), dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            _burst(x)
            best = None
            for _ in range(reps):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                _burst(x)
                end.record()
                end.synchronize()
                ms = start.elapsed_time(end)
                best = ms if best is None else min(best, ms)
        rates.append(1.0 / max(best, 1e-9))
    lo = min(rates)
    return [r / lo for r in rates]


def select_device(fork_id: int, device="cuda") -> torch.device:
    """The device of process ``fork_id`` (selectGPU, cuda_util.cpp:287):
    ``cuda:{fork_id % count}``, or the CPU when ``device`` asks for it."""
    d = resolve_device(device)
    if d.type == "cpu":
        return d
    return torch.device("cuda", fork_id % torch.cuda.device_count())


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
