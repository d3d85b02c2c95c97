"""Taken from ``masa_tpu/utils/memory.py`` (the JAX reference).

Process memory probe (the reference's getMasaProcessVmSize,
common/utils.cpp) — used for stage-3 memory-pressure logging."""

from __future__ import annotations


def process_vm_size() -> int:
    """Current process VmSize in bytes (0 if /proc is unavailable)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmSize:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0
