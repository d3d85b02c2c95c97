"""Stage 4 of the port: Myers-Miller splitting of the crosspoint list
(counterpart of masa_tpu/ops/myers_miller.stage4_reduce).

As in masa_tpu, the engine follows the device: on a CUDA device the
level-batched engine (``ops/batched_mm``, the batched strip kernel), as
masa_tpu runs its batched engine on a TPU; on the CPU masa_tpu's native
C++ ladder (``masa_tpu.native``, JAX-free), as masa_tpu runs it off the
TPU.  masa_tpu's Python splitter lives in a JAX module, so when the native
library cannot be built this raises instead of falling back."""

from __future__ import annotations

import os

import numpy as np
import torch

from masa_tpu.native import bindings
from masa_tpu.types import Crosspoint, ScoreParams
from masa_tpu_torch.ops import batched_mm


def stage4_reduce(seq0: np.ndarray, seq1: np.ndarray,
                  cps: list[Crosspoint], params: ScoreParams,
                  max_partition: int = 16,
                  device="cuda") -> list[Crosspoint]:
    """Split every adjacent crosspoint pair until max(height, width) <=
    max_partition."""
    if not max_partition or len(cps) < 2:
        return cps
    if torch.device(device).type == "cuda":
        return batched_mm.reduce_partitions_batched(
            seq0, seq1, cps, params, max_partition, device=device)
    if not bindings.available():
        why = ("MASA_TPU_NO_NATIVE is set"
               if os.environ.get("MASA_TPU_NO_NATIVE")
               else f"g++ could not build {bindings._SRC}")
        raise RuntimeError(f"stage 4 needs masa_tpu's native library: {why}")
    # the OPTIMIZED ladder, bit-exact with masa_tpu's
    return bindings.reduce_partitions(seq0, seq1, cps, params,
                                      max_partition)
