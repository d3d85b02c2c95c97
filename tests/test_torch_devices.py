"""Device listing and resolution in the port (masa_tpu_torch/utils)."""

import pytest
import torch

from masa_tpu_torch.stages import pipeline
from masa_tpu_torch.utils import devices


def test_cpu_resolves_and_is_listed():
    assert devices.resolve_device("cpu") == torch.device("cpu")
    assert {"id": 0, "platform": "cpu", "kind": "cpu", "process": 0} in \
        devices.list_devices()


def test_cuda_request_without_a_gpu_raises():
    """The main path asks for CUDA and never quietly runs on the host."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        devices.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.align_pair(b"ACGT", b"ACGT", pipeline.PipelineConfig())


def test_unsupported_device_raises():
    with pytest.raises(ValueError, match="unsupported device"):
        devices.resolve_device("meta")


def test_auto_flush_interval_rounds_to_the_grain():
    assert pipeline.auto_flush_interval(3000, 3000) == 512
    assert pipeline.auto_flush_interval(1 << 20, 1 << 20) == 8704
