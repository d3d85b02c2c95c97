"""Stage 6 of the port: the independent re-score of a rendered alignment.

masa_tpu's stage 6 (``masa_tpu/stages/stage6.py``) is host code with no
JAX; the port reuses it by import, as it reuses the scoring and biology
modules."""

from masa_tpu.stages.stage6 import RecheckResult, recheck, rescore

__all__ = ["RecheckResult", "recheck", "rescore"]
