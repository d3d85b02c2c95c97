"""Taken from ``masa_tpu/models/__init__.py`` (the JAX reference).

Scoring / recurrence model definitions."""

from masa_tpu_torch.models.scoring import (
    border_cells,
    encode_sequence,
    match_column,
)

__all__ = ["border_cells", "encode_sequence", "match_column"]
