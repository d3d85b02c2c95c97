"""Taken from ``masa_tpu/core/capabilities.py`` (the JAX reference).

Aligner capability negotiation (libmasa/capabilities.hpp:59-225)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class AlignerCapabilities:
    customize_first_row: bool = True
    customize_first_column: bool = True
    dispatch_last_row: bool = True
    dispatch_last_column: bool = True
    dispatch_special_rows: bool = True
    dispatch_special_columns: bool = False
    dispatch_best_scores: bool = True
    dispatch_block_scores: bool = True
    process_partitions: bool = True
    variable_penalties: bool = True
    block_pruning: bool = True
    smith_waterman: bool = True
    needleman_wunsch: bool = True
    fork: bool = True
    # int32 scores bound the usable sequence length (H <= match * len)
    maximum_seq0_len: int = 500_000_000
    maximum_seq1_len: int = 500_000_000
