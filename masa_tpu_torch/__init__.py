"""masa_tpu_torch — the masa_tpu alignment engine on PyTorch and CUDA.

The library's one-call entry point, as in masa_tpu, plus the device:

    import masa_tpu_torch
    aln = masa_tpu_torch.align("chr1.fa", "chr2.fa")              # GPU
    aln = masa_tpu_torch.align(seq0, seq1, device="cpu")          # host
    print(aln.raw_score, aln.start, aln.end)

The command line, with masa_tpu's options, work directory and resume:
``python -m masa_tpu_torch a.fa b.fa --device cuda|cpu`` (``cli.py``).

On a CUDA device stages 1-3 run the hand-written Hopper strip kernel
(``csrc/strip.cu``) and stage 4 the batched strip kernel
(``csrc/batched_strip.cu``); on the CPU stages 1-3 run the strip kernel's
plain PyTorch version and stage 4 the native ladder
(``native/masanative.cpp``, built with ``g++`` at first use).  The package
stands alone: it keeps its own copy of the host layer (scoring, oracle,
stage 5-6 helpers, native library, the work directory's files) and imports
nothing of masa_tpu or JAX, so it installs and runs without either.
"""

from masa_tpu_torch.types import (
    AlignmentStart,
    InitType,
    Recurrence,
    ScoreParams,
)

__version__ = "0.3.0"  # the project's (pyproject.toml), as masa_tpu's

__all__ = ["align", "load_sequence", "AlignmentStart", "InitType",
           "Recurrence", "ScoreParams"]


def align(seq0, seq1, *, alignment_start="*", alignment_end=None,
          match=1, mismatch=-3, gap_open=3, gap_ext=2,
          backend="auto", max_cells_stage5=1 << 18, device="cuda"):
    """Exact pairwise alignment with full traceback (the six-stage
    pipeline on raw inputs, no persistence).

    ``seq0``/``seq1``: FASTA file path, bytes/str, or a uint8 array.
    ``alignment_start``/``alignment_end``: '*' local, '!' global,
    '1'/'2'/'+' semi-global.  ``device``: "cuda" (default; raises when no
    GPU is present) or "cpu".  Returns a ``biology.alignment.Alignment``.
    """
    from masa_tpu_torch.stages import pipeline
    from masa_tpu_torch.utils.devices import resolve_device

    starts = {"*": AlignmentStart.ANYWHERE,
              "1": AlignmentStart.SEQUENCE_1,
              "2": AlignmentStart.SEQUENCE_2,
              "+": AlignmentStart.SEQUENCE_1_OR_2,
              "!": AlignmentStart.SEQUENCE_1_AND_2}
    pcfg = pipeline.PipelineConfig(
        params=ScoreParams(match, mismatch, gap_open, gap_ext),
        alignment_start=starts[alignment_start],
        alignment_end=(starts[alignment_end] if alignment_end else None),
        backend=backend,
        max_cells_stage5=max_cells_stage5,
        device=str(resolve_device(device)),
    )
    return pipeline.align_pair(load_sequence(seq0), load_sequence(seq1),
                               pcfg)


def load_sequence(x):
    """A sequence as the uint8 array the pipeline takes: a FASTA file
    path, bytes/str of bases, or an array."""
    import os

    import numpy as np

    from masa_tpu_torch.models.scoring import encode_sequence

    if isinstance(x, str) and "\n" not in x:
        path_like = x.endswith((".fa", ".fasta", ".fna")) or os.sep in x
        if os.path.exists(x):
            from masa_tpu_torch.biology.sequence import Sequence

            return Sequence.from_file(x).data()
        if path_like:
            # never silently align a pathname's bytes
            raise FileNotFoundError(x)
    if isinstance(x, np.ndarray):
        return np.asarray(x, np.uint8)
    return encode_sequence(x)
