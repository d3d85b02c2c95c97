"""Taken from ``masa_tpu/stages/stage6.py`` (the JAX reference).

Stage 6: render the binary alignment (gap lists) to text/SVG and
re-derive the score independently (the reference re-checks the score while
printing and aborts on mismatch, stage6/sw_stage6.cpp:246-249)."""

from __future__ import annotations

import dataclasses

import numpy as np

from masa_tpu_torch.biology.alignment import Alignment
from masa_tpu_torch.types import ScoreParams

GAP = ord("-")


def expand_gapped(seq: np.ndarray, start: int, end: int, gaps) -> np.ndarray:
    """Materialize the gapped residue string of one side.

    seq: the full encoded sequence; start/end: 1-based inclusive alignment
    bounds; gaps: GapRun list (len gap chars before 1-based position pos).
    """
    runs = sorted(gaps, key=lambda g: g.pos)
    out = []
    p = start
    for g in runs:
        assert start <= g.pos <= end + 1, f"gap at {g.pos} outside bounds"
        out.append(seq[p - 1 : g.pos - 1])
        out.append(np.full(g.len, GAP, np.uint8))
        p = g.pos
    out.append(seq[p - 1 : end])
    return np.concatenate(out) if out else np.empty(0, np.uint8)


@dataclasses.dataclass
class RecheckResult:
    score: int
    matches: int
    mismatches: int
    gap_opens: int
    gap_extensions: int


def rescore(
    s0: np.ndarray, s1: np.ndarray, params: ScoreParams
) -> RecheckResult:
    """Score two equal-length gapped strings from scratch (affine gaps,
    runs counted on the expanded strings — fully independent of the DP)."""
    assert len(s0) == len(s1), "gapped strings must align"
    g0 = s0 == GAP
    g1 = s1 == GAP
    assert not (g0 & g1).any(), "gap aligned to gap"
    both = ~g0 & ~g1
    matches = int((both & (s0 == s1)).sum())
    mismatches = int(both.sum()) - matches
    gap_cols = int(g0.sum() + g1.sum())

    def runs(g):
        if not g.any():
            return 0
        d = np.diff(g.astype(np.int8))
        return int((d == 1).sum()) + int(g[0])

    opens = runs(g0) + runs(g1)
    score = (
        matches * params.match
        + mismatches * params.mismatch
        - opens * params.gap_open
        - gap_cols * params.gap_ext
    )
    return RecheckResult(score, matches, mismatches, opens, gap_cols)


def recheck(
    aln: Alignment, seq0: np.ndarray, seq1: np.ndarray,
    params: ScoreParams | None = None,
) -> RecheckResult:
    """Expand both sides and re-derive the score; raises on mismatch with
    the recorded raw score."""
    params = params or ScoreParams(
        aln.match, aln.mismatch, aln.gap_open, aln.gap_ext
    )
    s0 = expand_gapped(seq0, aln.start[0], aln.end[0], aln.gaps[0])
    s1 = expand_gapped(seq1, aln.start[1], aln.end[1], aln.gaps[1])
    res = rescore(s0, s1, params)
    if res.score != aln.raw_score:
        raise RuntimeError(
            f"stage6 score re-check failed: rendered {res.score}, "
            f"recorded {aln.raw_score}"
        )
    return res


def render_text(
    aln: Alignment, seq0: np.ndarray, seq1: np.ndarray,
    width: int = 60,
) -> str:
    """BLAST-like flat text rendering (stage6 printText,
    stage6/sw_stage6.cpp:60-260)."""
    s0 = expand_gapped(seq0, aln.start[0], aln.end[0], aln.gaps[0])
    s1 = expand_gapped(seq1, aln.start[1], aln.end[1], aln.gaps[1])
    lines = []
    p0, p1 = aln.start[0], aln.start[1]
    for off in range(0, len(s0), width):
        a = s0[off : off + width]
        b = s1[off : off + width]
        mid = bytes(
            b"|"[0] if (x == y and x != GAP) else b" "[0]
            for x, y in zip(a, b)
        )
        n0 = int((a != GAP).sum())
        n1 = int((b != GAP).sum())
        lines.append(
            f"Seq0: {p0:>10}  {a.tobytes().decode('ascii')}  "
            f"{p0 + n0 - 1}"
        )
        lines.append(f"{'':>16}  {mid.decode('ascii')}")
        lines.append(
            f"Seq1: {p1:>10}  {b.tobytes().decode('ascii')}  "
            f"{p1 + n1 - 1}"
        )
        lines.append("")
        p0 += n0
        p1 += n1
    stats = (
        f"Score: {aln.raw_score}  Matches: {aln.matches}  "
        f"Mismatches: {aln.mismatches}  GapOpens: {aln.gap_opens}  "
        f"GapExts: {aln.gap_extensions}"
    )
    return stats + "\n\n" + "\n".join(lines)


def render_histogram(
    aln: Alignment, seq0: np.ndarray, seq1: np.ndarray,
    bins: int = 64, width: int = 800, height: int = 280,
) -> str:
    """Per-window identity histogram along the alignment as a standalone
    SVG — the role of the reference's cairo histogram variant
    (stage6/sw_stage6.cpp:263-989, off-by-default there).  One series
    (identity %), one axis, single hue, thin gapped bars."""
    s0 = expand_gapped(seq0, aln.start[0], aln.end[0], aln.gaps[0])
    s1 = expand_gapped(seq1, aln.start[1], aln.end[1], aln.gaps[1])
    L = len(s0)
    bins = max(1, min(bins, L))
    edges = np.linspace(0, L, bins + 1).astype(int)
    ident = []
    for b in range(bins):
        a = s0[edges[b]:edges[b + 1]]
        c = s1[edges[b]:edges[b + 1]]
        n = max(len(a), 1)
        ident.append(100.0 * float(
            np.sum((a == c) & (a != GAP))) / n)

    ml, mr, mt, mb = 52, 16, 34, 34          # margins
    pw, ph = width - ml - mr, height - mt - mb
    bw = pw / bins
    bar_w = max(bw - 2.0, 1.0)               # 2px surface gap
    parts = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
        f'height="{height}" viewBox="0 0 {width} {height}" '
        f'font-family="sans-serif">',
        f'<rect width="{width}" height="{height}" fill="#ffffff"/>',
        f'<text x="{ml}" y="20" font-size="13" fill="#1f2937">'
        f'Alignment identity per window  '
        f'(score {aln.raw_score}, {aln.matches} matches)</text>',
    ]
    # recessive gridlines + y-axis labels at 0/50/100%
    for v in (0, 50, 100):
        y = mt + ph * (1 - v / 100.0)
        parts.append(
            f'<line x1="{ml}" y1="{y:.1f}" x2="{ml + pw}" y2="{y:.1f}" '
            f'stroke="#e5e7eb" stroke-width="1"/>')
        parts.append(
            f'<text x="{ml - 8}" y="{y + 4:.1f}" font-size="11" '
            f'fill="#6b7280" text-anchor="end">{v}%</text>')
    for b, v in enumerate(ident):
        h = ph * v / 100.0
        x = ml + b * bw + 1.0
        y = mt + ph - h
        parts.append(
            f'<rect x="{x:.1f}" y="{y:.1f}" width="{bar_w:.1f}" '
            f'height="{max(h, 0.5):.1f}" rx="1.5" fill="#3b6fd4"/>')
    # x-axis: alignment-column positions
    for frac in (0.0, 0.5, 1.0):
        x = ml + pw * frac
        parts.append(
            f'<text x="{x:.1f}" y="{height - 10}" font-size="11" '
            f'fill="#6b7280" text-anchor="middle">'
            f'{int(L * frac):,}</text>')
    parts.append('</svg>')
    return "\n".join(parts)


def _fmt_text(aln, seq0, seq1, blocks=None):
    return render_text(aln, seq0, seq1), "txt"


def _fmt_svg(aln, seq0, seq1, blocks=None):
    from masa_tpu_torch.stages.svg import render_svg

    return render_svg(aln, len(seq0), len(seq1), blocks=blocks), "svg"


def _fmt_histogram(aln, seq0, seq1, blocks=None):
    return render_histogram(aln, seq0, seq1), "svg"


# the output-format registry (stage6_formats[], stage6/sw_stage6.cpp:50-57)
FORMATS = {
    "text": _fmt_text,
    "svg": _fmt_svg,
    "histogram": _fmt_histogram,
}
