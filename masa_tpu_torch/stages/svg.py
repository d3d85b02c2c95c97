"""Taken from ``masa_tpu/stages/svg.py`` (the JAX reference).

SVG rendering of an alignment (the cairo plot of stage6,
stage6/sw_stage6.cpp:263-989, re-done as dependency-free SVG XML)."""

from __future__ import annotations

from masa_tpu_torch.biology.alignment import Alignment


def _path_points(aln: Alignment, max_points: int = 2048):
    """Walk the gap lists to sample the alignment path in matrix coords."""
    g0 = sorted(aln.gaps[0], key=lambda g: g.pos)
    g1 = sorted(aln.gaps[1], key=lambda g: g.pos)
    pts = [(aln.start[0] - 1, aln.start[1] - 1)]
    i, j = aln.start[0] - 1, aln.start[1] - 1
    k0 = k1 = 0
    while i < aln.end[0] or j < aln.end[1]:
        # gap in seq0 (consume seq1) before seq0 position i+1
        if k0 < len(g0) and g0[k0].pos == i + 1:
            j += g0[k0].len
            k0 += 1
        elif k1 < len(g1) and g1[k1].pos == j + 1:
            i += g1[k1].len
            k1 += 1
        else:
            d = 1
            nd0 = g0[k0].pos - 1 - i if k0 < len(g0) else aln.end[0] - i
            nd1 = g1[k1].pos - 1 - j if k1 < len(g1) else aln.end[1] - j
            d = max(1, min(nd0, nd1))
            i += d
            j += d
        pts.append((i, j))
    if len(pts) > max_points:
        step = len(pts) // max_points + 1
        pts = pts[::step] + [pts[-1]]
    return pts


def _blocks_heatmap(blocks, w: float, h: float, max_cells: int = 64) -> str:
    """SVG rects for the per-block score grid (the pruning-area plot,
    stage6/sw_stage6.cpp:320-376 drawPruningArea): pruned blocks (-INF
    maxima) render gray; live blocks shade with their max score."""
    import numpy as np

    grid = np.asarray(blocks)
    if grid.size == 0:
        return ""
    gh, gw = grid.shape
    sy = max(1, gh // max_cells)
    sx = max(1, gw // max_cells)
    ph, pw = -(-gh // sy), -(-gw // sx)
    pad = np.full((ph * sy, pw * sx), grid.min(), grid.dtype)
    pad[:gh, :gw] = grid
    red = pad.reshape(ph, sy, pw, sx).max(axis=(1, 3))
    pruned = red <= -(10 ** 8)
    live = red[~pruned]
    lo, hi = (int(live.min()), int(live.max())) if live.size else (0, 1)
    cw, ch = w / pw, h / ph
    out = []
    for a in range(ph):
        for b in range(pw):
            if pruned[a, b]:
                fill = "#d9d9d9"
            else:
                t = (red[a, b] - lo) / max(hi - lo, 1)
                # white -> steel blue ramp
                r = int(255 - 185 * t)
                g = int(255 - 125 * t)
                out_b = int(255 - 75 * t)
                fill = f"#{r:02x}{g:02x}{out_b:02x}"
            out.append(
                f'<rect x="{b*cw:.1f}" y="{a*ch:.1f}" width="{cw:.2f}" '
                f'height="{ch:.2f}" fill="{fill}"/>'
            )
    return "\n    ".join(out)


def render_svg(aln: Alignment, m: int, n: int, size: int = 800,
               blocks=None) -> str:
    scale = size / max(m, n, 1)
    w, h = n * scale, m * scale
    pts = _path_points(aln)
    poly = " ".join(f"{j*scale:.1f},{i*scale:.1f}" for i, j in pts)
    heat = _blocks_heatmap(blocks, w, h) if blocks is not None else ""
    return f"""<?xml version="1.0" encoding="UTF-8"?>
<svg xmlns="http://www.w3.org/2000/svg" width="{w+80:.0f}" height="{h+60:.0f}">
  <g transform="translate(40,40)">
    <rect x="0" y="0" width="{w:.1f}" height="{h:.1f}"
          fill="white" stroke="black"/>
    {heat}
    <polyline points="{poly}" fill="none" stroke="crimson"
              stroke-width="1.5"/>
    <text x="0" y="-8" font-family="monospace" font-size="12">
      score={aln.raw_score} matches={aln.matches}
      mismatches={aln.mismatches} gaps={aln.gap_opens}/{aln.gap_extensions}
    </text>
    <text x="0" y="{h+16:.0f}" font-family="monospace"
          font-size="10">seq1: 1..{n}</text>
    <text x="-32" y="0" font-family="monospace" font-size="10"
          transform="rotate(-90 -32 0)">seq0: 1..{m}</text>
  </g>
</svg>
"""
