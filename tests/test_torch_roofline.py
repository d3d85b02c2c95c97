"""The roofline tool's bodies (masa_tpu_torch/tools/roofline.py) against
the TPU tool's, on the CPU.

tools/roofline.py defines its bodies as closures inside ``main()``, which
needs a TPU; they are transcribed here in ``jax.numpy`` under
``jax.lax.fori_loop`` (par/ser: tools/roofline.py:111-121; mix:
:133-153; m16: :167-189), with the TPU kernel's final max over the
returned values (:80-84), and run on the TPU tool's own inputs
(:94-96).  The port's plain versions must equal them.  Tolerance: exact
(integer wraparound on both sides).

The bodies the port adds (k1, k1n, k1w: the kernels' own cell,
csrc/gotoh_cell.cuh) have no TPU counterpart; their plain versions are
held against a numpy transcription of csrc/roofline.cu's ``cell_kernel``
written here, and one step of each against the Gotoh cell of the port's
oracle.  Also here, on the CPU: the SASS reader on a listing written by
hand, and the constants that mirror the CUDA sources."""

import contextlib
import os
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from masa_tpu_torch.ops import kernels, oracle
from masa_tpu_torch.tools import roofline as rl
from masa_tpu_torch.types import InitType, Recurrence, ScoreParams

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "masa_tpu_torch", "csrc")

ALPHA, GO, GE = 8, 3, 2


def par_body(vals, it):
    return [jnp.maximum(v ^ it, v - 1) for v in vals]


def ser_body(vals, it):
    (v,) = vals
    for _ in range(8):
        v = jnp.maximum(v ^ it, v - 1)
    return [v]


def mix_body(vals, it):
    hh = list(vals[:ALPHA])
    ee = list(vals[ALPHA:2 * ALPHA])
    up_h = vals[2 * ALPHA]
    up_f = vals[2 * ALPHA + 1]
    dg0 = vals[2 * ALPHA + 2]
    rb = vals[2 * ALPHA + 3] ^ it
    hs, fs = [], []
    for k in range(ALPHA):
        e_k = jnp.maximum(hh[k] - GO, ee[k]) - GE
        uh = up_h if k == 0 else hs[k - 1]
        uf = up_f if k == 0 else fs[k - 1]
        f_k = jnp.maximum(uh - GO, uf) - GE
        dg = dg0 if k == 0 else hh[k - 1]
        sub = jnp.where(rb == k, 1, -3)
        h_k = jnp.maximum(jnp.maximum(dg + sub, e_k), f_k)
        h_k = jnp.maximum(h_k, 0)
        hs.append(h_k)
        fs.append(f_k)
        ee[k] = e_k
    return hs + ee + [up_h, up_f, dg0, vals[2 * ALPHA + 3]]


def mix16_body(vals, it):
    it16 = it.astype(jnp.int16)
    hh = list(vals[:ALPHA])
    ee = list(vals[ALPHA:2 * ALPHA])
    up_h = vals[2 * ALPHA]
    up_f = vals[2 * ALPHA + 1]
    dg0 = vals[2 * ALPHA + 2]
    rb = vals[2 * ALPHA + 3] ^ it16
    hs, fs = [], []
    for k in range(ALPHA):
        e_k = jnp.maximum(hh[k] - jnp.int16(GO), ee[k]) - jnp.int16(GE)
        uh = up_h if k == 0 else hs[k - 1]
        uf = up_f if k == 0 else fs[k - 1]
        f_k = jnp.maximum(uh - jnp.int16(GO), uf) - jnp.int16(GE)
        dg = dg0 if k == 0 else hh[k - 1]
        sub = jnp.where(rb == jnp.int16(k), jnp.int16(1), jnp.int16(-3))
        h_k = jnp.maximum(jnp.maximum(dg + sub, e_k), f_k)
        h_k = jnp.maximum(h_k, jnp.int16(0))
        hs.append(h_k)
        fs.append(f_k)
        ee[k] = e_k
    return hs + ee + [up_h, up_f, dg0, vals[2 * ALPHA + 3]]


JAX_BODIES = {"par": par_body, "ser": ser_body, "mix": mix_body,
              "m16": mix16_body}


def jax_run(body, xs, iters):
    vals = jax.lax.fori_loop(0, iters, lambda it, v: JAX_BODIES[body](v, it),
                             [jnp.asarray(x) for x in xs])
    acc = vals[0]
    for v in vals[1:]:
        acc = jnp.maximum(acc, v)
    return np.asarray(acc.astype(jnp.int32))


@pytest.mark.parametrize("body", ["par", "ser", "mix", "m16"])
@pytest.mark.parametrize("iters", [0, 1, 300])
def test_plain_bodies_match_the_tpu_tool(body, iters):
    xs = rl.inputs(body)
    assert xs[0].shape == ((rl.RS, 256) if body == "m16"
                           else (rl.RS, rl.LANES))
    got = rl.run(body, [torch.from_numpy(x) for x in xs], iters)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), jax_run(body, xs, iters))


def test_dpx_plain_equals_mix():
    xs = [torch.from_numpy(x) for x in rl.inputs("dpx")]
    assert torch.equal(rl.run_plain("dpx", xs, 300),
                       rl.run_plain("mix", xs, 300))


@pytest.mark.parametrize("body", rl.BODIES)
def test_cpu_routes_to_plain_and_kernel_needs_cuda(body):
    xs = [torch.from_numpy(x) for x in rl.inputs(body)]
    before = rl.run_cuda.launches
    assert torch.equal(rl.run(body, xs, 3), rl.run_plain(body, xs, 3))
    assert rl.run_cuda.launches == before == 0
    with pytest.raises(ValueError, match="CUDA"):
        rl.run_cuda(body, xs, 3)
    with pytest.raises(ValueError, match="CUDA"):
        rl.prepare(body, xs)
    assert rl.run_cuda.launches == 0


# --- the bodies with the kernels' own cell -----------------------------------

NEG = -999999999
FLAGS = {"k1": (True, True, False), "k1n": (False, False, False),
         "k1w": (True, True, True)}


def numpy_cell(body, xs, iters, threads=256):
    """csrc/roofline.cu's ``cell_kernel`` in numpy, in int64 with one wrap
    to int32 at the end: thread g sits in block g // threads, its lane is
    (g % threads) % 32."""
    sw, track, warp = FLAGS[body]
    x = np.stack([a.reshape(-1) for a in xs]).astype(np.int64)
    n = x.shape[1]
    threads = min(threads, n)
    H, E, C = x[0:8].copy(), x[8:16].copy(), x[16:24] & 3
    dprev, ph, pf = x[24].copy(), x[25].copy(), x[26].copy()
    g = np.arange(n)
    lane, block = (g % threads) % 32, g // threads
    chars = (x[27] & 3).reshape(-1, threads)
    bs = np.stack([chars[:, i % threads] for i in range(64)], 1)
    BV, BJ = np.full((8, n), NEG), np.zeros((8, n), np.int64)
    if warp:
        ring_in = np.empty((n // 32, 128, 2), np.int64)
        for i in range(128):
            ring_in[:, i, 0] = ph.reshape(-1, 32)[:, i % 32]
            ring_in[:, i, 1] = pf.reshape(-1, 32)[:, i % 32]
        ring_out = np.full((n // 32, 128, 2), NEG)
    for it in range(iters):
        j = it - lane
        uh, uf = ph.copy(), pf.copy()
        if warp:
            uh[lane == 0] = ring_in[:, it % 128, 0]
            uf[lane == 0] = ring_in[:, it % 128, 1]
        bc = bs[block, j % 64]
        vh, vf, dg = uh, uf, dprev
        for k in range(8):
            e = np.maximum(H[k] - 5, E[k] - 2)
            f = np.maximum(vh - 5, vf - 2)
            h = np.maximum(np.maximum(dg + np.where(C[k] == bc, 1, -3), e), f)
            if sw:
                h = np.maximum(h, 0)
            dg = H[k].copy()
            H[k], E[k], vh, vf = h, e, h, f
            if track:
                up = h > BV[k]
                BV[k][up], BJ[k][up] = h[up], j[up]
        dprev = uh
        if warp:
            ring_out[:, (it - 31) % 128, 0] = vh.reshape(-1, 32)[:, 31]
            ring_out[:, (it - 31) % 128, 1] = vf.reshape(-1, 32)[:, 31]
            ph, pf = vh.reshape(-1, 32).copy(), vf.reshape(-1, 32).copy()
            ph[:, 1:], pf[:, 1:] = (vh.reshape(-1, 32)[:, :-1],
                                    vf.reshape(-1, 32)[:, :-1])
            ph, pf = ph.reshape(-1), pf.reshape(-1)
        else:
            ph, pf = vh, vf
    total = dprev + ph + pf + H.sum(0) + E.sum(0)
    if track:
        total = total + BV.sum(0) + BJ.sum(0)
    if warp:
        total = total + ring_out.sum(2).reshape(-1, 4, 32).sum(1).reshape(-1)
    return total.astype(np.int32).reshape(xs[0].shape)


@pytest.mark.parametrize("body", sorted(FLAGS))
@pytest.mark.parametrize("iters", [0, 1, 300])
def test_cell_bodies_match_a_numpy_transcription(body, iters):
    xs = rl.inputs(body)
    assert len(xs) == 28 and xs[0].shape == (rl.RS, rl.LANES)
    got = rl.run(body, [torch.from_numpy(x) for x in xs], iters)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), numpy_cell(body, xs, iters))


@pytest.mark.parametrize("body,threads", [("k1", 64), ("k1n", 32),
                                          ("k1w", 128), ("k1n", 7),
                                          ("k1", 32), ("k1", 128),
                                          ("k1n", 64), ("k1n", 128),
                                          ("k1w", 32), ("k1w", 64)])
def test_cell_bodies_follow_the_block_size(body, threads):
    """The column characters are per block: another block size, another
    result, and the transcription follows."""
    xs = [x[:, :7] if threads == 7 else x for x in rl.inputs(body)]
    ts = [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]
    got = rl.run_plain(body, ts, 40, threads)
    np.testing.assert_array_equal(got.numpy(),
                                  numpy_cell(body, xs, 40, threads))
    if threads != 7:
        assert not torch.equal(got, rl.run_plain(body, ts, 40))


def test_gotoh_cell_is_the_oracles():
    """``gotoh_cell`` on seeded (h_left, e_left, h_up, f_up, h_diag, a, b)
    equals the port's oracle on the 1 x 1 matrix with those borders."""
    rng = np.random.default_rng(31)
    n = 60
    hl, hu, hd = (rng.integers(-40, 60, n) for _ in range(3))
    el, fu = (np.where(rng.random(n) < 0.2, NEG, rng.integers(-60, 40, n))
              for _ in range(2))
    a, b = rng.integers(0, 4, n), rng.integers(0, 4, n)
    t = lambda x: torch.from_numpy(x.astype(np.int32))  # noqa: E731
    for sw, rec in ((True, Recurrence.SMITH_WATERMAN),
                    (False, Recurrence.NEEDLEMAN_WUNSCH)):
        h, e, f = rl.gotoh_cell(t(hl), t(el), t(hd), t(hu), t(fu),
                                torch.from_numpy(a == b), sw)
        assert h.dtype == e.dtype == f.dtype == torch.int32
        for k in range(n):
            ref = oracle.dp_rows(
                np.array([a[k]], np.uint8), np.array([b[k]], np.uint8),
                ScoreParams(rl.MATCH, rl.MISMATCH, rl.GO, rl.GE), rec,
                InitType.CUSTOM, InitType.CUSTOM,
                first_row=(np.array([hd[k], hu[k]]), np.array([NEG, fu[k]])),
                first_col=(np.array([hd[k], hl[k]]), np.array([NEG, el[k]])))
            assert (int(h[k]), int(e[k]), int(f[k])) == (
                ref.last_h[1], ref.col_e[1], ref.last_f[1]), (sw, k)


@pytest.mark.parametrize("body", ["k1", "k1n"])
def test_one_step_is_a_column_of_oracle_cells(body):
    """One iteration of a cell body is, per thread, the oracle's 8 x 1
    matrix: rows from the thread's characters, the column from the
    block's shared characters at column -lane, the borders from its
    state."""
    sw, track, _ = FLAGS[body]
    xs = rl.inputs(body)
    got = rl.run_plain(body, [torch.from_numpy(x) for x in xs], 1,
                       rl.THREADS).numpy().reshape(-1)
    x = np.stack([a.reshape(-1) for a in xs]).astype(np.int64)
    rec = Recurrence.SMITH_WATERMAN if sw else Recurrence.NEEDLEMAN_WUNSCH
    for g in (0, 1, 31, 32, 255, 256, 300, 4095):
        lane, block = (g % 256) % 32, g // 256
        bc = x[27, block * 256 + ((-lane) % 64)] & 3
        dprev, ph, pf = x[24, g], x[25, g], x[26, g]
        ref = oracle.dp_rows(
            (x[16:24, g] & 3).astype(np.uint8), np.array([bc], np.uint8),
            ScoreParams(rl.MATCH, rl.MISMATCH, rl.GO, rl.GE), rec,
            InitType.CUSTOM, InitType.CUSTOM,
            first_row=(np.array([dprev, ph]), np.array([NEG, pf])),
            first_col=(np.concatenate([[dprev], x[0:8, g]]),
                       np.concatenate([[NEG], x[8:16, g]])))
        want = ph + ref.last_h[1] + ref.last_f[1] + ref.col_h[1:].sum() \
            + ref.col_e[1:].sum()
        if track:  # every row's best is its one cell, at column -lane
            want += ref.col_h[1:].sum() - 8 * lane
        assert int(got[g]) == int(np.int64(want).astype(np.int32)), g


def test_shift_lanes_is_a_shuffle_up_by_one():
    v = torch.arange(96, dtype=torch.int32) * 3
    got = rl.shift_lanes(v).view(3, 32)
    assert torch.equal(got[:, 1:], v.view(3, 32)[:, :-1])
    assert torch.equal(got[:, 0], v.view(3, 32)[:, 0])  # lane 0 keeps its own
    # k1w needs whole warps; k1 does not
    xs = [torch.from_numpy(np.ascontiguousarray(x[:, :7]))
          for x in rl.inputs("k1w")]
    with pytest.raises(ValueError, match="whole warps"):
        rl.run_plain("k1w", xs, 2, 7)


def test_cell_floor_counts_the_recurrence_only():
    """The kernels' bound counts what the recurrence needs on the INT32
    lanes (an add-max each for E, F and the diagonal, a max for H, a max
    for the best), never more than the cell bodies' own code issues; and
    the tracked and untracked bodies differ."""
    assert rl.CELL_FLOOR == {"untracked": 4, "tracked": 5}
    header = source("gotoh_cell.cuh")
    cell = header[header.index("void gotoh_cell"):header.index(
        "void track_best")]
    assert cell.count("__viaddmax_s32(") == 3
    assert cell.count("__vimax_s32_relu(") + cell.count(" max(") == 2
    xs = [torch.from_numpy(x) for x in rl.inputs("k1n")]
    assert not torch.equal(rl.run_plain("k1", xs, 50),
                           rl.run_plain("k1n", xs, 50))


def test_launch_alone_counts_the_launch(monkeypatch):
    """``prepare`` stacks and allocates and counts nothing; every
    ``launch`` of the prepared body counts one and hands the library the
    prepared buffers (a stand-in library and stream: no card here)."""
    calls = []

    def fake(code, iters, blocks, threads, src, dst, stream):
        calls.append((code, iters, blocks, threads, src.value, dst.value))
        return 0

    lib = types.SimpleNamespace(masa_roofline_launch=fake)
    monkeypatch.setattr(kernels, "load", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(rl.run_cuda, "launches", 0)
    flat = torch.zeros((28, 512), dtype=torch.int32)
    p = rl.Launch("k1", flat, torch.zeros(512, dtype=torch.int32), 2, 256,
                  (4, 128))
    for n in (1, 2, 3):
        out = rl.launch(p, 7 * n)
        assert rl.run_cuda.launches == n
        assert out.shape == (4, 128) and out.data_ptr() == p.out.data_ptr()
    assert calls == [(rl._CODE["k1"], 7 * n, 2, 256, flat.data_ptr(),
                      p.out.data_ptr()) for n in (1, 2, 3)]
    lib.masa_roofline_launch = lambda *a: 9
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        rl.launch(p, 1)
    assert rl.run_cuda.launches == 3  # a refused launch is not counted


# --- the SASS reader ---------------------------------------------------------

LISTING = """
	code for sm_90a
		Function : _ZN3foo10par_kernelEPKiPii
	.headerflags	@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                 /* 0x00000a00ff017b82 */
                                                                          /* 0x000fe20000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;                     /* 0x0000000000007919 */
        /*0020*/              @!P0 BRA 0x90 ;                             /* 0x0000000000187947 */
        /*0030*/                   LOP3.LUT R4, R4, R7, RZ, 0x3c, !PT ;   /* 0x0000000704047212 */
        /*0040*/                   VIADDMNMX R4, R4, -0x1, R9, !PT ;      /* 0x0000000000000000 */
        /*0050*/                   VIADD R7, R7, 0x1 ;                    /* 0x0000000000000000 */
        /*0060*/                   UIADD3 UR4, UR4, -0x1, URZ ;           /* 0x0000000000000000 */
        /*0070*/                   ISETP.NE.AND P0, PT, R7, RZ, PT ;      /* 0x0000000000000000 */
        /*0080*/               @P0 BRA 0x30 ;                             /* 0x0000000000000000 */
        /*0090*/                   IMAD.MOV.U32 R5, RZ, RZ, R4 ;          /* 0x0000000000000000 */
        /*00a0*/                   LDS.U8 R6, [R5] ;                      /* 0x0000000000000000 */
        /*00b0*/                   SHFL.UP PT, R6, R6, 0x1, RZ ;          /* 0x0000000000000000 */
        /*00c0*/                   BRA.U !UP0, 0xa0 ;                     /* 0x0000000000000000 */
        /*00d0*/                   EXIT ;                                 /* 0x000000000000794d */
        /*00e0*/                   BRA 0xe0;                              /* 0x0000000000000000 */
		Function : _ZN3foo12strip_kernelILi8EEEv
        /*0000*/                   VIADDMNMX R4, R4, R5, R9, !PT ;        /* 0x0 */
        /*0010*/                   BRA 0x0 ;                              /* 0x0 */
"""


def test_sass_reader_on_a_listing():
    fs = rl.sass_functions(LISTING)
    assert sorted(fs) == ["_ZN3foo10par_kernelEPKiPii",
                          "_ZN3foo12strip_kernelILi8EEEv"]
    ins = rl._function(fs, "par_kernel")
    assert [op for _, op, _ in ins][:4] == ["LDC", "S2R", "BRA", "LOP3.LUT"]
    assert ins[2][0] == 0x20 and len(ins) == 15
    # three loops: the body, the shuffle loop, the self-branch at the end
    loops = rl.inner_loops(ins)
    assert loops == [(3, 8), (10, 12), (14, 14)]
    assert rl.main_loop(ins) == (3, 8)
    assert rl.loop_counts(ins, (3, 8)) == {
        "total": 6, "alu": 3, "fma": 1, "uniform": 1, "control": 1}
    assert rl.loop_counts(ins, (10, 12)) == {"total": 3, "lsu": 2,
                                             "control": 1}
    # a cell loop needs a step of cells: 24 add-max
    assert rl.main_loop(ins, cell=True) is None
    with pytest.raises(RuntimeError, match="0 functions"):
        rl._function(fs, "mix_kernel")
    with pytest.raises(RuntimeError, match="2 functions"):
        rl._function(fs, "_kernel")


def test_cell_loop_is_the_tightest_per_add_max():
    """Of two loops that sweep cells, the one with the fewest instructions
    per DPX add-max is the kernel's interior chunk."""
    def loop(at, extra):
        body = [(at + 16 * k, "VIADDMNMX", "") for k in range(24)]
        body += [(at + 16 * (24 + k), "SEL", "") for k in range(extra)]
        end = at + 16 * (24 + extra)
        return body + [(end, "BRA", hex(at))]

    ins = loop(0, 40) + loop(0x1000, 8) + [(0x2000, "EXIT", "")]
    span = rl.main_loop(ins, cell=True)
    assert span == (65, 97)
    assert rl._count(ins, span, "VIADDMNMX") == 24


def test_pipes_and_the_instruction_floor():
    pipes = {"IADD3": "alu", "LOP3.LUT": "alu", "VIADDMNMX": "alu",
             "VIMNMX.RELU": "alu", "ISETP.GE.AND": "alu", "SEL": "alu",
             "VIADD": "fma", "IMAD.IADD": "fma", "IMAD.MOV.U32": "fma",
             "LDS.64": "lsu", "STS.64": "lsu", "SHFL.UP": "lsu",
             "UIADD3": "uniform", "ULOP3.LUT": "uniform", "BRA": "control",
             "BRA.U": "control", "POPC": "xu"}
    assert {op: rl.pipe_of(op) for op in pipes} == pipes
    # bound by the INT32 lanes, then by the schedulers
    assert rl.floor_cycles({"total": 11.75, "alu": 9.1875}) == 9.1875 / 64
    assert rl.floor_cycles({"total": 12, "alu": 2}) == 12 / 128
    assert rl.floor_cycles({"total": 3, "lsu": 3}) == 3 / 128


# --- the constants that mirror the CUDA sources ------------------------------

def source(name):
    with open(os.path.join(CSRC, name)) as fh:
        return fh.read()


def test_constants_mirror_roofline_cu():
    text = source("roofline.cu")
    enum = re.search(r"enum Body \{([^}]*)\}", text).group(1)
    names = [(n.strip().lower(), int(v)) for n, v in re.findall(
        r"(\w+)\s*=\s*(\d+)", enum)]
    assert names == [(b, rl._CODE[b]) for b in rl.BODIES]
    consts = dict(re.findall(r"\b([A-Z][A-Z0-9_]*) = (-?\d+)", text))
    for c_name, value in (("W", rl.W), ("ALPHA", rl.ALPHA), ("GO", rl.GO),
                          ("GE", rl.GE), ("MATCH", rl.MATCH),
                          ("MISMATCH", rl.MISMATCH), ("NEG", rl.NEG),
                          ("RING", rl.RING), ("CHUNK", rl.BS // 2)):
        assert int(consts[c_name]) == value, c_name
    unroll = {"par": "UNROLL_PAR", "ser": "UNROLL_SER", "mix": "UNROLL_MIX",
              "dpx": "UNROLL_MIX", "m16": "UNROLL_MIX",
              **{b: "UNROLL_CELL" for b in rl.CELL}}
    assert {b: int(consts[c]) for b, c in unroll.items()} == rl.UNROLL
    assert text.count("#pragma unroll UNROLL_") == 5
    # the instantiations behind the names SASS_NAME spells
    assert "case K1: return cell_kernel<true, true, false>;" in text
    assert "case K1N: return cell_kernel<false, false, false>;" in text
    assert "case K1W: return cell_kernel<true, true, true>;" in text
    assert rl.CELL == FLAGS
    assert sorted(rl.N_IN) == sorted(rl.BODIES) == sorted(rl.SASS_NAME)


def test_the_kernels_share_one_cell():
    """csrc/strip.cu, csrc/batched_strip.cu and csrc/roofline.cu's cell
    bodies take the recurrence from csrc/gotoh_cell.cuh and spell no cell
    of their own, so the roofline's cell is the kernels'; the header is
    part of each library's name."""
    header = source("gotoh_cell.cuh")
    assert header.count("__viaddmax_s32") >= 3
    for name in ("strip", "batched_strip", "roofline"):
        text = source(f"{name}.cu")
        assert '#include "gotoh_cell.cuh"' in text
        assert "masa::gotoh_cell<" in text
        assert os.path.join(CSRC, "gotoh_cell.cuh") in kernels.source_files(
            name)
    for name in ("strip", "batched_strip"):
        code = re.sub(r"//[^\n]*", "", source(f"{name}.cu"))
        assert "__viaddmax_s32" not in code and "__vimax_s32_relu" not in code
    cell = re.sub(r"//[^\n]*", "", source("roofline.cu"))
    cell = cell[cell.index("void cell_kernel"):cell.index("typedef void")]
    assert "__viaddmax_s32" not in cell and "masa::track_best(" in cell
    assert "masa::track_best(" in source("strip.cu")
