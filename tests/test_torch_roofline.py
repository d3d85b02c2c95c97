"""The roofline tool's bodies (masa_tpu_torch/tools/roofline.py) against
the TPU tool's, on the CPU.

tools/roofline.py defines its bodies as closures inside ``main()``, which
needs a TPU; they are transcribed here in ``jax.numpy`` under
``jax.lax.fori_loop`` (par/ser: tools/roofline.py:111-121; mix:
:133-153; m16: :167-189), with the TPU kernel's final max over the
returned values (:80-84), and run on the TPU tool's own inputs
(:94-96).  The port's plain versions must equal them.  Tolerance: exact
(integer wraparound on both sides)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from masa_tpu_torch.tools import roofline as rl

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


def test_cpu_routes_to_plain_and_kernel_needs_cuda():
    xs = [torch.from_numpy(x) for x in rl.inputs("par")]
    before = rl.run_cuda.launches
    assert torch.equal(rl.run("par", xs, 3), rl.run_plain("par", xs, 3))
    assert rl.run_cuda.launches == before == 0
    with pytest.raises(ValueError, match="CUDA"):
        rl.run_cuda("par", xs, 3)
