"""The narrow K2's operand layout (``csrc/conv_narrow.cuh``, the route
``conv_route`` gives the widths TMA cannot stride), held on the CPU: the conv
as the kernels compute it, the dense im2col of x in their K order (position
j of tap (dy, dx) holding channel ``narrow_perm[j]``, K zero-padded to one
32-byte k-step) against the K-major weights of ``narrow_weights`` (Cout
zero-padded to the block's ``narrow_nb`` channels, then sliced), equals
``conv3x3_nhwc_plain`` and the JAX package's ``conv3x3_bias`` in interpret
mode at 3 -> 64, 64 -> 3, 5 -> 12 and 12 -> 5 on 16² x 2, bf16 and float32;
and the float32 route's weight split is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from st3d.kernels import conv_pallas as cp

from st3d_torch.kernels import conv as kconv

WIDTHS = [(3, 64), (64, 3), (5, 12), (12, 5)]
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _inputs(cin, cout, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, 16, 16, cin).astype(np.float32)
    w = (rng.randn(3, 3, cin, cout) * (2.0 / (9 * cin)) ** 0.5
         ).astype(np.float32)
    b = (rng.randn(cout) * 0.1).astype(np.float32)
    return x, w, b


def _narrow_conv(x, w, b):
    """The kernels' product: im2col patches in their K order times the
    narrow weights, float32 sums, bias, Cout sliced from the padded rows."""
    cin, cout = w.shape[2], w.shape[3]
    nb = kconv.narrow_nb(x.dtype, cin, cout)
    wk = kconv.narrow_weights(w, nb)
    kt = wk.shape[1]
    perm = kconv.narrow_perm(cin, x.element_size())
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    h, wd = x.shape[1], x.shape[2]
    cols = [xp[:, dy:dy + h, dx:dx + wd, :][..., perm]
            for dy in range(3) for dx in range(3)]
    patches = F.pad(torch.cat(cols, dim=-1), (0, kt - 9 * cin))
    return (patches @ wk.float().T)[..., :cout] + b.float(), wk, nb


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("cin,cout", WIDTHS)
def test_narrow_operands_give_the_conv(dtype, cin, cout):
    dt = DTYPES[dtype]
    assert kconv.conv_route(dt, cin, cout) == kconv.NARROW_ROUTES[dt]
    x, w, b = (torch.tensor(a).to(dt) for a in _inputs(cin, cout, cin))
    got, wk, nb = _narrow_conv(x, w, b)
    kstep = 32 // x.element_size()
    rows = -(-cout // nb) * nb
    assert wk.shape == (rows, -(-9 * cin // kstep) * kstep)
    assert wk.dtype == dt
    assert not wk[cout:].any() and not wk[:, 9 * cin:].any()
    ref = kconv.conv3x3_nhwc_plain(x, w, b)
    # Float32 sums in another order: a few float32 ulps of the largest
    # value; in bf16 both are compared before the output rounding.
    scale = float(ref.float().abs().max())
    tol = 1e-5 if dt == torch.float32 else 1e-2
    assert float((got.to(dt).float() - ref.float()).abs().max()) \
        <= tol * scale
    if dt == torch.float32:
        y_j = np.asarray(cp.conv3x3_bias(jnp.asarray(x.numpy()),
                                         jnp.asarray(w.numpy()),
                                         jnp.asarray(b.numpy()), True))
        np.testing.assert_allclose(got.numpy(), y_j, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("cin,esize", [(64, 2), (128, 2), (72, 2), (16, 2),
                                       (64, 4), (72, 4), (8, 4), (3, 2),
                                       (12, 4)])
def test_narrow_perm(cin, esize):
    """A permutation of the channels; where Cin fills whole k-steps, each
    full 128-byte slab is permuted so that thread t4's words of k-steps 2m
    and 2m + 1 are 16-byte chunk 2 * t4 + m of a pixel; elsewhere (a raw
    halo, a part-filled slab) the order is kept."""
    perm = kconv.narrow_perm(cin, esize).tolist()
    assert sorted(perm) == list(range(cin))
    kstep, slab = 32 // esize, 128 // esize
    if cin % kstep:
        assert perm == list(range(cin))
        return
    full = cin // slab * slab
    assert perm[full:] == list(range(full, cin))
    for base in range(0, full, slab):
        for s in range(4):
            for col in range(kstep):
                # Fragment register v = rs + 2h of lane t4 holds position
                # col = 2 t4 + 8 h + e (bf16) or t4 + 4 h (tf32).
                t4 = (col % 8) // 2 if esize == 2 else col % 4
                h = col // 8 if esize == 2 else col // 4
                e = col % 2 if esize == 2 else 0
                byte = (perm[base + kstep * s + col] - base) * esize
                assert byte // 16 == 2 * t4 + s // 2
                assert (byte % 16) // 4 == 2 * (s % 2) + h
                assert byte % 4 == e * esize


def test_tf32_split_of_narrow_weights_is_exact():
    _, w, _ = _inputs(64, 3, 1)
    wk = kconv.narrow_weights(torch.tensor(w), kconv.narrow_nb(
        torch.float32, 64, 3))
    hi, lo = kconv.split_tf32(wk)
    assert torch.equal(hi + lo, wk)
    assert not (hi.view(torch.int32) & 8191).any()
