"""K3 at the narrow widths (``csrc/gram_narrow.cu``) on the CPU: the route
rule, the slice plan, and a model of the kernel's data path against
``gram_nhwc_plain`` and a float64 Gram; then conv1_1's 27-wide PᵀP with
stage 1 off, through the port's ``get_features`` against the JAX
package's.

The model follows the kernel step by step. Each block takes one (image,
slice) of ``gram_split``'s "narrow" plan and stages its flat run of
pixels, 256 a stage, as the 16-byte-aligned chunks that cover it (the
bytes past the tensor's end are never read; the model zeroes them), so a
stage's first element sits ``shift`` bytes into its slot. Per k-step (16 pixels in bf16, 8 in float32) every lane
(g = lane // 4, t = lane % 4) gathers the B fragment of each 8-channel
column tile at p * C + k, zero past C and past the stage; the row tile m's
A fragment is column tiles 2m and 2m + 1's registers. The model scatters
the lanes' registers into the matrices by PTX ISA's fragment layouts
(m16n8k16 bf16, m16n8k8 tf32), checks that they are Yᵀ and Y, and sums
the products of the tiles the kernel computes (column tile >= 2 * row
tile), the rest read transposed. float32 takes the 3xTF32 split
(``split_tf32``; the tensor core reads lo's top 19 bits).
"""

import numpy as np
import pytest
import torch

from st3d_torch.kernels import conv as kconv

BF16, F32 = torch.bfloat16, torch.float32
TP = 256            # pixels a stage (csrc/gram_narrow.cu)
WIDTHS = (3, 5, 12, 27, 31, 33)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Route and plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("c", WIDTHS)
def test_narrow_route(dtype, c):
    """bf16 with C % 8 != 0 and float32 with C % 4 != 0 take "narrow" up to
    32, the TMA routes keep their widths, and 33 has no kernel."""
    tma = (c % 8 == 0) if dtype == BF16 else (c % 4 == 0)
    if not tma and c > kconv.NARROW_GRAM_C:
        with pytest.raises(ValueError, match=f"c={c}"):
            kconv.gram_route(dtype, c)
        return
    route = kconv.gram_route(dtype, c)
    if tma:
        assert route == ("wgmma" if dtype == BF16 else "tf32x3")
    else:
        assert route == "narrow"
        assert kconv.GRAM_LIBS[route] == "gram_narrow"


@pytest.mark.parametrize("route", sorted(kconv.GRAM_PLAN))
@pytest.mark.parametrize("bsz,pixels,c", [(4, 512 * 512, 27),
                                          (2, 36 * 36, 27), (3, 1073, 5),
                                          (1, 7, 3), (4, 256 * 256, 128)])
def test_gram_split_starts_slices_at_multiples_of_8(route, bsz, pixels, c):
    """Every slice of every route starts at a multiple of 8 pixels, so with
    P a multiple of 8 a narrow slice's run starts on a 16-byte boundary."""
    slices, slice_len = kconv.gram_split(bsz, pixels, c, route)
    assert slice_len % 8 == 0
    assert all((s * slice_len) % 8 == 0 for s in range(slices))
    assert (slices - 1) * slice_len < pixels <= slices * slice_len


def test_narrow_split_fills_the_card_at_conv1_1():
    """conv1_1's PᵀP at 512² x 4 views: two blocks an SM, each slice a few
    stages long."""
    slices, slice_len = kconv.gram_split(4, 512 * 512, 27, "narrow")
    assert 4 * slices >= 2 * kconv.SMS
    assert TP <= slice_len <= 16 * TP


# ---------------------------------------------------------------------------
# The kernel's data path
# ---------------------------------------------------------------------------

def _fragment_layouts(dtype):
    """(k-step, A's (row, col) per (reg, half, g, t), B's (k, n) per
    (reg, half, g, t)) of PTX ISA's m16n8k16 bf16 / m16n8k8 tf32."""
    g = torch.arange(32) // 4
    t = torch.arange(32) % 4
    if dtype == BF16:
        a = {(r, h): (g + 8 * (r & 1), 2 * t + h + 8 * (r >> 1))
             for r in range(4) for h in range(2)}
        b = {(r, h): (2 * t + h + 8 * r, g) for r in range(2)
             for h in range(2)}
        return 16, a, b
    a = {(r, 0): (g + 8 * (r & 1), t + 4 * (r >> 1)) for r in range(4)}
    b = {(r, 0): (t + 4 * r, g) for r in range(2)}
    return 8, a, b


def _stage(flat, es, first, q0, q1, c):
    """A stage's slot as the kernel fills it: the 16-byte chunks covering
    elements [(first + q0) * c, (first + q1) * c) of the flat bytes (zero
    past their end, where the kernel reads nothing), and the shift of its
    first element."""
    b0, b1 = (first + q0) * c * es, (first + q1) * c * es
    a0, a1 = b0 & ~15, (b1 + 15) & ~15
    slot = np.zeros(a1 - a0 + 32, np.uint8)
    part = flat[a0:min(a1, len(flat))]
    slot[:len(part)] = part
    return slot, b0 - a0


def _gather(slot, shift, dtype, c, npix, pb, b_lay):
    """The B fragment values each lane gathers at k-step pixel ``pb``:
    (n-tile, reg, half) -> (32,) float64, as the kernel reads them from the
    slot (zero past C and past the stage)."""
    np_t = np.uint16 if dtype == BF16 else np.float32
    es = 2 if dtype == BF16 else 4
    words = slot[shift:shift + (len(slot) - shift) // es * es].view(np_t)
    out = {}
    for n in range(4):
        for (r, h), (k, col) in b_lay.items():
            q = pb + k
            ch = 8 * n + col
            ok = (q < npix) & (ch < c)
            idx = torch.where(ok, q * c + ch, torch.zeros_like(q))
            raw = words[idx.numpy()]
            if dtype == BF16:
                val = torch.tensor(raw.astype(np.int32) << 16).view(
                    torch.float32)
            else:
                val = torch.tensor(raw)
            out[n, r, h] = torch.where(ok, val, torch.zeros_like(val))
    return out


def _assemble(regs, lay, rows, cols):
    """The matrix the lanes' registers hold under fragment layout ``lay``."""
    m = torch.full((rows, cols), float("nan"), dtype=torch.float64)
    for key, (r_idx, c_idx) in lay.items():
        m[r_idx, c_idx] = regs[key].double()
    assert not torch.isnan(m).any()
    return m


def emulate_gram_narrow(y):
    """The kernel's Gram of y (B, P, C): per (image, slice, stage, k-step),
    the gathered fragments assembled and checked against Yᵀ and Y, their
    products (3xTF32 for float32, each product in float64) summed in
    float64 over the computed tiles; (B, C, C) float64."""
    bsz, pixels, c = y.shape
    dtype = y.dtype
    es = 2 if dtype == BF16 else 4
    flat = (y.contiguous().view(torch.int16) if dtype == BF16
            else y.contiguous()).numpy().view(np.uint8).reshape(-1)
    step, a_lay, b_lay = _fragment_layouts(dtype)
    slices, slice_len = kconv.gram_split(bsz, pixels, c, "narrow")
    yd = y.double()
    g = torch.zeros((bsz, 32, 32), dtype=torch.float64)
    for b in range(bsz):
        for s in range(slices):
            p0, p1 = s * slice_len, min(pixels, (s + 1) * slice_len)
            for q0 in range(p0, p1, TP):
                npix = min(q0 + TP, p1) - q0
                slot, shift = _stage(flat, es, b * pixels, q0, q0 + npix, c)
                for pb in range(0, npix, step):
                    regs = _gather(slot, shift, dtype, c, npix, pb, b_lay)
                    blk = torch.zeros((step, 32), dtype=torch.float64)
                    kk = min(step, npix - pb)
                    blk[:kk, :c] = yd[b, q0 + pb:q0 + pb + kk]
                    g[b] += _tile_products(regs, a_lay, b_lay, step, blk,
                                           dtype)
    # The reduction reads a tile below the block diagonal transposed.
    i = torch.arange(32)
    computed = (i[None, :] >> 3) >= 2 * (i[:, None] >> 4)
    g = torch.where(computed, g, g.transpose(1, 2))
    return g[:, :c, :c]


def _tile_products(regs, a_lay, b_lay, step, blk, dtype):
    """One k-step's products into a 32 x 32 float64 Gram (computed tiles
    only), from the registers as the tensor cores read them; asserts that
    the raw registers hold Yᵀ (A) and Y (B) of the k-step."""
    def mats(f):
        fr = {k: f(v) for k, v in regs.items()}
        bs = [_assemble({(r, h): fr[n, r, h] for (r, h) in b_lay}, b_lay,
                        step, 8) for n in range(4)]
        As = [_assemble({(r, h): fr[2 * m + (r & 1), r >> 1, h]
                         for (r, h) in a_lay}, a_lay, 16, step)
              for m in range(2)]
        return As, bs

    xa, xb = mats(lambda v: v)
    for n in range(4):
        assert torch.equal(xb[n], blk[:, 8 * n:8 * n + 8])
    for m in range(2):
        assert torch.equal(xa[m], blk[:, 16 * m:16 * m + 16].T)
    if dtype == F32:
        ah, bh = mats(lambda v: kconv.split_tf32(v)[0])
        # The tensor core reads a tf32 operand's top 19 bits.
        al, bl = mats(lambda v: (kconv.split_tf32(v)[1].view(torch.int32)
                                 & -8192).view(torch.float32))
    out = torch.zeros((32, 32), dtype=torch.float64)
    for m in range(2):
        for n in range(2 * m, 4):
            rs, cs = slice(16 * m, 16 * m + 16), slice(8 * n, 8 * n + 8)
            if dtype == BF16:
                out[rs, cs] = xa[m] @ xb[n]
            else:
                out[rs, cs] = al[m] @ bh[n] + ah[m] @ bl[n] + ah[m] @ bh[n]
    return out


def _rel_fro(got, ref):
    return float(torch.linalg.norm((got.double() - ref.double()).flatten())
                 / torch.linalg.norm(ref.double().flatten()))


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("bsz,pixels,c", [(2, 1073, 27), (1, 600, 5),
                                          (3, 300, 31), (1, 520, 13),
                                          (2, 129, 3)])
def test_gather_and_split_model_matches_plain_and_float64(dtype, bsz,
                                                          pixels, c):
    """The model's Gram equals the plain version within the kernel's
    tolerance (1e-3 bf16, 1e-5 float32, relative Frobenius) and lies
    within 1e-5 of a float64 Gram of the stored values. Pixel counts off
    the multiples of 8 put stages at every 16-byte shift."""
    assert kconv.gram_route(dtype, c) == "narrow"
    rng = np.random.RandomState(c)
    y = torch.tensor(np.maximum(rng.randn(bsz, pixels, c), 0.0)
                     .astype(np.float32)).to(dtype)
    got = emulate_gram_narrow(y)
    plain = kconv.gram_nhwc_plain(y)
    f64 = torch.matmul(y.double().transpose(1, 2), y.double())
    assert _rel_fro(got, plain) <= (1e-3 if dtype == BF16 else 1e-5)
    assert _rel_fro(got, f64) <= 1e-5


def test_stage_chunks_cover_every_shift():
    """A stage's slot holds its elements at ``shift`` for every start
    offset mod 16."""
    for es in (2, 4):
        for c in (3, 5, 27, 31):
            total = 5 * 37 * c * es
            flat = (np.arange(total) % 251 + 1).astype(np.uint8)
            for first in range(0, 37 * 5, 37):
                for q0 in range(0, 37, 5):
                    q1 = min(37, q0 + 11)
                    slot, shift = _stage(flat, es, first, q0, q1, c)
                    lo, hi = (first + q0) * c * es, (first + q1) * c * es
                    assert np.array_equal(slot[shift:shift + hi - lo],
                                          flat[lo:hi])
                    assert shift % es == 0 and 0 <= shift < 16


# ---------------------------------------------------------------------------
# conv1_1's PᵀP with stage 1 off, against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", [32, 36])
def test_conv1_1_gram_with_stage1_off_matches_jax(size, monkeypatch):
    """``get_features(gram1=True)`` with stage 1 off (ST3D_NO_STAGE1_V2=1;
    at 36² H is not a multiple of 8 as well): conv1_1's Gram through the
    27-wide PᵀP, and every output the two share, within the VGG parity
    tests' tolerance (rtol 1e-4, atol 1e-4 * max) of the JAX package's (on
    the CPU it exports the other style taps, not their Grams)."""
    import jax.numpy as jnp

    import st3d.models.vgg as jvgg

    from st3d_torch.convert import vgg19_from_numpy
    from st3d_torch.models import vgg as tvgg

    monkeypatch.setenv("ST3D_NO_STAGE1_V2", "1")
    jm = jvgg.init_random_vgg19(0)
    tm = vgg19_from_numpy([np.asarray(k) for k in jm.kernels],
                          [np.asarray(b) for b in jm.biases])
    img = np.random.RandomState(7).rand(2, size, size, 3).astype(np.float32)
    want = jvgg.get_features(jnp.asarray(img), jm, layout="NHWC",
                             input_layout="NHWC", gram1=True)
    got = tvgg.get_features(torch.tensor(img), tm, layout="NHWC",
                            input_layout="NHWC", gram1=True)
    shared = set(got) & set(want)
    assert {"conv1_1:gram", "conv4_2"} <= shared
    for k in sorted(shared):
        w = np.asarray(want[k])
        g = got[k].detach().numpy()
        assert g.shape == w.shape, k
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-4 * max(1.0, np.abs(w).max()),
                                   err_msg=k)
