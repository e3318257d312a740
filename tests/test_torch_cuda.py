"""CUDA twins of the kernel checks: each hand-written kernel against its
plain version on the card, at small shapes. Skipped without a GPU; run
them on one with ``python -m pytest tests/test_torch_cuda.py -q``
(``chip_smoke.py`` repeats the checks at the main path's shapes)."""

import numpy as np
import pytest
import torch

from st3d_torch.kernels import conv as kconv
from st3d_torch.kernels import raster as kraster

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif("not torch.cuda.is_available()",
                       reason="needs an NVIDIA GPU"),
]


@pytest.fixture
def dev():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def test_raster_kernel_equals_plain(dev):
    from st3d_torch.core.cameras import build_fixed_cameras
    from st3d_torch.core.primitives import ico_sphere
    from st3d_torch.render.rasterize import face_verts_screen

    mesh = ico_sphere(level=3).to(dev)
    fv = face_verts_screen(mesh.verts, mesh.faces,
                           build_fixed_cameras(3, seed=1).to(dev), 96)
    coeffs, bounds, _ = kraster.preprocess(fv)
    n0 = kraster.LAUNCHES["raster_hard"]
    p2f, zbuf = kraster.raster_hard(coeffs, bounds, 96, 96)
    torch.cuda.synchronize()
    assert kraster.LAUNCHES["raster_hard"] == n0 + 1
    p_ref, z_ref = kraster.raster_hard_plain(coeffs, bounds, 96, 96)
    assert torch.equal(p2f, p_ref)
    torch.testing.assert_close(zbuf, z_ref, rtol=1e-6, atol=0)


CONV_KEYS = {"wgmma": "conv3x3_wgmma", "tf32x3": "conv3x3_tf32x3",
             "narrow_wgmma": "conv3x3_narrow_wgmma",
             "narrow_tf32x3": "conv3x3_narrow_tf32x3"}
POOL_KEYS = {"wgmma": "pool_route_wgmma", "tf32x3": "pool_route_tf32x3"}
RELU_POOL_KEYS = {"wgmma": "conv3x3_relu_pool_wgmma",
                  "tf32x3": "conv3x3_relu_pool_tf32x3"}
GRAM_KEYS = {"wgmma": "gram_wgmma", "tf32x3": "gram_tf32x3",
             "narrow": "gram_narrow"}


def _launched(n0):
    return {k: v - n0[k] for k, v in kconv.LAUNCHES.items() if v != n0[k]}


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 1e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("cin,cout,relu", [(16, 64, False), (64, 32, True),
                                           (3, 64, False)])
def test_conv_kernel_matches_plain(dev, dtype, tol, cin, cout, relu):
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((2, 24, 20, cin), generator=g, device=dev).to(dtype)
    w = (torch.randn((3, 3, cin, cout), generator=g, device=dev)
         * 0.2).to(dtype)
    b = torch.randn((cout,), generator=g, device=dev).to(dtype)
    key = CONV_KEYS[kconv.conv_route(dtype, cin, cout)]
    n0 = dict(kconv.LAUNCHES)
    y = kconv.conv3x3_nhwc(x, w, b, relu)
    ref = kconv.conv3x3_nhwc_plain(x, w, b, relu)
    torch.cuda.synchronize()
    assert {k: v - n0[k] for k, v in kconv.LAUNCHES.items() if v != n0[k]} \
        == {key: 1}
    assert y.dtype == dtype
    err = (y.float() - ref.float()).abs().max()
    assert err <= tol * ref.float().abs().max()


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 1e-3),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("pixels,c", [(37 * 29, 64), (4096, 27), (64, 512)])
def test_gram_kernel_matches_plain(dev, dtype, tol, pixels, c):
    g = torch.Generator(device=dev).manual_seed(1)
    y = torch.randn((3, pixels, c), generator=g, device=dev).to(dtype)
    key = GRAM_KEYS[kconv.gram_route(dtype, c)]
    n0 = dict(kconv.LAUNCHES)
    got = kconv.gram_nhwc(y)
    ref = kconv.gram_nhwc_plain(y)
    torch.cuda.synchronize()
    assert {k: v - n0[k] for k, v in kconv.LAUNCHES.items() if v != n0[k]} \
        == {key: 1}
    assert torch.linalg.norm(got - ref) <= tol * torch.linalg.norm(ref)
    assert torch.equal(got, kconv.gram_nhwc(y))      # deterministic


# The tensor-core K2 at W 4, 8, 20, 32, 64 and 128 (``conv_tile``'s boxes
# 4 x 32 .. 128 x 1; both dtypes take ``tf32x3_tile``'s, listed below, 4 x
# 32 at W = 20), H not a multiple of the box height
# and H below it (the box runs past the image), Cin below and past one
# 64-channel slab, and Cout = 64 (BN = 64) on the forward or the dx side.
WGMMA_CONVS = [((2, 6, 4), 16, 64), ((1, 20, 8), 64, 64),
               ((2, 24, 20), 40, 24), ((2, 9, 32), 128, 64),
               ((1, 5, 64), 64, 128), ((1, 3, 128), 256, 128)]


@pytest.mark.parametrize("shape,cin,cout", WGMMA_CONVS)
@pytest.mark.parametrize("relu", [False, True])
def test_conv_wgmma_matches_plain(dev, shape, cin, cout, relu):
    """Forward and input gradient through ``conv3x3_nhwc`` in bf16, both on
    the tensor-core kernel, against the plain versions: max-abs error <=
    1e-2 * max|plain| (bf16 output rounding; the sums differ in order)."""
    g = torch.Generator(device=dev).manual_seed(14)
    x = torch.randn(shape + (cin,), generator=g, device=dev).bfloat16()
    w = (torch.randn((3, 3, cin, cout), generator=g, device=dev)
         * (2.0 / (9 * cin)) ** 0.5).bfloat16()
    b = (torch.randn((cout,), generator=g, device=dev) * 0.1).bfloat16()
    ct = torch.randn(shape + (cout,), generator=g, device=dev).bfloat16()
    n0 = dict(kconv.LAUNCHES)
    y = kconv.conv3x3_nhwc(x, w, b, relu)
    dx = kconv._transpose_conv(ct, w)
    torch.cuda.synchronize()
    assert {k: v - n0[k] for k, v in kconv.LAUNCHES.items() if v != n0[k]} \
        == {"conv3x3_wgmma": 2}
    zb = torch.zeros(cin, dtype=torch.bfloat16, device=dev)
    refs = (kconv.conv3x3_nhwc_plain(x, w, b, relu),
            kconv.conv3x3_nhwc_plain(
                ct, kconv.transpose_weights(w, torch.bfloat16), zb))
    for got, ref in zip((y, dx), refs):
        assert got.shape == ref.shape and got.dtype == torch.bfloat16
        assert _rel_err(got, ref) <= 1e-2


# The bf16 K2's persistent schedule on ``kconv.k2_plan``'s tiles: the
# least-padding boxes of 192-, 96- and 48-wide layers (64 x 2, 32 x 4, 16 x
# 8; the last with BN = 256 over 72 tiles, where BN = 128 would take 144);
# one tile; fewer tiles than SMs (8); 133 = 132 + 1 tiles in the forward,
# the dx and C (one CTA walks two); BN = 256 with Cout = 384 (the second
# channel tile half past Cout, 132 tiles) and C over 198 tiles. (B, H, W),
# Cin, Cout, the forward's box width and BN.
K2_PLANS = [((1, 4, 192), 64, 128, 64, 128), ((2, 8, 96), 128, 256, 32, 128),
            ((2, 48, 48), 512, 512, 16, 256), ((1, 8, 16), 64, 64, 16, 64),
            ((2, 16, 32), 64, 128, 32, 128), ((1, 266, 64), 16, 64, 64, 64),
            ((1, 132, 64), 64, 384, 64, 256)]


@pytest.mark.parametrize("shape,cin,cout,bw,bn", K2_PLANS)
def test_conv_wgmma_persistent_matches_plain(dev, shape, cin, cout, bw, bn):
    """Forward, input gradient and C (the pool epilogue) in bf16 on the
    persistent tensor-core kernel against the plain versions: max-abs error
    <= 1e-2 * max|plain|, C's idx equal wherever the plain top two of the
    window differ by more than that; one launch of each key a call."""
    assert kconv.k2_plan(*shape, cout)[:2] == (bw, bn)
    g = torch.Generator(device=dev).manual_seed(26)
    x = torch.randn(shape + (cin,), generator=g, device=dev).bfloat16()
    w = (torch.randn((3, 3, cin, cout), generator=g, device=dev)
         * (2.0 / (9 * cin)) ** 0.5).bfloat16()
    b = (torch.randn((cout,), generator=g, device=dev) * 0.1).bfloat16()
    ct = torch.randn(shape + (cout,), generator=g, device=dev).bfloat16()
    n0 = dict(kconv.LAUNCHES)
    y = kconv.conv3x3_nhwc(x, w, b, True)
    dx = kconv._transpose_conv(ct, w)
    torch.cuda.synchronize()
    assert _launched(n0) == {"conv3x3_wgmma": 2}
    zb = torch.zeros(cin, dtype=torch.bfloat16, device=dev)
    pre = kconv.conv3x3_nhwc_plain(x, w, b, True)
    refs = (pre, kconv.conv3x3_nhwc_plain(
        ct, kconv.transpose_weights(w, torch.bfloat16), zb))
    for got, ref in zip((y, dx), refs):
        assert got.shape == ref.shape and got.dtype == torch.bfloat16
        assert _rel_err(got, ref) <= 1e-2
    n0 = dict(kconv.LAUNCHES)
    p, idx = kconv.conv3x3_relu_pool(x, w, b)
    torch.cuda.synchronize()
    assert _launched(n0) == {"conv3x3_relu_pool_wgmma": 1}
    p_ref, idx_ref = kconv.conv3x3_relu_pool_plain(x, w, b)
    assert p.shape == p_ref.shape and _rel_err(p, p_ref) <= 1e-2
    scale = float(p_ref.float().abs().max())
    assert _idx_mismatch_where_separated(idx, idx_ref, pre, 1e-2 * scale) == 0


@pytest.mark.parametrize("shape,cin,cout", [((2, 48, 48), 512, 512),
                                            ((1, 20, 24), 64, 384)])
def test_conv_wgmma_bits_do_not_depend_on_the_plan(dev, shape, cin, cout):
    """Each output sums its products in one accumulator in the same order
    whatever the tile: every box (BW 1 .. 128) and BN (64, 128, 256) gives
    the wrapper's output bit for bit."""
    g = torch.Generator(device=dev).manual_seed(27)
    x = torch.randn(shape + (cin,), generator=g, device=dev).bfloat16()
    w = (torch.randn((3, 3, cin, cout), generator=g, device=dev)
         * (2.0 / (9 * cin)) ** 0.5).bfloat16()
    b = (torch.randn((cout,), generator=g, device=dev) * 0.1).bfloat16()
    want = kconv.conv3x3_nhwc(x, w, b)
    wk = w.permute(3, 0, 1, 2).contiguous()
    fn = kconv.build.symbol("conv3x3_wgmma", "st3d_conv3x3_wgmma_bf16", 4, 8)
    for bw in (1 << k for k in range(8)):
        for bn in (64, 128, 256):
            y = torch.full_like(want, float("nan"))
            err = fn(x.data_ptr(), wk.data_ptr(), b.data_ptr(), y.data_ptr(),
                     *shape, cin, cout, bw, bn, 0,
                     kconv.build.stream_handle(x.device))
            assert err == 0
            assert torch.equal(y, want), (bw, bn)


# The same shapes in float32 (boxes of ``kconv.tf32x3_tile``: 4 x 32, 8 x
# 16, 32 x 4, 64 x 2 and 128 x 1), plus W = 1 and 2 (boxes 1 x 128 and 2 x
# 64) and Cin = 4, the narrowest the 3xTF32 route takes; then the edges of
# the persistent schedule (min(tiles, 132) CTAs): one tile (8 x 8), 3
# pixel tiles, 132 tiles (one a CTA) and 144 (conv5_1 at 48² x 2, boxes 16
# x 8: 12 CTAs walk two), and Cout a multiple of 4 but not of BN (20 and
# 100: B's box runs past Cout; 200: a partial second channel tile).
TF32X3_CONVS = WGMMA_CONVS + [
    ((1, 7, 1), 4, 8), ((2, 5, 2), 8, 4), ((1, 8, 8), 64, 64),
    ((1, 40, 8), 64, 64), ((2, 132, 64), 16, 64), ((2, 48, 48), 512, 512),
    ((1, 9, 32), 64, 20), ((1, 24, 20), 40, 100), ((1, 9, 32), 64, 200)]


def _conv_f64(x, w, b, relu):
    y = torch.nn.functional.conv2d(
        x.double().permute(0, 3, 1, 2), w.double().permute(3, 2, 0, 1),
        b.double(), padding=1).permute(0, 2, 3, 1)
    return torch.relu(y) if relu else y


@pytest.mark.parametrize("shape,cin,cout", TF32X3_CONVS)
@pytest.mark.parametrize("relu", [False, True])
def test_conv_tf32x3_matches_plain(dev, shape, cin, cout, relu):
    """Forward and input gradient through ``conv3x3_nhwc`` in float32, both
    on the 3xTF32 kernel: max-abs error <= 1e-4 * max|plain| against the
    plain versions (the f32 tolerance of ``chip_smoke.py``) and <= 1e-5 *
    max against a float64 conv (the split leaves ~4e-7, one TF32 product
    ~3e-4: tests/test_torch_tf32x3.py; the kernel's per-iteration partial
    sums keep the tensor core's truncating adds off the running sum)."""
    g = torch.Generator(device=dev).manual_seed(16)
    x = torch.randn(shape + (cin,), generator=g, device=dev)
    w = torch.randn((3, 3, cin, cout), generator=g, device=dev) * (
        2.0 / (9 * cin)) ** 0.5
    b = torch.randn((cout,), generator=g, device=dev) * 0.1
    ct = torch.randn(shape + (cout,), generator=g, device=dev)
    n0 = dict(kconv.LAUNCHES)
    y = kconv.conv3x3_nhwc(x, w, b, relu)
    dx = kconv._transpose_conv(ct, w)
    torch.cuda.synchronize()
    assert _launched(n0) == {"conv3x3_tf32x3": 2}
    wt = kconv.transpose_weights(w, torch.float32)
    zb = torch.zeros(cin, device=dev)
    for got, args in ((y, (x, w, b, relu)), (dx, (ct, wt, zb, False))):
        assert got.shape == args[0].shape[:3] + (args[1].shape[3],)
        assert got.dtype == torch.float32
        assert _rel_err(got, kconv.conv3x3_nhwc_plain(*args)) <= 1e-4
        assert _rel_err(got, _conv_f64(*args)) <= 1e-5


@pytest.mark.parametrize("shape,cin,cout", TF32X3_CONVS)
def test_conv_tf32x3_bit_equal_on_exact_data(dev, shape, cin, cout):
    """x and the cotangent in quarters, w and b in eighths (small integers
    times powers of two, exact in TF32, so every lo part is zero and every
    sum exact in float32, in any order): the forward with ReLU and the
    input gradient equal the plain versions bit for bit, and a second
    call."""
    g = torch.Generator(device=dev).manual_seed(23)

    def grid(size, lo, hi, unit):
        return torch.randint(lo, hi + 1, size, generator=g,
                             device=dev).float() * unit

    x = grid(shape + (cin,), -3, 3, 0.25)
    w = grid((3, 3, cin, cout), -4, 4, 0.125)
    b = grid((cout,), -4, 4, 0.125)
    ct = grid(shape + (cout,), -3, 3, 0.25)
    n0 = dict(kconv.LAUNCHES)
    y = kconv.conv3x3_nhwc(x, w, b, True)
    dx = kconv._transpose_conv(ct, w)
    torch.cuda.synchronize()
    assert _launched(n0) == {"conv3x3_tf32x3": 2}
    ref = kconv.conv3x3_nhwc_plain(x, w, b, True)
    assert bool((ref == 0).any()) and bool((ref > 0).any())
    assert torch.equal(y, ref)
    assert torch.equal(dx, kconv.conv3x3_nhwc_plain(
        ct, kconv.transpose_weights(w, torch.float32),
        torch.zeros(cin, device=dev)))
    assert torch.equal(kconv.conv3x3_nhwc(x, w, b, True), y)


@pytest.mark.parametrize("pixels,c", [(37 * 29, 64), (1000, 128),
                                      (4096 + 17, 512), (300, 136)])
def test_gram_wgmma_matches_plain(dev, pixels, c):
    """The tensor-core K3 in bf16 (pixel counts off the 64-pixel box, C
    below, at and between 128-channel tiles) against its plain version:
    relative Frobenius error <= 1e-3, bit-identical on a second call."""
    g = torch.Generator(device=dev).manual_seed(15)
    y = torch.randn((3, pixels, c), generator=g, device=dev).bfloat16()
    n0 = dict(kconv.LAUNCHES)
    got = kconv.gram_nhwc(y)
    again = kconv.gram_nhwc(y)
    torch.cuda.synchronize()
    assert {k: v - n0[k] for k, v in kconv.LAUNCHES.items() if v != n0[k]} \
        == {"gram_wgmma": 2}
    ref = kconv.gram_nhwc_plain(y)
    assert torch.linalg.norm(got - ref) <= 1e-3 * torch.linalg.norm(ref)
    assert torch.equal(got, again)                    # deterministic


def test_conv_gram_gradient_matches_plain_path(dev):
    """The autograd functions on CUDA tensors (kernels) against the same
    functions on CPU copies (plain versions), float32."""
    rng = np.random.RandomState(2)
    x = rng.randn(2, 16, 16, 32).astype(np.float32)
    w = (rng.randn(3, 3, 32, 64) * 0.1).astype(np.float32)
    b = (rng.randn(64) * 0.1).astype(np.float32)
    ct = rng.randn(2, 16, 16, 64).astype(np.float32)
    ctg = (rng.randn(2, 64, 64) * 1e-2).astype(np.float32)
    grads = []
    for d in (dev, torch.device("cpu")):
        xt = torch.tensor(x, device=d, requires_grad=True)
        y, gm = kconv.conv3x3_bias_gram(xt, torch.tensor(w, device=d),
                                        torch.tensor(b, device=d))
        torch.autograd.backward((y, gm), (torch.tensor(ct, device=d),
                                          torch.tensor(ctg, device=d)))
        grads.append(xt.grad.cpu())
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# Stage 1 and the packed pool: kernels A (conv1_1_stats), B (conv1_1_bwd),
# C (conv3x3_relu_pool) and D (pool_route_conv3x3_bwd)
# ---------------------------------------------------------------------------

def _rel_err(got, ref):
    """max|got - ref| / max|ref|."""
    return float((got.float() - ref.float()).abs().max()
                 / ref.float().abs().max())


C11_KEYS = {"wgmma": ("conv1_1_stats_wgmma", "conv1_1_bwd_wgmma"),
            "tf32x3": ("conv1_1_stats_tf32x3", "conv1_1_bwd_tf32x3")}


def _s1_launched(n0):
    from st3d_torch.kernels import stage1 as ks1

    return {k: v - n0[k] for k, v in ks1.LAUNCHES.items() if v != n0[k]}


def _idx_mismatch_where_separated(idx, idx_ref, pre_pool, tol):
    """idx cells that differ where the top two of the window (plain
    pre-pool values) are more than ``tol`` apart."""
    bsz, h, wd, c = pre_pool.shape
    win = pre_pool.float().reshape(bsz, h // 2, 2, wd // 2, 2, c)
    win = win.permute(0, 1, 3, 5, 2, 4).reshape(bsz, h // 2, wd // 2, c, 4)
    top2 = win.sort(dim=-1).values[..., -2:]
    separated = (top2[..., 1] - top2[..., 0]) > tol
    assert separated.float().mean() > 0.5
    return int(((idx != idx_ref) & separated).sum())


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 1e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("shape", [(2, 24, 40), (1, 37, 19)])
def test_conv1_1_stats_kernel_matches_plain(dev, dtype, tol, shape):
    from st3d_torch.kernels import stage1 as ks1

    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.rand(shape + (3,), generator=g, device=dev).to(dtype)
    w = (torch.randn((3, 3, 3, 64), generator=g, device=dev) * 0.3).to(dtype)
    b = (torch.randn((64,), generator=g, device=dev) * 0.1).to(dtype)
    key = C11_KEYS[ks1.c11_route(dtype, 64)][0]
    n0 = dict(ks1.LAUNCHES)
    z, ptp, s27 = ks1.conv1_1_stats(x, w, b)
    z_p, ptp_p, s27_p = ks1.conv1_1_stats_plain(x, w, b)
    torch.cuda.synchronize()
    assert _s1_launched(n0) == {key: 1}
    assert z.dtype == dtype and ptp.dtype == s27.dtype == torch.float32
    assert _rel_err(z, z_p) <= tol
    for got, ref in ((ptp, ptp_p), (s27, s27_p)):
        assert torch.linalg.norm(got - ref) <= 1e-4 * torch.linalg.norm(ref)
    again = ks1.conv1_1_stats(x, w, b)                  # deterministic sums
    assert torch.equal(again[1], ptp) and torch.equal(again[2], s27)


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 1e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("shape", [(2, 24, 40), (1, 37, 19)])
def test_conv1_1_bwd_kernel_matches_plain(dev, dtype, tol, shape):
    from st3d_torch.kernels import stage1 as ks1

    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.rand(shape + (3,), generator=g, device=dev).to(dtype)
    w = (torch.randn((3, 3, 3, 64), generator=g, device=dev) * 0.3).to(dtype)
    b = (torch.randn((64,), generator=g, device=dev) * 0.1).to(dtype)
    z = ks1.conv1_1_stats_plain(x, w, b)[0]
    dz = torch.randn(z.shape, generator=g, device=dev).to(dtype)
    dg = torch.randn((shape[0], 27, 27), generator=g, device=dev) * 1e-2
    sym = dg + dg.transpose(1, 2)
    ds = torch.randn((shape[0], 27), generator=g, device=dev) * 1e-2
    key = C11_KEYS[ks1.c11_route(dtype, 64)][1]
    n0 = dict(ks1.LAUNCHES)
    dx = ks1.conv1_1_bwd(x, dz, z, w, sym, ds)
    ref = ks1.conv1_1_bwd_plain(x, dz, z, w, sym, ds)
    torch.cuda.synchronize()
    assert _s1_launched(n0) == {key: 1}
    assert dx.dtype == dtype and _rel_err(dx, ref) <= tol


# A and B on their bf16 tensor-core route: ragged tiles (37 x 29 leaves
# A's 32 x 4 tiles 3 pixels wide and 1 high at the edge, and B's 22 x 14
# tiles 7 wide and 9 high), Cout below one 64-channel chunk (8, 40), one
# chunk (64) and several (72, 128), and at 4 x 128 x 136 more tiles than
# blocks, so that each persistent block walks several tiles (B across
# images and through both stages); the data exact (x in quarters, weights
# and dz in eighths, S in 64ths), so every sum is exact in float32 in any
# order and the kernels must equal the plain versions bit for bit, ReLU
# boundary and bias included; then random data within one bf16 step.
C11_SHAPES = [(2, 16, 16), (1, 24, 40), (1, 37, 29), (3, 64, 48),
              (4, 128, 136)]
C11_COUTS = [64, 8, 40, 72, 128]


def _c11_exact(dev, seed, shape, cout):
    g = torch.Generator(device=dev).manual_seed(seed)

    def grid(size, lo, hi, unit):
        return (torch.randint(lo, hi + 1, size, generator=g, device=dev)
                .float() * unit).to(torch.bfloat16)

    return (grid(shape + (3,), 0, 3, 0.25),
            grid((3, 3, 3, cout), -4, 4, 0.125),
            grid((cout,), -4, 4, 0.125))


@pytest.mark.parametrize("cout", C11_COUTS)
@pytest.mark.parametrize("shape", C11_SHAPES)
def test_conv1_1_stats_wgmma_bit_equal_on_exact_data(dev, shape, cout):
    from st3d_torch.kernels import stage1 as ks1

    x, w, b = _c11_exact(dev, 21, shape, cout)
    n0 = dict(ks1.LAUNCHES)
    got = ks1.conv1_1_stats(x, w, b)
    torch.cuda.synchronize()
    assert _s1_launched(n0) == {"conv1_1_stats_wgmma": 1}
    ref = ks1.conv1_1_stats_plain(x, w, b)
    assert bool((ref[0] == 0).any()) and bool((ref[0] > 0).any())
    for a, r in zip(got, ref):
        assert a.dtype == r.dtype and torch.equal(a, r)
    again = ks1.conv1_1_stats(x, w, b)                  # deterministic sums
    assert all(torch.equal(a, r) for a, r in zip(again, got))


@pytest.mark.parametrize("cout", C11_COUTS)
@pytest.mark.parametrize("shape", C11_SHAPES)
def test_conv1_1_bwd_wgmma_bit_equal_on_exact_data(dev, shape, cout):
    from st3d_torch.kernels import stage1 as ks1

    x, w, b = _c11_exact(dev, 22, shape, cout)
    g = torch.Generator(device=dev).manual_seed(23)
    z = ks1.conv1_1_stats_plain(x, w, b)[0]
    dz = (torch.randint(-4, 5, z.shape, generator=g, device=dev).float()
          / 8).to(torch.bfloat16)
    dg = torch.randint(-8, 9, (shape[0], 27, 27), generator=g,
                       device=dev).float() / 64
    ds = torch.randint(-8, 9, (shape[0], 27), generator=g,
                       device=dev).float() / 64
    sym = dg + dg.transpose(1, 2)
    n0 = dict(ks1.LAUNCHES)
    dx = ks1.conv1_1_bwd(x, dz, z, w, sym, ds)
    torch.cuda.synchronize()
    assert _s1_launched(n0) == {"conv1_1_bwd_wgmma": 1}
    ref = ks1.conv1_1_bwd_plain(x, dz, z, w, sym, ds)
    assert dx.dtype == torch.bfloat16 and torch.equal(dx, ref)
    # Each term matters: without S, or without ds27, dx moves.
    for s_, d_ in ((torch.zeros_like(sym), ds), (sym, torch.zeros_like(ds))):
        assert not torch.equal(ks1.conv1_1_bwd_plain(x, dz, z, w, s_, d_),
                               ref)
    assert torch.equal(ks1.conv1_1_bwd(x, dz, z, w, sym, ds), dx)


def _within_one_bf16_step(got, ref):
    ref = ref.float()
    err = (got.float() - ref).abs()
    return bool((err <= 2 ** -7 * ref.abs()
                 + 1e-5 * float(ref.abs().max())).all())


@pytest.mark.parametrize("cout", [64, 128])
@pytest.mark.parametrize("shape", C11_SHAPES)
def test_conv1_1_wgmma_within_one_bf16_step_on_random_data(dev, shape, cout):
    """Random x, weights, dz and float32 S (split into bf16 hi + lo by the
    wrapper): z and dx within one bf16 step of the plain versions (both
    round float32 sums taken in different orders) plus 1e-5 of the
    largest value; PᵀP and s27 within 1e-5 relative Frobenius."""
    from st3d_torch.kernels import stage1 as ks1

    g = torch.Generator(device=dev).manual_seed(24)
    bf = torch.bfloat16
    x = torch.rand(shape + (3,), generator=g, device=dev).to(bf)
    w = (torch.randn((3, 3, 3, cout), generator=g, device=dev)
         * (2.0 / 27) ** 0.5).to(bf)
    b = (0.1 * torch.randn((cout,), generator=g, device=dev)).to(bf)
    z, ptp, s27 = ks1.conv1_1_stats(x, w, b)
    z_p, ptp_p, s27_p = ks1.conv1_1_stats_plain(x, w, b)
    assert _within_one_bf16_step(z, z_p)
    for got, ref in ((ptp, ptp_p), (s27, s27_p)):
        assert torch.linalg.norm(got - ref) <= 1e-5 * torch.linalg.norm(ref)
    dz = torch.randn(z.shape, generator=g, device=dev).to(bf)
    dg = torch.randn((shape[0], 27, 27), generator=g, device=dev) * 1e-2
    ds = torch.randn((shape[0], 27), generator=g, device=dev) * 1e-2
    sym = dg + dg.transpose(1, 2)
    dx = ks1.conv1_1_bwd(x, dz, z_p, w, sym, ds)
    assert _within_one_bf16_step(
        dx, ks1.conv1_1_bwd_plain(x, dz, z_p, w, sym, ds))


# A and B on their float32 tensor-core route (3xTF32), on C11_SHAPES with
# Cout from 8 to the route's cap of 64 (20 fills part of one 32-channel
# slab, 40 and 60 part of a second): on exact data (x in quarters, weights
# and dz in eighths, S and ds27 in 64ths, all exact in TF32, so every lo
# part is zero and every sum exact in float32) the kernels equal the plain
# versions bit for bit; on random data z and dx lie within 1e-4 of the
# largest value, PᵀP and s27 within 1e-4 relative Frobenius.
C11_TF32_COUTS = [64, 8, 20, 40, 60]


def _c11_exact_f32(dev, seed, shape, cout):
    return tuple(t.float() for t in _c11_exact(dev, seed, shape, cout))


@pytest.mark.parametrize("cout", C11_TF32_COUTS)
@pytest.mark.parametrize("shape", C11_SHAPES)
def test_conv1_1_stats_tf32x3_bit_equal_on_exact_data(dev, shape, cout):
    from st3d_torch.kernels import stage1 as ks1

    x, w, b = _c11_exact_f32(dev, 31, shape, cout)
    assert ks1.c11_route(torch.float32, cout) == "tf32x3"
    n0 = dict(ks1.LAUNCHES)
    got = ks1.conv1_1_stats(x, w, b)
    torch.cuda.synchronize()
    assert _s1_launched(n0) == {"conv1_1_stats_tf32x3": 1}
    ref = ks1.conv1_1_stats_plain(x, w, b)
    assert bool((ref[0] == 0).any()) and bool((ref[0] > 0).any())
    for a, r in zip(got, ref):
        assert a.dtype == r.dtype == torch.float32 and torch.equal(a, r)
    again = ks1.conv1_1_stats(x, w, b)                  # deterministic sums
    assert all(torch.equal(a, r) for a, r in zip(again, got))


@pytest.mark.parametrize("cout", C11_TF32_COUTS)
@pytest.mark.parametrize("shape", C11_SHAPES)
def test_conv1_1_bwd_tf32x3_bit_equal_on_exact_data(dev, shape, cout):
    from st3d_torch.kernels import stage1 as ks1

    x, w, b = _c11_exact_f32(dev, 32, shape, cout)
    g = torch.Generator(device=dev).manual_seed(33)
    z = ks1.conv1_1_stats_plain(x, w, b)[0]
    dz = torch.randint(-4, 5, z.shape, generator=g, device=dev).float() / 8
    dg = torch.randint(-8, 9, (shape[0], 27, 27), generator=g,
                       device=dev).float() / 64
    ds = torch.randint(-8, 9, (shape[0], 27), generator=g,
                       device=dev).float() / 64
    sym = dg + dg.transpose(1, 2)
    n0 = dict(ks1.LAUNCHES)
    dx = ks1.conv1_1_bwd(x, dz, z, w, sym, ds)
    torch.cuda.synchronize()
    assert _s1_launched(n0) == {"conv1_1_bwd_tf32x3": 1}
    ref = ks1.conv1_1_bwd_plain(x, dz, z, w, sym, ds)
    assert dx.dtype == torch.float32 and torch.equal(dx, ref)
    # Each term matters: without S, or without ds27, dx moves.
    for s_, d_ in ((torch.zeros_like(sym), ds), (sym, torch.zeros_like(ds))):
        assert not torch.equal(ks1.conv1_1_bwd_plain(x, dz, z, w, s_, d_),
                               ref)
    assert torch.equal(ks1.conv1_1_bwd(x, dz, z, w, sym, ds), dx)


@pytest.mark.parametrize("cout", [64, 20])
@pytest.mark.parametrize("shape", C11_SHAPES)
def test_conv1_1_tf32x3_within_1e4_on_random_data(dev, shape, cout):
    from st3d_torch.kernels import stage1 as ks1

    g = torch.Generator(device=dev).manual_seed(34)
    x = torch.rand(shape + (3,), generator=g, device=dev)
    w = torch.randn((3, 3, 3, cout), generator=g, device=dev) * (2 / 27) ** .5
    b = 0.1 * torch.randn((cout,), generator=g, device=dev)
    n0 = dict(ks1.LAUNCHES)
    z, ptp, s27 = ks1.conv1_1_stats(x, w, b)
    z_p, ptp_p, s27_p = ks1.conv1_1_stats_plain(x, w, b)
    assert _rel_err(z, z_p) <= 1e-4
    for got, ref in ((ptp, ptp_p), (s27, s27_p)):
        assert torch.linalg.norm(got - ref) <= 1e-4 * torch.linalg.norm(ref)
    again = ks1.conv1_1_stats(x, w, b)                  # deterministic sums
    assert torch.equal(again[1], ptp) and torch.equal(again[2], s27)
    dz = torch.randn(z.shape, generator=g, device=dev)
    dg = torch.randn((shape[0], 27, 27), generator=g, device=dev) * 1e-2
    ds = torch.randn((shape[0], 27), generator=g, device=dev) * 1e-2
    sym = dg + dg.transpose(1, 2)
    dx = ks1.conv1_1_bwd(x, dz, z_p, w, sym, ds)
    torch.cuda.synchronize()
    assert _rel_err(dx, ks1.conv1_1_bwd_plain(x, dz, z_p, w, sym, ds)) \
        <= 1e-4
    assert _s1_launched(n0) == {"conv1_1_stats_tf32x3": 2,
                                "conv1_1_bwd_tf32x3": 1}


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 1e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("shape,cout", [((2, 24, 40, 64), 64),
                                        ((1, 18, 26, 24), 40)])
def test_conv3x3_relu_pool_kernel_matches_plain(dev, dtype, tol, shape, cout):
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(shape, generator=g, device=dev).to(dtype)
    w = (torch.randn((3, 3, shape[3], cout), generator=g, device=dev)
         * (2.0 / (9 * shape[3])) ** 0.5).to(dtype)
    b = (torch.randn((cout,), generator=g, device=dev) * 0.1).to(dtype)
    key = RELU_POOL_KEYS[kconv.relu_pool_route(dtype, shape[3], cout)]
    n0 = dict(kconv.LAUNCHES)
    p, idx = kconv.conv3x3_relu_pool(x, w, b)
    p_ref, idx_ref = kconv.conv3x3_relu_pool_plain(x, w, b)
    torch.cuda.synchronize()
    assert _launched(n0) == {key: 1}
    assert p.dtype == dtype and idx.dtype == torch.uint8
    assert _rel_err(p, p_ref) <= tol
    pre = kconv.conv3x3_nhwc_plain(x, w, b, True)
    scale = float(p_ref.float().abs().max())
    assert _idx_mismatch_where_separated(idx, idx_ref, pre, tol * scale) == 0


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 1e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("shape,cout", [((2, 24, 40, 64), 64),
                                        ((1, 18, 26, 24), 48)])
def test_pool_route_bwd_kernel_matches_plain(dev, dtype, tol, shape, cout):
    g = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn(shape, generator=g, device=dev).to(dtype)
    w = (torch.randn((3, 3, shape[3], cout), generator=g, device=dev)
         * (2.0 / (9 * shape[3])) ** 0.5).to(dtype)
    b = (torch.randn((cout,), generator=g, device=dev) * 0.1).to(dtype)
    p, idx = kconv.conv3x3_relu_pool_plain(x, w, b)
    ct = torch.randn(p.shape, generator=g, device=dev).to(dtype)
    key = POOL_KEYS[kconv.pool_route(dtype, cout, shape[3])]
    n0 = dict(kconv.LAUNCHES)
    dz = kconv.pool_route_conv3x3_bwd(ct, p, idx, w)
    ref = kconv.pool_route_conv3x3_bwd_plain(ct, p, idx, w)
    torch.cuda.synchronize()
    assert _launched(n0) == {key: 1}
    assert dz.shape == x.shape and dz.dtype == dtype
    assert _rel_err(dz, ref) <= tol


# (full-resolution (B, H, W), C, Cin) of the tensor-core D: conv1_2 at 512²,
# K8's three convs (conv2_2, conv3_4, conv4_4 at 512²), ragged widths (W =
# 20 and 10: boxes past the image; W = 2: a 2 x 64 box; C and Cin below one
# slab and one BN tile).
POOL_WGMMA = [((1, 512, 512), 64, 64), ((1, 256, 256), 128, 128),
              ((1, 128, 128), 256, 256), ((1, 64, 64), 512, 512),
              ((2, 20, 36), 48, 24), ((1, 6, 10), 16, 8), ((1, 4, 2), 16, 8),
              ((2, 34, 140), 80, 136)]


@pytest.mark.parametrize("shape,c,cin", POOL_WGMMA)
def test_pool_route_wgmma_matches_plain(dev, shape, c, cin):
    """The tensor-core D in bf16 against its plain version (<= 1e-2 *
    max|plain|) on a pre-pool activation quantised to halves, so that many
    windows are tied (idx names the first maximum) and many are all zero
    (pooled = 0 passes nothing back)."""
    g = torch.Generator(device=dev).manual_seed(17)
    pre = torch.relu(torch.round(2 * torch.randn(shape + (c,), generator=g,
                                                 device=dev)) / 2)
    pooled, idx = kconv.pool4_first_max(pre)
    pooled = pooled.bfloat16()
    assert bool((pooled == 0).any())
    w = (torch.randn((3, 3, cin, c), generator=g, device=dev)
         * (2.0 / (9 * cin)) ** 0.5).bfloat16()
    ct = torch.randn(pooled.shape, generator=g, device=dev).bfloat16()
    assert kconv.pool_route(torch.bfloat16, c, cin) == "wgmma"
    n0 = dict(kconv.LAUNCHES)
    dz = kconv.pool_route_conv3x3_bwd(ct, pooled, idx, w)
    torch.cuda.synchronize()
    assert _launched(n0) == {"pool_route_wgmma": 1}
    ref = kconv.pool_route_conv3x3_bwd_plain(ct, pooled, idx, w)
    assert dz.shape == shape + (cin,) and dz.dtype == torch.bfloat16
    assert _rel_err(dz, ref) <= 1e-2
    # The same call again gives the same bits (no atomics).
    assert torch.equal(dz, kconv.pool_route_conv3x3_bwd(ct, pooled, idx, w))


# (B, H, W), Cin, Cout of the tensor-core C: conv1_2 at 512², K8's three
# convs, then every ``pool_tile`` box (W = 2, 4, 8, 16, 32 and 64 wide) with
# boxes past the image (H = 130 at 2 x 64, W = 100 at 64 x 2), Cin past
# one 64-channel slab (72) and Cout past one BN = 128 tile (136).
POOL_FWD_WGMMA = [((1, 512, 512), 64, 64), ((1, 256, 256), 128, 128),
                  ((1, 128, 128), 256, 256), ((1, 64, 64), 512, 512),
                  ((2, 130, 2), 8, 16), ((1, 6, 4), 16, 64),
                  ((2, 10, 8), 24, 40), ((1, 12, 16), 64, 136),
                  ((1, 8, 32), 72, 64), ((1, 20, 100), 16, 8)]


@pytest.mark.parametrize("shape,cin,cout", POOL_FWD_WGMMA)
def test_conv3x3_relu_pool_wgmma_matches_plain(dev, shape, cin, cout):
    """The tensor-core C in bf16 against its plain version: pooled within
    1e-2 * max|plain|, idx equal wherever the plain top two of the window
    differ by more than that."""
    g = torch.Generator(device=dev).manual_seed(18)
    x = torch.randn(shape + (cin,), generator=g, device=dev).bfloat16()
    w = (torch.randn((3, 3, cin, cout), generator=g, device=dev)
         * (2.0 / (9 * cin)) ** 0.5).bfloat16()
    b = (torch.randn((cout,), generator=g, device=dev) * 0.1).bfloat16()
    assert kconv.relu_pool_route(torch.bfloat16, cin, cout) == "wgmma"
    n0 = dict(kconv.LAUNCHES)
    p, idx = kconv.conv3x3_relu_pool(x, w, b)
    torch.cuda.synchronize()
    assert _launched(n0) == {"conv3x3_relu_pool_wgmma": 1}
    p_ref, idx_ref = kconv.conv3x3_relu_pool_plain(x, w, b)
    assert p.shape == p_ref.shape and p.dtype == torch.bfloat16
    assert idx.dtype == torch.uint8
    assert _rel_err(p, p_ref) <= 1e-2
    pre = kconv.conv3x3_nhwc_plain(x, w, b, True)
    scale = float(p_ref.float().abs().max())
    assert _idx_mismatch_where_separated(idx, idx_ref, pre, 1e-2 * scale) == 0


@pytest.mark.parametrize("shape,cin,cout", [((2, 16, 64), 16, 64),
                                            ((1, 8, 130), 8, 24),
                                            ((1, 34, 20), 16, 136)])
def test_conv3x3_relu_pool_wgmma_ties_and_zero_windows(dev, shape, cin,
                                                       cout):
    """Integer operands (x, w in {-1, 0, 1}, b in {-2..2}) make every sum
    exact in float32 and in bf16, so exact ties and all-zero windows are
    common: pooled and idx equal the plain version's bit for bit (idx is
    the first maximum in scan order)."""
    g = torch.Generator(device=dev).manual_seed(19)
    x = torch.randint(-1, 2, shape + (cin,), generator=g,
                      device=dev).bfloat16()
    w = torch.randint(-1, 2, (3, 3, cin, cout), generator=g,
                      device=dev).bfloat16()
    b = torch.randint(-2, 3, (cout,), generator=g, device=dev).bfloat16()
    p, idx = kconv.conv3x3_relu_pool(x, w, b)
    p_ref, idx_ref = kconv.conv3x3_relu_pool_plain(x, w, b)
    torch.cuda.synchronize()
    pre = kconv.conv3x3_nhwc_plain(x, w, b, True).float()
    bsz, h, wd, c = pre.shape
    win = pre.reshape(bsz, h // 2, 2, wd // 2, 2, c).permute(
        0, 1, 3, 5, 2, 4).reshape(bsz, h // 2, wd // 2, c, 4)
    top2 = win.sort(dim=-1).values[..., -2:]
    assert bool((top2[..., 1] == top2[..., 0]).any())   # ties
    assert bool((p_ref == 0).any())                     # all-zero windows
    assert torch.equal(p, p_ref) and torch.equal(idx, idx_ref)


# The same boxes in float32, plus Cin and Cout multiples of 4 but not of 8,
# the narrowest the 3xTF32 route takes, and 192 tiles of BN = 128 (CTAs
# walk two, the staged tile's buffer reused).
POOL_FWD_TF32X3 = POOL_FWD_WGMMA + [((1, 6, 4), 4, 12), ((2, 10, 8), 12, 36),
                                    ((2, 96, 96), 128, 128)]


@pytest.mark.parametrize("shape,cin,cout", POOL_FWD_TF32X3)
def test_conv3x3_relu_pool_tf32x3_matches_plain(dev, shape, cin, cout):
    """The 3xTF32 C in float32 against its plain version: pooled within
    1e-4 * max|plain| (the f32 tolerance of ``chip_smoke.py``) and 1e-5 *
    max of a float64 conv + ReLU + pool (tests/test_torch_tf32x3.py: the
    emulated sums land within 1e-6), idx equal wherever the plain top two
    of the window differ by more than 1e-4 * max."""
    g = torch.Generator(device=dev).manual_seed(21)
    x = torch.randn(shape + (cin,), generator=g, device=dev)
    w = torch.randn((3, 3, cin, cout), generator=g, device=dev) * (
        2.0 / (9 * cin)) ** 0.5
    b = torch.randn((cout,), generator=g, device=dev) * 0.1
    assert kconv.relu_pool_route(torch.float32, cin, cout) == "tf32x3"
    n0 = dict(kconv.LAUNCHES)
    p, idx = kconv.conv3x3_relu_pool(x, w, b)
    torch.cuda.synchronize()
    assert _launched(n0) == {"conv3x3_relu_pool_tf32x3": 1}
    p_ref, idx_ref = kconv.conv3x3_relu_pool_plain(x, w, b)
    assert p.shape == p_ref.shape and p.dtype == torch.float32
    assert idx.dtype == torch.uint8
    assert _rel_err(p, p_ref) <= 1e-4
    pre64 = _conv_f64(x, w, b, True)
    bsz, h, wd, c = pre64.shape
    p64 = pre64.reshape(bsz, h // 2, 2, wd // 2, 2, c).amax(dim=(2, 4))
    assert _rel_err(p, p64) <= 1e-5
    pre = kconv.conv3x3_nhwc_plain(x, w, b, True)
    scale = float(p_ref.abs().max())
    assert _idx_mismatch_where_separated(idx, idx_ref, pre, 1e-4 * scale) == 0


@pytest.mark.parametrize("shape,cin,cout", [((2, 16, 64), 16, 64),
                                            ((1, 8, 130), 8, 24),
                                            ((1, 34, 20), 16, 136),
                                            ((1, 6, 10), 4, 12),
                                            ((1, 8, 8), 8, 128),
                                            ((2, 256, 64), 8, 64)])
def test_conv3x3_relu_pool_tf32x3_ties_and_zero_windows(dev, shape, cin,
                                                        cout):
    """Integer operands (x, w in {-1, 0, 1}, b in {-2..2}) split exactly
    and sum exactly in float32, so exact ties and all-zero windows are
    common: pooled and idx equal the plain version's bit for bit (idx is
    the first maximum in scan order, 0 for an all-zero window)."""
    g = torch.Generator(device=dev).manual_seed(22)
    x = torch.randint(-1, 2, shape + (cin,), generator=g, device=dev).float()
    w = torch.randint(-1, 2, (3, 3, cin, cout), generator=g,
                      device=dev).float()
    b = torch.randint(-2, 3, (cout,), generator=g, device=dev).float()
    n0 = dict(kconv.LAUNCHES)
    p, idx = kconv.conv3x3_relu_pool(x, w, b)
    torch.cuda.synchronize()
    assert _launched(n0) == {"conv3x3_relu_pool_tf32x3": 1}
    p_ref, idx_ref = kconv.conv3x3_relu_pool_plain(x, w, b)
    pre = kconv.conv3x3_nhwc_plain(x, w, b, True)
    bsz, h, wd, c = pre.shape
    win = pre.reshape(bsz, h // 2, 2, wd // 2, 2, c).permute(
        0, 1, 3, 5, 2, 4).reshape(bsz, h // 2, wd // 2, c, 4)
    top2 = win.sort(dim=-1).values[..., -2:]
    assert bool((top2[..., 1] == top2[..., 0]).any())   # ties
    assert bool((p_ref == 0).any())                     # all-zero windows
    assert torch.equal(p, p_ref) and torch.equal(idx, idx_ref)


@pytest.mark.parametrize("pixels,c", [(37 * 29, 64), (1000, 128),
                                      (4096 + 17, 512), (300, 136),
                                      (16, 512), (64 * 64, 4)])
def test_gram_tf32x3_matches_plain(dev, pixels, c):
    """The 3xTF32 K3 in float32 (pixel counts off the 32-pixel box, one box
    past P, C below, at and between 128-channel tiles, C = 4) against its
    plain version: relative Frobenius error <= 1e-5, and <= 5e-6 of a
    float64 Gram (the emulation lands within 1e-6,
    tests/test_torch_tf32x3.py; each box's partial adds 12 wgmma in the
    tensor core's own f32 sum, which may truncate: 12 * 2^-23 = 1.4e-6 at
    worst); bit-identical on a second call."""
    g = torch.Generator(device=dev).manual_seed(23)
    y = torch.relu(torch.randn((3, pixels, c), generator=g, device=dev))
    assert kconv.gram_route(torch.float32, c) == "tf32x3"
    n0 = dict(kconv.LAUNCHES)
    got = kconv.gram_nhwc(y)
    again = kconv.gram_nhwc(y)
    torch.cuda.synchronize()
    assert _launched(n0) == {"gram_tf32x3": 2}
    ref = kconv.gram_nhwc_plain(y)
    assert torch.linalg.norm(got - ref) <= 1e-5 * torch.linalg.norm(ref)
    yd = y.double()
    ref64 = yd.transpose(1, 2) @ yd
    assert torch.linalg.norm(got.double() - ref64) <= 5e-6 * torch.linalg.norm(
        ref64)
    assert torch.equal(got, again)                    # deterministic


@pytest.mark.parametrize("shape,c,cin", POOL_WGMMA)
def test_pool_route_tf32x3_matches_plain(dev, shape, c, cin):
    """The 3xTF32 D in float32 on a pre-pool activation quantised to
    halves (tied and all-zero windows): within 1e-4 * max|plain| of its
    plain version and 1e-5 * max of a float64 transpose conv of the routed
    cotangent (tests/test_torch_tf32x3.py: the emulated sums land within
    1e-6)."""
    g = torch.Generator(device=dev).manual_seed(20)
    pre = torch.relu(torch.round(2 * torch.randn(shape + (c,), generator=g,
                                                 device=dev)) / 2)
    pooled, idx = kconv.pool4_first_max(pre)
    assert bool((pooled == 0).any())
    w = torch.randn((3, 3, cin, c), generator=g, device=dev) * (
        2.0 / (9 * cin)) ** 0.5
    ct = torch.randn(pooled.shape, generator=g, device=dev)
    assert kconv.pool_route(torch.float32, c, cin) == "tf32x3"
    n0 = dict(kconv.LAUNCHES)
    dz = kconv.pool_route_conv3x3_bwd(ct, pooled, idx, w)
    torch.cuda.synchronize()
    assert _launched(n0) == {"pool_route_tf32x3": 1}
    assert dz.shape == shape + (cin,) and dz.dtype == torch.float32
    assert _rel_err(dz, kconv.pool_route_conv3x3_bwd_plain(
        ct, pooled, idx, w)) <= 1e-4
    routed = kconv.route_pool_cotangent(ct, pooled, idx)
    ref = _conv_f64(routed, kconv.transpose_weights(w, torch.float32),
                    torch.zeros(cin, device=dev), False)
    assert _rel_err(dz, ref) <= 1e-5
    # The same call again gives the same bits (no atomics).
    assert torch.equal(dz, kconv.pool_route_conv3x3_bwd(ct, pooled, idx, w))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stage1_gradient_matches_plain_path(dev, dtype):
    """conv1_1_relu_stats -> Gram and conv1_2_relu_pool on CUDA tensors
    (kernels A-D; C and D on the tensor cores in both dtypes, by 3xTF32 in
    float32) against the plain versions: in float32 the same functions on CPU
    copies, values and the input gradient within 1e-4; in bf16 the input
    gradient against the plain chain (D's and B's plain versions) fed the
    kernels' own forward outputs, within 1e-2 (the bf16 pool's index may
    differ from a CPU run's at near-ties)."""
    from st3d_torch.kernels import stage1 as ks1
    from st3d_torch.models.vgg import gram1_closed_form

    if dtype == torch.bfloat16:
        return _stage1_gradient_bf16(dev)

    rng = np.random.RandomState(8)
    x = rng.rand(2, 32, 24, 3).astype(np.float32)
    w1 = (rng.randn(3, 3, 3, 64) * 0.2).astype(np.float32)
    b1 = (rng.randn(64) * 0.1).astype(np.float32)
    w2 = (rng.randn(3, 3, 64, 64) * 0.05).astype(np.float32)
    b2 = (rng.randn(64) * 0.1).astype(np.float32)
    ct = rng.randn(2, 16, 12, 64).astype(np.float32)
    ctg = (rng.randn(2, 64, 64) * 1e-3).astype(np.float32)
    outs = []
    n0 = dict(kconv.LAUNCHES)
    for d in (dev, torch.device("cpu")):
        t = [torch.tensor(a, device=d) for a in (w1, b1, w2, b2)]
        xt = torch.tensor(x, device=d, requires_grad=True)
        z, ptp, s27 = ks1.conv1_1_relu_stats(xt, t[0], t[1])
        gm = gram1_closed_form(ptp, s27, t[0], t[1], 32 * 24)
        p, _ = ks1.conv1_2_relu_pool(z, t[2], t[3])
        torch.autograd.backward((p, gm), (torch.tensor(ct, device=d),
                                          torch.tensor(ctg, device=d)))
        outs.append([v.detach().cpu() for v in (p, gm, xt.grad)])
    assert _launched(n0) == {"conv3x3_relu_pool_tf32x3": 1,
                             "pool_route_tf32x3": 1}
    for got, ref in zip(*outs):
        assert _rel_err(got, ref) <= 1e-4


def _stage1_gradient_bf16(dev):
    from st3d_torch.kernels import stage1 as ks1
    from st3d_torch.models.vgg import gram1_closed_form

    rng = np.random.RandomState(8)
    bf = torch.bfloat16
    x = torch.tensor(rng.rand(2, 32, 24, 3).astype(np.float32),
                     device=dev).to(bf)
    w1, b1, w2, b2 = (torch.tensor(a, device=dev).to(bf) for a in (
        (rng.randn(3, 3, 3, 64) * 0.2).astype(np.float32),
        (rng.randn(64) * 0.1).astype(np.float32),
        (rng.randn(3, 3, 64, 64) * 0.05).astype(np.float32),
        (rng.randn(64) * 0.1).astype(np.float32)))
    ct = torch.tensor(rng.randn(2, 16, 12, 64).astype(np.float32),
                      device=dev).to(bf)
    ctg = torch.tensor((rng.randn(2, 64, 64) * 1e-3).astype(np.float32),
                       device=dev)
    n0, n1 = dict(kconv.LAUNCHES), dict(ks1.LAUNCHES)
    xt = x.clone().requires_grad_(True)
    z, ptp, s27 = ks1.conv1_1_relu_stats(xt, w1, b1)
    gm = gram1_closed_form(ptp, s27, w1, b1, 32 * 24)
    p, idx = ks1.conv1_2_relu_pool(z, w2, b2)
    torch.autograd.backward((p, gm), (ct, ctg))
    torch.cuda.synchronize()
    assert _launched(n0) == {"conv3x3_relu_pool_wgmma": 1,
                             "pool_route_wgmma": 1}
    assert _s1_launched(n1) == {"conv1_1_stats_wgmma": 1,
                                "conv1_1_bwd_wgmma": 1}
    # The plain chain on the kernels' own forward outputs.
    ptp_r = ptp.detach().requires_grad_(True)
    s27_r = s27.detach().requires_grad_(True)
    dptp, ds27 = torch.autograd.grad(
        gram1_closed_form(ptp_r, s27_r, w1, b1, 32 * 24), (ptp_r, s27_r),
        ctg)
    dz = kconv.pool_route_conv3x3_bwd_plain(ct, p.detach(), idx, w2)
    ref = ks1.conv1_1_bwd_plain(x, dz, z.detach(), w1,
                                (dptp + dptp.transpose(-1, -2)).float(),
                                ds27.float())
    assert xt.grad.dtype == bf and _rel_err(xt.grad, ref) <= 1e-2


# ---------------------------------------------------------------------------
# Visibility: K1's soft mode, K6 (streaming) and K7 (top-K)
# ---------------------------------------------------------------------------

def _sphere_faces(dev, level, size, views=3):
    from st3d_torch.core.cameras import build_fixed_cameras
    from st3d_torch.core.primitives import ico_sphere
    from st3d_torch.render.rasterize import face_verts_screen

    mesh = ico_sphere(level=level).to(dev)
    return face_verts_screen(mesh.verts, mesh.faces,
                             build_fixed_cameras(views, seed=1).to(dev), size)


@pytest.mark.parametrize("size", [96, 80])
def test_raster_soft_kernel_equals_plain(dev, size):
    fv = _sphere_faces(dev, 3, size)
    coeffs, bounds, _ = kraster.preprocess(fv)
    tile = kraster.cull_tile(size, size, True)
    margin = kraster.soft_cull_margin(1.5)
    n0 = kraster.LAUNCHES["raster_soft"]
    got = kraster.raster_soft(coeffs, bounds, size, size, margin, tile)
    torch.cuda.synchronize()
    assert kraster.LAUNCHES["raster_soft"] == n0 + 1
    want = kraster.raster_soft_plain(coeffs, bounds, size, size, margin,
                                     tile)
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    torch.testing.assert_close(got[1], want[1], rtol=1e-6, atol=0)
    # Hard outputs are K1's.
    p2f, zbuf = kraster.raster_hard(coeffs, bounds, size, size)
    assert torch.equal(got[0], p2f) and torch.equal(got[1], zbuf)


@pytest.mark.parametrize("soft", [False, True])
def test_raster_stream_kernel_equals_plain_and_k1(dev, soft):
    size = 96
    fv = _sphere_faces(dev, 4, size)
    coeffs, bounds, _ = kraster.preprocess(fv)
    tile = kraster.cull_tile(size, size, soft)
    margin = kraster.soft_cull_margin(1.0) if soft else 0.0
    ranges = kraster.stream_ranges(bounds, size, size, tile, margin)
    n0 = kraster.LAUNCHES["raster_stream"]
    counts = torch.zeros(2, dtype=torch.int64, device=dev)
    got = kraster.raster_stream(coeffs, bounds, ranges, size, size, tile,
                                soft, margin, counts[0:1])
    kraster.raster_stream_every_chunk(coeffs, bounds, ranges, size, size,
                                      tile, soft, margin, counts[1:2])
    torch.cuda.synchronize()
    assert kraster.LAUNCHES["raster_stream"] == n0 + 1
    # The lists hold fewer (pixel, face) pairs than the TPU kernel's walk
    # tests: every face of each chunk it walked at each of 256 pixels.
    assert 0 < int(counts[0]) < int(counts[1]) * kraster.FACE_CHUNK * 256
    want = kraster.raster_stream_plain(coeffs, ranges, size, size, tile,
                                       soft)
    assert torch.equal(got[0], want[0])
    torch.testing.assert_close(got[1], want[1], rtol=1e-6, atol=0)
    if soft:
        assert torch.equal(got[2], want[2])
    p2f, zbuf = kraster.raster_hard(coeffs, bounds, size, size)
    assert torch.equal(got[0], p2f) and torch.equal(got[1], zbuf)


@pytest.mark.parametrize("k,window", [(4, 3.0), (5, 0.9), (1, 2.0),
                                      (16, 4.0)])
def test_raster_topk_kernel_equals_plain(dev, k, window):
    size = 80
    fv = _sphere_faces(dev, 3, size, views=2)
    coeffs, bounds, _ = kraster.preprocess(fv)
    n0 = kraster.LAUNCHES["raster_topk"]
    got = kraster.raster_topk(coeffs, bounds, size, size, k, window)
    torch.cuda.synchronize()
    assert kraster.LAUNCHES["raster_topk"] == n0 + 1
    want = kraster.raster_topk_plain(coeffs, bounds, size, size, k, window)
    assert torch.equal(got, want)
    assert (got[..., 0] >= 0).float().mean() > 0.1


def test_topk_kernel_keeps_lower_id_first_on_ties(dev):
    """Duplicated faces score equally: the lower sorted id stays in
    front, in the kernel as in its plain version."""
    fv = _sphere_faces(dev, 2, 64, views=1)
    fv = torch.cat([fv, fv], dim=1)              # every face twice
    coeffs, bounds, _ = kraster.preprocess(fv)
    got = kraster.raster_topk(coeffs, bounds, 64, 64, 4, 2.0)
    want = kraster.raster_topk_plain(coeffs, bounds, 64, 64, 4, 2.0)
    assert torch.equal(got, want)
    both = (got[..., 0] >= 0) & (got[..., 1] >= 0)
    assert both.any()


@pytest.mark.parametrize("mode", ["hard", "soft", "softras", "blur"])
def test_render_gradients_match_plain_path(dev, mode):
    """Rasterize and shade on CUDA tensors (kernels) against the CPU (plain
    versions) from the same screen vertices, float32: values and the
    screen-vertex and texture gradients. (Projected on each device, the
    vertices differ in the last bits, which flips the nearest face at
    near-ties of the soft modes.)"""
    from st3d_torch.core.cameras import build_fixed_cameras
    from st3d_torch.core.primitives import ico_sphere
    from st3d_torch.render.rasterize import (
        RasterizationSettings, face_verts_screen)
    from st3d_torch.render.renderer import rasterize_views, shade_views

    kw = {"hard": {}, "soft": {"soft": True},
          "softras": {"soft": True, "faces_per_pixel": 4, "gamma": 1e-2},
          "blur": {"blur_radius": 1e-3, "faces_per_pixel": 2}}[mode]
    settings = RasterizationSettings(image_size=48, **kw)
    rng = np.random.RandomState(9)
    w = torch.tensor(rng.randn(2, 48, 48, 4).astype(np.float32))
    mesh = ico_sphere(level=2, texture_size=16)
    fv0 = face_verts_screen(mesh.verts, mesh.faces,
                            build_fixed_cameras(2, seed=0), 48)
    outs = []
    for d in (dev, torch.device("cpu")):
        m = mesh.to(d)
        fv = fv0.to(d).requires_grad_(True)
        tex = m.texture.clone().requires_grad_(True)
        m = m.replace(texture=tex)
        rgba = shade_views(m, fv, rasterize_views(fv, settings), settings)
        torch.sum(rgba * w.to(d)).backward()
        outs.append([t.detach().cpu() for t in (rgba, fv.grad, tex.grad)])
    for got, ref in zip(*outs):
        torch.testing.assert_close(got, ref, rtol=1e-4,
                                   atol=1e-4 * float(ref.abs().max()))


# ---------------------------------------------------------------------------
# Stage 1 v3 (E conv1_1_gram, F conv1_1_gram_bwd), C and D at K8's widths,
# and K9 (G raster_2d)
# ---------------------------------------------------------------------------

V3_KEYS = {"wgmma": ("conv1_1_gram_wgmma", "conv1_1_gram_bwd_wgmma"),
           "tf32x3": ("conv1_1_gram_tf32x3", "conv1_1_gram_bwd_tf32x3")}


def _v3_launched(n0):
    from st3d_torch.kernels import stage1v3 as ks3

    return {k: v - n0[k] for k, v in ks3.LAUNCHES.items() if v != n0[k]}


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 1e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("shape", [(2, 24, 40), (1, 37, 19)])
def test_conv1_1_gram_kernel_matches_plain(dev, dtype, tol, shape):
    from st3d_torch.kernels import stage1v3 as ks3

    g = torch.Generator(device=dev).manual_seed(10)
    x = torch.rand(shape + (3,), generator=g, device=dev).to(dtype)
    w = (torch.randn((3, 3, 3, 64), generator=g, device=dev) * 0.3).to(dtype)
    b = (torch.randn((64,), generator=g, device=dev) * 0.1).to(dtype)
    n0 = dict(ks3.LAUNCHES)
    z, g64 = ks3.conv1_1_gram(x, w, b)
    z_p, g_p = ks3.conv1_1_gram_plain(x, w, b)
    torch.cuda.synchronize()
    assert _v3_launched(n0) == {V3_KEYS[ks3.v3_route(dtype)][0]: 1}
    assert z.dtype == dtype and g64.dtype == torch.float32
    assert _rel_err(z, z_p) <= tol
    assert torch.linalg.norm(g64 - g_p) <= 1e-4 * torch.linalg.norm(g_p)
    assert torch.equal(ks3.conv1_1_gram(x, w, b)[1], g64)   # deterministic


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 1e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("shape", [(2, 24, 40), (1, 37, 19)])
def test_conv1_1_gram_bwd_kernel_matches_plain(dev, dtype, tol, shape):
    from st3d_torch.kernels import stage1v3 as ks3

    g = torch.Generator(device=dev).manual_seed(11)
    x = torch.rand(shape + (3,), generator=g, device=dev).to(dtype)
    w = (torch.randn((3, 3, 3, 64), generator=g, device=dev) * 0.3).to(dtype)
    b = (torch.randn((64,), generator=g, device=dev) * 0.1).to(dtype)
    dz = torch.randn(shape + (64,), generator=g, device=dev).to(dtype)
    dg = torch.randn((shape[0], 64, 64), generator=g, device=dev) * 1e-2
    sym = dg + dg.transpose(1, 2)
    n0 = dict(ks3.LAUNCHES)
    dx = ks3.conv1_1_gram_bwd(x, dz, w, b, sym)
    ref = ks3.conv1_1_gram_bwd_plain(x, dz, w, b, sym)
    torch.cuda.synchronize()
    assert _v3_launched(n0) == {V3_KEYS[ks3.v3_route(dtype)][1]: 1}
    assert dx.dtype == dtype and _rel_err(dx, ref) <= tol


# E and F on their bf16 tensor-core route against the plain versions: one
# E tile (4 x 32), one F tile (14 x 22), ragged tiles both
# ways (37 x 19, 37 x 29) and 24 x 40; at 4 x 128 x 136 more tiles than
# blocks, so that E's blocks walk several tiles and F's cross images. On
# exact data (x in halves, weights and bias in eighths up to 1/8, dz in
# eighths, dG in 64ths up to 1/32) y is exact in bf16 and every sum of E
# and F is exact in float32 in any order (|y| <= 3.5, the Gram's sums
# below 2^14 in units of 2^-8 up to 960 pixels an image, |dP| below 2^7
# and dx below 2^11 in units of 2^-13), and S needs no lo part: z, g64 and
# dx equal the plain versions bit for bit, ReLU boundary
# (y = 0) included. On random data: z within one bf16 step, g64 within
# 1e-5 relative Frobenius, dx within 1e-2 of the largest value (d is
# rounded from float32 sums taken in other orders, and S's hi + lo is S to
# 2^-16, so a d may land one bf16 step apart).
V3_TILE_SHAPES = [(1, 4, 32), (1, 14, 22), (1, 37, 19), (1, 37, 29),
                  (2, 24, 40)]


def _v3_exact(dev, seed, shape):
    g = torch.Generator(device=dev).manual_seed(seed)

    def grid(size, lo, hi, unit):
        return (torch.randint(lo, hi + 1, size, generator=g, device=dev)
                .float() * unit).to(torch.bfloat16)

    x = grid(shape + (3,), 0, 2, 0.5)
    w, b = grid((3, 3, 3, 64), -1, 1, 0.125), grid((64,), -1, 1, 0.125)
    dz = grid(shape + (64,), -4, 4, 0.125)
    dg = torch.randint(-2, 3, (shape[0], 64, 64), generator=g,
                       device=dev).float() / 64
    return x, w, b, dz, dg + dg.transpose(1, 2)


@pytest.mark.parametrize("shape", V3_TILE_SHAPES)
def test_conv1_1_gram_wgmma_bit_equal_on_exact_data(dev, shape):
    from st3d_torch.kernels import stage1v3 as ks3

    x, w, b, dz, sym = _v3_exact(dev, 31, shape)
    n0 = dict(ks3.LAUNCHES)
    z, g64 = ks3.conv1_1_gram(x, w, b)
    dx = ks3.conv1_1_gram_bwd(x, dz, w, b, sym)
    torch.cuda.synchronize()
    assert _v3_launched(n0) == {"conv1_1_gram_wgmma": 1,
                                "conv1_1_gram_bwd_wgmma": 1}
    z_p, g_p = ks3.conv1_1_gram_plain(x, w, b)
    dx_p = ks3.conv1_1_gram_bwd_plain(x, dz, w, b, sym)
    assert bool((z_p == 0).any()) and bool((z_p > 0).any())
    for got, plain in ((z, z_p), (g64, g_p), (dx, dx_p)):
        assert torch.equal(got, plain)
    # The Gram cotangent matters: without it dx moves.
    assert not torch.equal(
        ks3.conv1_1_gram_bwd_plain(x, dz, w, b, torch.zeros_like(sym)), dx)
    again = ks3.conv1_1_gram(x, w, b)
    assert torch.equal(again[0], z) and torch.equal(again[1], g64)
    assert torch.equal(ks3.conv1_1_gram_bwd(x, dz, w, b, sym), dx)


@pytest.mark.parametrize("shape", V3_TILE_SHAPES + [(4, 128, 136)])
def test_conv1_1_gram_wgmma_matches_plain(dev, shape):
    from st3d_torch.kernels import stage1v3 as ks3

    g = torch.Generator(device=dev).manual_seed(32)
    bf = torch.bfloat16
    x = torch.rand(shape + (3,), generator=g, device=dev).to(bf)
    w = (torch.randn((3, 3, 3, 64), generator=g, device=dev)
         * (2.0 / 27) ** 0.5).to(bf)
    b = (0.1 * torch.randn((64,), generator=g, device=dev)).to(bf)
    dz = torch.randn(shape + (64,), generator=g, device=dev).to(bf)
    dg = 3e-2 * torch.randn((shape[0], 64, 64), generator=g, device=dev)
    sym = dg + dg.transpose(1, 2)
    n0 = dict(ks3.LAUNCHES)
    z, g64 = ks3.conv1_1_gram(x, w, b)
    dx = ks3.conv1_1_gram_bwd(x, dz, w, b, sym)
    torch.cuda.synchronize()
    assert _v3_launched(n0) == {"conv1_1_gram_wgmma": 1,
                                "conv1_1_gram_bwd_wgmma": 1}
    z_r, g_r = ks3.conv1_1_gram_plain(x, w, b)
    assert _within_one_bf16_step(z, z_r)
    assert torch.linalg.norm(g64 - g_r) <= 1e-5 * torch.linalg.norm(g_r)
    assert _rel_err(dx, ks3.conv1_1_gram_bwd_plain(x, dz, w, b, sym)) <= 1e-2
    assert torch.equal(ks3.conv1_1_gram(x, w, b)[1], g64)   # deterministic
    assert torch.equal(ks3.conv1_1_gram_bwd(x, dz, w, b, sym), dx)


# E and F on their float32 tensor-core route (3xTF32) against the plain
# versions, on the tile shapes above. On the
# exact data of ``_v3_exact`` in float32 (every value exact in TF32, so
# every lo part of x, W, b, dz and S is zero; y is exact in TF32 too, and
# M = S Wᵀ, in units of 2^-9 below 2^-1, in float32; every sum exact in
# float32 in any order, as above) z, g64 and dx equal the plain versions
# bit for bit, ReLU boundary included. On random data: z
# within 1e-4 of the largest value, g64 within 1e-4 relative Frobenius and
# bit-identical on a second call, and dx within 1e-4 of the largest value
# against the plain function masked by E's own z > 0 (F recomputes y by
# E's instructions; a plain float32 y may straddle 0 elsewhere, only where
# |y| <= 1e-5 max|y|).


@pytest.mark.parametrize("shape", V3_TILE_SHAPES)
def test_conv1_1_gram_tf32x3_bit_equal_on_exact_data(dev, shape):
    from st3d_torch.kernels import stage1v3 as ks3

    x, w, b, dz, sym = (t.float() for t in _v3_exact(dev, 41, shape))
    assert ks3.v3_route(torch.float32) == "tf32x3"
    n0 = dict(ks3.LAUNCHES)
    z, g64 = ks3.conv1_1_gram(x, w, b)
    dx = ks3.conv1_1_gram_bwd(x, dz, w, b, sym)
    torch.cuda.synchronize()
    assert _v3_launched(n0) == {"conv1_1_gram_tf32x3": 1,
                                "conv1_1_gram_bwd_tf32x3": 1}
    z_p, g_p = ks3.conv1_1_gram_plain(x, w, b)
    dx_p = ks3.conv1_1_gram_bwd_plain(x, dz, w, b, sym)
    assert bool((z_p == 0).any()) and bool((z_p > 0).any())
    for got, plain in ((z, z_p), (g64, g_p), (dx, dx_p)):
        assert got.dtype == torch.float32
        assert torch.equal(got, plain)
    assert not torch.equal(
        ks3.conv1_1_gram_bwd_plain(x, dz, w, b, torch.zeros_like(sym)), dx)
    again = ks3.conv1_1_gram(x, w, b)
    assert torch.equal(again[0], z) and torch.equal(again[1], g64)
    assert torch.equal(ks3.conv1_1_gram_bwd(x, dz, w, b, sym), dx)


@pytest.mark.parametrize("shape", V3_TILE_SHAPES + [(4, 128, 136)])
def test_conv1_1_gram_tf32x3_within_1e4_on_random_data(dev, shape):
    from st3d_torch.kernels import stage1v3 as ks3
    from st3d_torch.kernels.stage1 import patches27

    g = torch.Generator(device=dev).manual_seed(42)
    x = torch.rand(shape + (3,), generator=g, device=dev)
    w = torch.randn((3, 3, 3, 64), generator=g, device=dev) * (2 / 27) ** .5
    b = 0.1 * torch.randn((64,), generator=g, device=dev)
    dz = torch.randn(shape + (64,), generator=g, device=dev)
    dg = 3e-2 * torch.randn((shape[0], 64, 64), generator=g, device=dev)
    sym = dg + dg.transpose(1, 2)
    n0 = dict(ks3.LAUNCHES)
    z, g64 = ks3.conv1_1_gram(x, w, b)
    dx = ks3.conv1_1_gram_bwd(x, dz, w, b, sym)
    torch.cuda.synchronize()
    assert _v3_launched(n0) == {"conv1_1_gram_tf32x3": 1,
                                "conv1_1_gram_bwd_tf32x3": 1}
    z_p, g_p = ks3.conv1_1_gram_plain(x, w, b)
    assert _rel_err(z, z_p) <= 1e-4
    assert torch.linalg.norm(g64 - g_p) <= 1e-4 * torch.linalg.norm(g_p)
    dx_p = ks3.conv1_1_gram_bwd_plain(x, dz, w, b, sym, mask=z > 0)
    assert _rel_err(dx, dx_p) <= 1e-4
    y = patches27(x) @ w.reshape(27, 64) + b
    flips = (z > 0) != (y > 0)
    assert bool((y[flips].abs() <= 1e-5 * y.abs().max()).all())
    assert torch.equal(ks3.conv1_1_gram(x, w, b)[1], g64)   # deterministic
    assert torch.equal(ks3.conv1_1_gram_bwd(x, dz, w, b, sym), dx)


@pytest.mark.parametrize("shape", [(1, 37, 29), (4, 128, 136)])
def test_conv1_1_gram_tf32x3_z_is_kernel_a_f32_z(dev, shape):
    """E's y is kernel A f32's z product instruction for instruction
    (hopper.cuh's conv1_1_y_tf32x3 and A's own copy of it): the two z are
    equal bit for bit on random data."""
    from st3d_torch.kernels import stage1 as ks1
    from st3d_torch.kernels import stage1v3 as ks3

    g = torch.Generator(device=dev).manual_seed(43)
    x = torch.rand(shape + (3,), generator=g, device=dev)
    w = torch.randn((3, 3, 3, 64), generator=g, device=dev) * (2 / 27) ** .5
    b = 0.1 * torch.randn((64,), generator=g, device=dev)
    n0, n1 = dict(ks1.LAUNCHES), dict(ks3.LAUNCHES)
    z_a = ks1.conv1_1_stats(x, w, b)[0]
    z_e = ks3.conv1_1_gram(x, w, b)[0]
    torch.cuda.synchronize()
    assert _s1_launched(n0) == {"conv1_1_stats_tf32x3": 1}
    assert _v3_launched(n1) == {"conv1_1_gram_tf32x3": 1}
    assert torch.equal(z_e, z_a)


def test_conv1_1_relu_gram_float32_launches_tf32x3(dev):
    """The autograd function in float32 on the card: forward and backward
    launch E and F on 3xTF32 once each, and nothing else of E's or F's."""
    from st3d_torch.kernels import stage1v3 as ks3

    g = torch.Generator(device=dev).manual_seed(44)
    x = torch.rand((2, 24, 40, 3), generator=g, device=dev,
                   requires_grad=True)
    w = torch.randn((3, 3, 3, 64), generator=g, device=dev) * (2 / 27) ** .5
    b = 0.1 * torch.randn((64,), generator=g, device=dev)
    n0 = dict(ks3.LAUNCHES)
    z, g64 = ks3.conv1_1_relu_gram(x, w, b)
    torch.autograd.backward((z, g64), (torch.ones_like(z),
                                       1e-3 * torch.ones_like(g64)))
    torch.cuda.synchronize()
    assert _v3_launched(n0) == {"conv1_1_gram_tf32x3": 1,
                                "conv1_1_gram_bwd_tf32x3": 1}
    assert bool(torch.isfinite(x.grad).all())


def test_stage1v3_gradient_matches_plain_path(dev):
    """conv1_1_relu_gram and conv1_2_relu_pool_v3 on CUDA tensors (kernels
    E, F, C, D) against the same functions on CPU copies, float32: values
    and the input gradient."""
    from st3d_torch.kernels import stage1v3 as ks3

    rng = np.random.RandomState(12)
    x = rng.rand(2, 32, 24, 3).astype(np.float32)
    w1 = (rng.randn(3, 3, 3, 64) * 0.2).astype(np.float32)
    b1 = (rng.randn(64) * 0.1).astype(np.float32)
    w2 = (rng.randn(3, 3, 64, 64) * 0.05).astype(np.float32)
    b2 = (rng.randn(64) * 0.1).astype(np.float32)
    ct = rng.randn(2, 16, 12, 64).astype(np.float32)
    ctg = (rng.randn(2, 64, 64) * 1e-3).astype(np.float32)
    outs = []
    n0 = dict(kconv.LAUNCHES)
    for d in (dev, torch.device("cpu")):
        t = [torch.tensor(a, device=d) for a in (w1, b1, w2, b2)]
        xt = torch.tensor(x, device=d, requires_grad=True)
        z, gm = ks3.conv1_1_relu_gram(xt, t[0], t[1])
        p, _ = ks3.conv1_2_relu_pool_v3(z, t[2], t[3])
        torch.autograd.backward((p, gm), (torch.tensor(ct, device=d),
                                          torch.tensor(ctg, device=d)))
        outs.append([v.detach().cpu() for v in (p, gm, xt.grad)])
    for got, ref in zip(*outs):
        assert _rel_err(got, ref) <= 1e-4


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 1e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("cin,cout,h", [(128, 128, 16), (256, 256, 8),
                                        (512, 512, 4)])
def test_k8_kernels_match_plain(dev, dtype, tol, cin, cout, h):
    """C and D at K8's widths (conv2_2, conv3_4, conv4_4) through
    ``conv3x3_bias_relu_pool``: pooled, idx where separated, and dx."""
    g = torch.Generator(device=dev).manual_seed(13)
    x = torch.randn((2, h, h, cin), generator=g, device=dev).to(dtype)
    w = (torch.randn((3, 3, cin, cout), generator=g, device=dev)
         * (2.0 / (9 * cin)) ** 0.5).to(dtype)
    b = (torch.randn((cout,), generator=g, device=dev) * 0.1).to(dtype)
    ct = torch.randn((2, h // 2, h // 2, cout), generator=g,
                     device=dev).to(dtype)
    n0 = dict(kconv.LAUNCHES)
    xt = x.clone().requires_grad_(True)
    p, idx = kconv.conv3x3_bias_relu_pool(xt, w, b)
    (dx,) = torch.autograd.grad(p, xt, ct)
    torch.cuda.synchronize()
    assert _launched(n0) == {
        RELU_POOL_KEYS[kconv.relu_pool_route(dtype, cin, cout)]: 1,
        POOL_KEYS[kconv.pool_route(dtype, cout, cin)]: 1}
    p_ref, idx_ref = kconv.conv3x3_relu_pool_plain(x, w, b)
    assert _rel_err(p.detach(), p_ref) <= tol
    pre = kconv.conv3x3_nhwc_plain(x, w, b, True)
    scale = float(p_ref.float().abs().max())
    assert _idx_mismatch_where_separated(idx, idx_ref, pre, tol * scale) == 0
    ref = kconv.pool_route_conv3x3_bwd_plain(ct, p_ref, idx_ref, w)
    assert _rel_err(dx, ref) <= tol


@pytest.mark.parametrize("size", [96, 80])
def test_raster_2d_kernel_equals_plain(dev, size):
    fv = _sphere_faces(dev, 3, size)
    coeffs, bounds, _ = kraster.preprocess_2d(fv, size)
    n0 = kraster.LAUNCHES["raster_2d"]
    p2f, zbuf = kraster.raster_2d(coeffs, bounds, size, size)
    torch.cuda.synchronize()
    assert kraster.LAUNCHES["raster_2d"] == n0 + 1
    p_ref, z_ref = kraster.raster_2d_plain(coeffs, bounds, size, size)
    assert torch.equal(p2f, p_ref)
    torch.testing.assert_close(zbuf, z_ref, rtol=1e-6, atol=0)
    # Mesh ids and zbuf against K1: zbuf bit-equal, ids equal but at ties.
    got = kraster.rasterize_2d_batched(fv, size)
    want = kraster.rasterize_batched(fv, size)
    assert torch.equal(got[1], want[1])
    assert float((got[0] != want[0]).float().mean()) < 1e-3


# The narrow K2 (``csrc/conv_narrow.cuh``) at conv1_1's widths (3 -> 64, its
# dx 64 -> 3), two more odd pairs (5 -> 12, 12 -> 5), more output channels
# than a block takes (3 -> 96: two blocks along grid y, element stores) and
# 72 channels (bf16: a raw halo wider than a slab; float32: a padded halo of
# three slabs, the last part-filled), on tile boxes of W = 1, 5, 20, 33,
# 64 and 130 (ragged), H off and below the box height; forward and dx.
NARROW_CONVS = [((2, 9, 20), 3, 64), ((1, 5, 130), 3, 64),
                ((2, 7, 64), 64, 3), ((1, 3, 1), 5, 12),
                ((2, 11, 5), 12, 5), ((1, 6, 33), 3, 96),
                ((1, 4, 40), 72, 3)]
NARROW_KEYS = {torch.bfloat16: "conv3x3_narrow_wgmma",
               torch.float32: "conv3x3_narrow_tf32x3"}


def _narrow_pair(dev, dtype, shape, cin, cout, relu, x, w, b, ct):
    """Forward and dx through ``conv3x3_nhwc``, both on the narrow kernel
    of ``dtype``; returns ((got, plain args), ...) for both."""
    n0 = dict(kconv.LAUNCHES)
    y = kconv.conv3x3_nhwc(x, w, b, relu)
    dx = kconv._transpose_conv(ct, w)
    torch.cuda.synchronize()
    assert _launched(n0) == {NARROW_KEYS[dtype]: 2}
    wt = kconv.transpose_weights(w, dtype)
    zb = torch.zeros(cin, dtype=dtype, device=dev)
    return ((y, (x, w, b, relu)), (dx, (ct, wt, zb, False)))


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 1e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("shape,cin,cout", NARROW_CONVS)
@pytest.mark.parametrize("relu", [False, True])
def test_conv_narrow_matches_plain(dev, dtype, tol, shape, cin, cout, relu):
    """max-abs error <= tol * max|plain| (``chip_smoke.py``'s K2
    tolerances), and in float32 <= 1e-5 * max against a float64 conv."""
    g = torch.Generator(device=dev).manual_seed(41)
    x = torch.randn(shape + (cin,), generator=g, device=dev).to(dtype)
    w = (torch.randn((3, 3, cin, cout), generator=g, device=dev)
         * (2.0 / (9 * cin)) ** 0.5).to(dtype)
    b = (torch.randn((cout,), generator=g, device=dev) * 0.1).to(dtype)
    ct = torch.randn(shape + (cout,), generator=g, device=dev).to(dtype)
    for got, args in _narrow_pair(dev, dtype, shape, cin, cout, relu, x, w,
                                  b, ct):
        assert got.shape == args[0].shape[:3] + (args[1].shape[3],)
        assert got.dtype == dtype
        assert _rel_err(got, kconv.conv3x3_nhwc_plain(*args)) <= tol
        if dtype == torch.float32:
            assert _rel_err(got, _conv_f64(*args)) <= 1e-5


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,cin,cout", NARROW_CONVS)
def test_conv_narrow_bit_equal_on_exact_data(dev, dtype, shape, cin, cout):
    """x and the cotangent in quarters, weights and bias in eighths (exact
    in bf16 and TF32, every sum exact in float32): forward with ReLU and
    dx equal the plain versions bit for bit."""
    g = torch.Generator(device=dev).manual_seed(43)

    def grid(size, lo, hi, unit):
        return (torch.randint(lo, hi + 1, size, generator=g, device=dev)
                .float() * unit).to(dtype)

    x = grid(shape + (cin,), -4, 4, 0.25)
    w = grid((3, 3, cin, cout), -4, 4, 0.125)
    b = grid((cout,), -4, 4, 0.125)
    ct = grid(shape + (cout,), -4, 4, 0.25)
    for got, args in _narrow_pair(dev, dtype, shape, cin, cout, True, x, w,
                                  b, ct):
        assert torch.equal(got, kconv.conv3x3_nhwc_plain(*args))


def _stretched_faces(dev, level, size, views=2, seed=0):
    """Screen faces of the ico-sphere with 3% of its vertices thrown by
    seeded noise of 0.6 radii: stretched faces whose chunks' row bands span
    the frame, as after a vertex run's first steps."""
    from st3d_torch.core.cameras import build_fixed_cameras
    from st3d_torch.core.primitives import ico_sphere
    from st3d_torch.render.rasterize import face_verts_screen

    mesh = ico_sphere(level=level)
    rng = np.random.RandomState(seed)
    moved = rng.rand(mesh.verts.shape[0]) < 0.03
    noise = rng.randn(*mesh.verts.shape).astype(np.float32) * 0.6
    verts = mesh.verts + torch.tensor(noise * moved[:, None])
    return face_verts_screen(verts.to(dev), mesh.faces.to(dev),
                             build_fixed_cameras(views, seed=1).to(dev), size)


def _stream_held(fv, size, soft):
    """K6 and its every-chunk twin on faces ``fv``: ids, zbuf (and nearest)
    bit-equal to each other and to the plain version, one launch each;
    returns (outputs, coeffs, bounds, ranges, tile, margin, K6's
    ``tested``, the twin's chunks)."""
    dev = fv.device
    coeffs, bounds, _ = kraster.preprocess(fv)
    tile = kraster.cull_tile(size, size, soft)
    margin = kraster.soft_cull_margin(1.0) if soft else 0.0
    ranges = kraster.stream_ranges(bounds, size, size, tile, margin)
    counts = torch.zeros(2, dtype=torch.int64, device=dev)
    n0 = dict(kraster.LAUNCHES)
    got = kraster.raster_stream(coeffs, bounds, ranges, size, size, tile,
                                soft, margin, counts[0:1])
    old = kraster.raster_stream_every_chunk(coeffs, bounds, ranges, size,
                                            size, tile, soft, margin,
                                            counts[1:2])
    torch.cuda.synchronize()
    assert {k: v - n0[k] for k, v in kraster.LAUNCHES.items()
            if v != n0[k]} == {"raster_stream": 1,
                               "raster_stream_every_chunk": 1}
    want = kraster.raster_stream_plain(coeffs, ranges, size, size, tile,
                                       soft)
    for ref in (want, old):
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        if soft:
            assert torch.equal(got[2], ref[2])
    return (got, coeffs, bounds, ranges, tile, margin, int(counts[0]),
            int(counts[1]))


@pytest.mark.parametrize("soft", [False, True])
def test_raster_stream_walk_on_stretched_faces(dev, soft):
    """K6's walk on stretched faces: ids, zbuf (and nearest) equal to its
    plain version and to the every-chunk walk, hard outputs equal to K1's;
    its lists hold fewer pairs than the every-chunk walk tests, as many as
    the CPU model's."""
    from test_torch_stream_walk import walk_plain, walked_pairs

    size = 128
    got, coeffs, bounds, ranges, tile, margin, tested, walked = _stream_held(
        _stretched_faces(dev, 4, size), size, soft)
    p2f, zbuf = kraster.raster_hard(coeffs, bounds, size, size)
    assert torch.equal(got[0], p2f) and torch.equal(got[1], zbuf)
    assert walked > 0
    assert 0 < tested < walked_pairs(ranges.cpu(), size, size, tile)
    model = walk_plain(coeffs.cpu(), bounds.cpu(), ranges.cpu(), size, size,
                       tile, soft, margin)
    assert tested == model[3]


@pytest.mark.parametrize("soft", [False, True])
def test_raster_stream_on_slivers(dev, soft):
    """K6 on slivers whose rounded barycentrics cover pixels outside their
    bbox and their chunk's band: bit-equal to its plain version and to the
    every-chunk walk, ``tested`` equal to the CPU model's; hard, K1 differs
    from it exactly where K6's face lies in a chunk whose band misses the
    block's rows."""
    from test_torch_soft_walk import sliver_faces
    from test_torch_stream_walk import walk_plain

    fv, size = sliver_faces()
    got, coeffs, bounds, ranges, tile, margin, tested, _ = _stream_held(
        torch.tensor(fv, device=dev), size, soft)
    model = walk_plain(coeffs.cpu(), bounds.cpu(), ranges.cpu(), size, size,
                       tile, soft, margin)
    assert tested == model[3]
    if not soft:
        p2f, zbuf = kraster.raster_hard(coeffs, bounds, size, size)
        diff = (got[0] != p2f) | (got[1] != zbuf)
        assert diff.any()
        assert torch.equal(diff, kraster.outside_band(bounds, got[0], size,
                                                      size))


def test_raster_soft_on_slivers(dev):
    """K1-soft on the slivers: all outputs bit-equal to its every-face twin
    and its plain version, ``tested`` equal to the CPU model's."""
    from test_torch_soft_walk import sliver_faces, soft_walk

    fv, size = sliver_faces()
    coeffs, bounds, _ = kraster.preprocess(torch.tensor(fv, device=dev))
    tile = kraster.cull_tile(size, size, True)
    margin = kraster.soft_cull_margin(1.0)
    tested = torch.zeros(1, dtype=torch.int64, device=dev)
    got = kraster.raster_soft(coeffs, bounds, size, size, margin, tile,
                              tested)
    twin = kraster.raster_soft_every_face(coeffs, bounds, size, size, margin,
                                          tile)
    want = kraster.raster_soft_plain(coeffs, bounds, size, size, margin,
                                     tile)
    for a, b, c in zip(got, twin, want):
        assert torch.equal(a, b) and torch.equal(a, c.to(dev))
    model = soft_walk(coeffs.cpu(), bounds.cpu(), size, size, margin, tile)
    assert int(tested) == model[3]


# ---------------------------------------------------------------------------
# K1-soft and K7: per-warp face lists against the earlier walk
# ---------------------------------------------------------------------------

def _walk_faces(dev, kind, size):
    """Screen faces for the per-warp walks: the ico-sphere (level 4 at 512²,
    else level 3) pristine or stretched; at 48² (warps wrap rows) the last
    77 faces are left out, so the last chunk holds padding faces."""
    level = 4 if size == 512 else 3
    fv = (_stretched_faces(dev, level, size) if kind == "stretched"
          else _sphere_faces(dev, level, size, views=2))
    return fv[:, :1203] if size == 48 else fv


@pytest.mark.parametrize("sigma", [1.0, 1.5])
@pytest.mark.parametrize("kind", ["pristine", "stretched"])
@pytest.mark.parametrize("size", [48, 64, 512])
def test_raster_soft_lists_equal_twin_and_plain(dev, size, kind, sigma):
    """K1-soft's per-warp lists: all outputs bit-equal to the every-face
    twin, ids bit-equal and zbuf within rtol 1e-6 of the plain version, the
    hard outputs equal to K1's; one launch each; ``tested`` equal to the
    CPU model's count (below 512²) and below the twin's pairs."""
    from test_torch_soft_walk import every_face_pairs, soft_walk

    coeffs, bounds, _ = kraster.preprocess(_walk_faces(dev, kind, size))
    tile = kraster.cull_tile(size, size, True)
    margin = kraster.soft_cull_margin(sigma)
    tested = torch.zeros(1, dtype=torch.int64, device=dev)
    n0 = dict(kraster.LAUNCHES)
    got = kraster.raster_soft(coeffs, bounds, size, size, margin, tile,
                              tested)
    twin = kraster.raster_soft_every_face(coeffs, bounds, size, size, margin,
                                          tile)
    torch.cuda.synchronize()
    assert {k: v - n0[k] for k, v in kraster.LAUNCHES.items()
            if v != n0[k]} == {"raster_soft": 1, "raster_soft_every_face": 1}
    for a, b in zip(got, twin):
        assert torch.equal(a, b)
    want = kraster.raster_soft_plain(coeffs, bounds, size, size, margin,
                                     tile)
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    torch.testing.assert_close(got[1], want[1], rtol=1e-6, atol=0)
    p2f, zbuf = kraster.raster_hard(coeffs, bounds, size, size)
    assert torch.equal(got[0], p2f) and torch.equal(got[1], zbuf)
    every = every_face_pairs(bounds.cpu(), size, size, tile, margin)
    assert 0 < int(tested) < every
    if size < 512:
        model = soft_walk(coeffs.cpu(), bounds.cpu(), size, size, margin,
                          tile)
        assert int(tested) == model[3]


@pytest.mark.parametrize("k,window", [(4, 3.0), (5, 0.32), (5, 2.56),
                                      (1, 2.0), (16, 4.0)])
@pytest.mark.parametrize("kind", ["pristine", "stretched"])
@pytest.mark.parametrize("size", [48, 64, 512])
def test_raster_topk_lists_equal_twin_and_plain(dev, size, kind, k, window):
    """K7's per-warp lists: ids bit-equal to the every-face twin and to the
    plain version; one launch each; ``tested`` equal to the CPU model's
    count (below 512²) and below the twin's pairs. The windows include
    blur_radius 1e-4's at 64² (0.32) and 512² (2.56)."""
    from test_torch_soft_walk import every_face_pairs, topk_walk

    coeffs, bounds, _ = kraster.preprocess(_walk_faces(dev, kind, size))
    tested = torch.zeros(1, dtype=torch.int64, device=dev)
    n0 = dict(kraster.LAUNCHES)
    got = kraster.raster_topk(coeffs, bounds, size, size, k, window, tested)
    twin = kraster.raster_topk_every_face(coeffs, bounds, size, size, k,
                                          window)
    torch.cuda.synchronize()
    assert {name: v - n0[name] for name, v in kraster.LAUNCHES.items()
            if v != n0[name]} == {"raster_topk": 1,
                                  "raster_topk_every_face": 1}
    assert torch.equal(got, twin)
    assert torch.equal(got, kraster.raster_topk_plain(coeffs, bounds, size,
                                                      size, k, window))
    assert (got[..., 0] >= 0).any()
    every = every_face_pairs(bounds.cpu(), size, size, kraster.TILE_PIXELS,
                             window + 2.0)
    assert 0 < int(tested) < every
    if size < 512:
        model = topk_walk(coeffs.cpu(), bounds.cpu(), size, size, k, window)
        assert int(tested) == model[1]


# ---------------------------------------------------------------------------
# K1 (hard): per-warp face lists against the earlier walk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["pristine", "stretched"])
@pytest.mark.parametrize("size", [48, 64, 512])
def test_raster_hard_lists_equal_twin_and_plain(dev, size, kind):
    """K1's per-warp lists: p2f and zbuf bit-equal to the every-face twin,
    p2f bit-equal and zbuf within rtol 1e-6 of the plain version; one
    launch each; ``tested`` equal to the CPU model's count (below 512²) and
    below the twin's pairs."""
    from test_torch_hard_walk import hard_walk
    from test_torch_soft_walk import every_face_pairs

    coeffs, bounds, _ = kraster.preprocess(_walk_faces(dev, kind, size))
    tested = torch.zeros(1, dtype=torch.int64, device=dev)
    n0 = dict(kraster.LAUNCHES)
    got = kraster.raster_hard(coeffs, bounds, size, size, tested)
    twin = kraster.raster_hard_every_face(coeffs, bounds, size, size)
    torch.cuda.synchronize()
    assert {k: v - n0[k] for k, v in kraster.LAUNCHES.items()
            if v != n0[k]} == {"raster_hard": 1, "raster_hard_every_face": 1}
    assert torch.equal(got[0], twin[0]) and torch.equal(got[1], twin[1])
    want = kraster.raster_hard_plain(coeffs, bounds, size, size)
    assert torch.equal(got[0], want[0])
    torch.testing.assert_close(got[1], want[1], rtol=1e-6, atol=0)
    assert (got[0] >= 0).any()
    every = every_face_pairs(bounds.cpu(), size, size, kraster.TILE_PIXELS,
                             0.0)
    assert 0 < int(tested) < every
    if size < 512:
        model = hard_walk(coeffs.cpu(), bounds.cpu(), size, size)
        assert int(tested) == model[2]


def test_raster_hard_lists_on_adversarial_faces(dev):
    """The CPU tests' adversarial scene (slivers just above AREA_EPS, edges
    through pixel centres, exact 1/z ties): bit-equal to the twin and the
    plain version, ``tested`` equal to the model's."""
    from test_torch_hard_walk import _adversarial_faces, hard_walk

    fv, size = _adversarial_faces()
    coeffs, bounds, _ = kraster.preprocess(torch.tensor(fv, device=dev))
    tested = torch.zeros(1, dtype=torch.int64, device=dev)
    got = kraster.raster_hard(coeffs, bounds, size, size, tested)
    twin = kraster.raster_hard_every_face(coeffs, bounds, size, size)
    want = kraster.raster_hard_plain(coeffs, bounds, size, size)
    torch.cuda.synchronize()
    for ref in (twin, want):
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert int(tested) == hard_walk(coeffs.cpu(), bounds.cpu(), size,
                                    size)[2]


# ---------------------------------------------------------------------------
# G (K9): per-warp face lists on 2D tiles against the earlier kernel
# ---------------------------------------------------------------------------

def _held_2d(coeffs, bounds, size):
    """G, its every-face twin and its plain version on the same faces: p2f
    and zbuf bit-equal, one launch each; returns G's ``tested``."""
    tested = torch.zeros(1, dtype=torch.int64, device=coeffs.device)
    n0 = dict(kraster.LAUNCHES)
    got = kraster.raster_2d(coeffs, bounds, size, size, tested)
    twin = kraster.raster_2d_every_face(coeffs, bounds, size, size)
    torch.cuda.synchronize()
    assert {k: v - n0[k] for k, v in kraster.LAUNCHES.items()
            if v != n0[k]} == {"raster_2d": 1, "raster_2d_every_face": 1}
    want = kraster.raster_2d_plain(coeffs, bounds, size, size)
    for ref in (twin, want):
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert (got[0] >= 0).any()
    return int(tested)


@pytest.mark.parametrize("kind", ["pristine", "stretched"])
@pytest.mark.parametrize("size", [40, 48, 64, 512])
def test_raster_2d_lists_equal_twin_and_plain(dev, size, kind):
    """G's per-warp lists: p2f and zbuf bit-equal to the every-face twin
    and to the plain version; one launch each; ``tested`` equal to the CPU
    model's count (below 512²) and below the twin's pairs. At 40² tiles run
    past the frame; at 40² and 48² the last chunk holds padding faces."""
    from test_torch_2d_walk import every_face_pairs_2d, walk_2d

    fv = _walk_faces(dev, kind, size)
    coeffs, bounds, _ = kraster.preprocess_2d(
        fv[:, :1203] if size == 40 else fv, size)
    tested = _held_2d(coeffs, bounds, size)
    assert 0 < tested < every_face_pairs_2d(bounds.cpu(), size, size)
    if size < 512:
        assert tested == walk_2d(coeffs.cpu(), bounds.cpu(), size, size)[2]


def test_raster_2d_lists_on_adversarial_faces(dev):
    """The CPU tests' adversarial scene (slivers just above AREA_EPS, edges
    through pixel centres, exact 1/z ties): bit-equal to the twin and the
    plain version, ``tested`` equal to the model's."""
    from test_torch_2d_walk import walk_2d
    from test_torch_hard_walk import _adversarial_faces

    fv, size = _adversarial_faces()
    coeffs, bounds, _ = kraster.preprocess_2d(torch.tensor(fv, device=dev),
                                              size)
    tested = _held_2d(coeffs, bounds, size)
    assert tested == walk_2d(coeffs.cpu(), bounds.cpu(), size, size)[2]


def test_raster_2d_rejects_malformed_operands(dev):
    """K1's (N, 2, n_chunks) bounds, bounds on another device and a counter
    that is not one int64 raise before any launch."""
    coeffs = torch.zeros(1, 20, 128, device=dev)
    n0 = dict(kraster.LAUNCHES)
    for fn in (kraster.raster_2d, kraster.raster_2d_every_face):
        with pytest.raises(ValueError):
            fn(coeffs, torch.zeros(1, 2, 1, device=dev), 8, 8)
        with pytest.raises(ValueError):
            fn(coeffs, torch.zeros(1, 4, 1), 8, 8)
    with pytest.raises(ValueError):
        kraster.raster_2d(coeffs, torch.zeros(1, 4, 1, device=dev), 8, 8,
                          torch.zeros(1, dtype=torch.int32, device=dev))
    assert kraster.LAUNCHES == n0


# ---------------------------------------------------------------------------
# K3 at the narrow widths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 1e-3),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("c", [5, 27, 31])
@pytest.mark.parametrize("bsz,pixels", [(4, 512 * 512), (3, 37 * 29),
                                        (2, 36 * 36), (1, 7)])
def test_gram_narrow_matches_plain(dev, dtype, tol, c, bsz, pixels):
    """``gram_narrow`` within ``tol`` (relative Frobenius, 1e-3 bf16, 1e-5
    float32) of a float64 Gram of the stored values and of
    ``gram_nhwc_plain``, the latter plus the plain float32 sum's own
    distance from float64 (at 2^18 pixels an image it is of the order of
    1e-5); bit-identical on a second call, one launch a call and none of
    another K3. Pixel counts off the multiples of 8 put the stages at every
    16-byte shift, and 7 pixels leave a partial last chunk."""
    g = torch.Generator(device=dev).manual_seed(c)
    y = torch.relu(torch.randn((bsz, pixels, c), generator=g,
                               device=dev)).to(dtype)
    assert kconv.gram_route(dtype, c) == "narrow"
    n0 = dict(kconv.LAUNCHES)
    got = kconv.gram_nhwc(y)
    again = kconv.gram_nhwc(y)
    torch.cuda.synchronize()
    assert _launched(n0) == {"gram_narrow": 2}
    assert torch.equal(got, again)
    ref = kconv.gram_nhwc_plain(y)
    g64 = torch.matmul(y.double().transpose(1, 2), y.double())

    def rel(a, b):
        return float(torch.linalg.norm(a.double() - b.double())
                     / torch.linalg.norm(b.double()))

    assert rel(got, g64) <= tol
    assert rel(got, ref) <= tol + rel(ref, g64)


def test_gram_narrow_takes_an_unaligned_view(dev):
    """A view that starts off a 16-byte boundary is copied to one before
    the launch (``_tma_ready``), never read unaligned: the Gram equals the
    plain version's of the same values."""
    base = torch.randn((2, 1000 * 27 + 3), device=dev)
    y = base[:, 3:].reshape(2, 1000, 27)
    assert y.data_ptr() % 16
    got = kconv.gram_nhwc(y)
    ref = kconv.gram_nhwc_plain(y)
    torch.cuda.synchronize()
    assert torch.linalg.norm(got - ref) <= 1e-5 * torch.linalg.norm(ref)


def test_gram_narrow_conv1_1_gradient_path(dev, monkeypatch):
    """Stage 1 off (ST3D_NO_STAGE1_V2=1): conv1_1's Gram in ``get_features``
    takes ``gram_narrow`` once in bf16 and in float32, and its float32
    value and input gradient match the CPU's."""
    from st3d_torch.models import vgg as tvgg

    monkeypatch.setenv("ST3D_NO_STAGE1_V2", "1")
    model, model_cpu = (tvgg.init_random_vgg19(0, device=d)
                        for d in (dev, "cpu"))
    img = torch.rand((2, 3, 40, 40),
                     generator=torch.Generator().manual_seed(3))
    for dtype in (torch.bfloat16, torch.float32):
        n0 = dict(kconv.LAUNCHES)
        x = img.to(dev).requires_grad_(True)
        f = tvgg.get_features(x, model, dtype=dtype,
                              layers={"conv1_1": "conv1_1"}, gram1=True)
        f["conv1_1:gram"].sum().backward()
        torch.cuda.synchronize()
        assert _launched(n0).get("gram_narrow") == 1
        assert "gram_nhwc" not in _launched(n0)
        if dtype == torch.float32:
            xc = img.clone().requires_grad_(True)
            fc = tvgg.get_features(xc, model_cpu, dtype=dtype,
                                   layers={"conv1_1": "conv1_1"},
                                   gram1=True)
            fc["conv1_1:gram"].sum().backward()
            want = fc["conv1_1:gram"].detach()
            got = f["conv1_1:gram"].detach().cpu()
            assert torch.linalg.norm(got - want) <= 1e-5 * torch.linalg.norm(
                want)
            torch.testing.assert_close(x.grad.cpu(), xc.grad, rtol=1e-4,
                                       atol=1e-4 * float(xc.grad.abs().max()))


def _padded_sphere_faces(dev, size):
    """Screen faces (2, F, 3, 3) on the card of 1,203 faces of the level-3
    ico-sphere (the last chunk mixes 51 faces with padding), unpadded and
    padded by +301 faces, +37 vertices and +11 UVs (the padded faces are
    the unpadded ones' own projection, gathered by the padded faces, as
    ``fleetbatch.fleet_visibility`` does)."""
    from st3d_torch.core.cameras import (build_fixed_cameras,
                                         transform_points_screen)
    from st3d_torch.core.primitives import ico_sphere
    from st3d_torch.core.uv import pad_mesh

    mesh = ico_sphere(level=3)
    mesh = mesh.replace(faces=mesh.faces[:1203],
                        faces_uvs=mesh.faces_uvs[:1203]).to(dev)
    padded = pad_mesh(mesh, mesh.verts.shape[0] + 37, 1203 + 301,
                      num_uvs=mesh.verts_uvs.shape[0] + 11)
    scr = transform_points_screen(build_fixed_cameras(2, seed=1).to(dev),
                                  mesh.verts, (size, size))
    return scr[:, mesh.faces], scr[:, padded.faces]


@pytest.mark.parametrize("kernel", ["raster_hard", "raster_soft",
                                    "raster_stream_hard",
                                    "raster_stream_soft", "raster_topk"])
def test_padded_faces_change_no_raster_kernel(dev, kernel):
    """K1, K1-soft, K6 (forced) and K7 (K = 4, 3 px) give padded faces the
    unpadded faces' outputs bit for bit: the per-warp culls drop padding
    faces (zero area) as they dropped the pad columns."""
    fv, fv_pad = _padded_sphere_faces(dev, 96)
    key = "raster_stream" if kernel.startswith("raster_stream") else kernel
    outs = []
    for f in (fv, fv_pad):
        n0 = kraster.LAUNCHES[key]
        if kernel == "raster_hard":
            out = kraster.rasterize_batched(f, 96, stream=False)
        elif kernel == "raster_soft":
            out = kraster.rasterize_batched_soft(f, 96, stream=False)
        elif kernel == "raster_stream_hard":
            out = kraster.rasterize_batched(f, 96, stream=True)
        elif kernel == "raster_stream_soft":
            out = kraster.rasterize_batched_soft(f, 96, stream=True)
        else:
            out = (kraster.rasterize_topk_batched(f, 96, 4, 3.0),)
        torch.cuda.synchronize()
        assert kraster.LAUNCHES[key] == n0 + 1
        outs.append(out)
    assert (outs[0][0] >= 0).any() and int(outs[1][0].max()) < 1203
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_fleet_visibility_is_one_launch_equal_to_each_mesh(dev):
    """``fleet_visibility``: one K1 launch over 2 meshes x 2 views, each
    mesh's ids and depths bit-equal to its own unpadded launch."""
    from st3d_torch.core.cameras import build_fixed_cameras
    from st3d_torch.core.primitives import ico_sphere
    from st3d_torch.core.uv import generate_uvs, pad_mesh
    from st3d_torch.engine.fleetbatch import fleet_visibility
    from st3d_torch.render.rasterize import (RasterizationSettings,
                                             face_verts_screen,
                                             rasterize_batch)

    meshes = [generate_uvs(ico_sphere(level=lv), texture_size=16).to(dev)
              for lv in (3, 2)]
    padded = [pad_mesh(m, 642, 1280, num_uvs=max(
        x.verts_uvs.shape[0] for x in meshes)) for m in meshes]
    cams = build_fixed_cameras(2, seed=0).to(dev)
    settings = RasterizationSettings(image_size=96)
    n0 = kraster.LAUNCHES["raster_hard"]
    vis = fleet_visibility(meshes, padded, cams, settings)
    torch.cuda.synchronize()
    assert kraster.LAUNCHES["raster_hard"] == n0 + 1
    for g, m in enumerate(meshes):
        own = rasterize_batch(face_verts_screen(m.verts, m.faces, cams, 96),
                              settings)
        assert torch.equal(vis["p2f"][g], own.pix_to_face)
        assert torch.equal(vis["zbuf"][g], own.zbuf)
        assert int(vis["p2f"][g].max()) < m.faces.shape[0]
