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
             "narrow_tf32x3": "conv3x3_narrow_tf32x3",
             "cuda_core": "conv3x3_nhwc"}
POOL_KEYS = {"wgmma": "pool_route_wgmma", "tf32x3": "pool_route_tf32x3",
             "cuda_core": "pool_route_conv3x3_bwd"}
RELU_POOL_KEYS = {"wgmma": "conv3x3_relu_pool_wgmma",
                  "tf32x3": "conv3x3_relu_pool_tf32x3",
                  "cuda_core": "conv3x3_relu_pool"}
GRAM_KEYS = {"wgmma": "gram_wgmma", "tf32x3": "gram_tf32x3",
             "cuda_core": "gram_nhwc"}


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


# The tensor-core K2 at every tile shape of ``conv_tile``: W 4, 8, 20, 32,
# 64 and 128 (boxes 4 x 32 .. 128 x 1), H not a multiple of the box height
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


# The same tile shapes in float32, plus W = 1 and 2 (boxes 1 x 128 and
# 2 x 64) and Cin = 4, the narrowest the 3xTF32 route takes.
TF32X3_CONVS = WGMMA_CONVS + [((1, 7, 1), 4, 8), ((2, 5, 2), 8, 4)]


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
            "tf32x3": ("conv1_1_stats_tf32x3", "conv1_1_bwd_tf32x3"),
            "cuda_core": ("conv1_1_stats", "conv1_1_bwd")}


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
                                        ((1, 18, 26, 24), 40)])
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
# the narrowest the 3xTF32 route takes.
POOL_FWD_TF32X3 = POOL_FWD_WGMMA + [((1, 6, 4), 4, 12), ((2, 10, 8), 12, 36)]


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
                                            ((1, 6, 10), 4, 12)])
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
    # The walk tests no chunk outside the ranges (on the pristine sphere
    # every chunk of a range meets the rows: nothing to skip).
    assert 0 < int(counts[0]) <= int(counts[1])
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

@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 1e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("shape", [(2, 24, 40), (1, 37, 19)])
def test_conv1_1_gram_kernel_matches_plain(dev, dtype, tol, shape):
    from st3d_torch.kernels import stage1v3 as ks3

    g = torch.Generator(device=dev).manual_seed(10)
    x = torch.rand(shape + (3,), generator=g, device=dev).to(dtype)
    w = (torch.randn((3, 3, 3, 64), generator=g, device=dev) * 0.3).to(dtype)
    b = (torch.randn((64,), generator=g, device=dev) * 0.1).to(dtype)
    n0 = ks3.LAUNCHES["conv1_1_gram"]
    z, g64 = ks3.conv1_1_gram(x, w, b)
    z_p, g_p = ks3.conv1_1_gram_plain(x, w, b)
    torch.cuda.synchronize()
    assert ks3.LAUNCHES["conv1_1_gram"] == n0 + 1
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
    n0 = ks3.LAUNCHES["conv1_1_gram_bwd"]
    dx = ks3.conv1_1_gram_bwd(x, dz, w, b, sym)
    ref = ks3.conv1_1_gram_bwd_plain(x, dz, w, b, sym)
    torch.cuda.synchronize()
    assert ks3.LAUNCHES["conv1_1_gram_bwd"] == n0 + 1
    assert dx.dtype == dtype and _rel_err(dx, ref) <= tol


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


def test_conv_cuda_core_kernel_matches_plain(dev):
    """The CUDA-core K2, launched by no route since the narrow kernels,
    still held against its plain version (3 -> 64, bf16)."""
    g = torch.Generator(device=dev).manual_seed(44)
    x = torch.randn((2, 12, 20, 3), generator=g, device=dev).bfloat16()
    w = (torch.randn((3, 3, 3, 64), generator=g, device=dev) * 0.3).bfloat16()
    b = torch.randn((64,), generator=g, device=dev).bfloat16()
    n0 = dict(kconv.LAUNCHES)
    y = kconv.conv3x3_cuda_core(x, w, b, True)
    torch.cuda.synchronize()
    assert _launched(n0) == {"conv3x3_nhwc": 1}
    assert _rel_err(y, kconv.conv3x3_nhwc_plain(x, w, b, True)) <= 1e-2


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


@pytest.mark.parametrize("soft", [False, True])
def test_raster_stream_walk_on_stretched_faces(dev, soft):
    """K6's band-skipping walk on stretched faces: ids, zbuf (and nearest)
    equal to its plain version and to the every-chunk walk, hard outputs
    equal to K1's; it tests fewer chunks than the ranges hold."""
    size = 128
    fv = _stretched_faces(dev, 4, size)
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
    p2f, zbuf = kraster.raster_hard(coeffs, bounds, size, size)
    assert torch.equal(got[0], p2f) and torch.equal(got[1], zbuf)
    walked, tested = int(counts[1]), int(counts[0])
    assert 0 < tested <= walked and (soft or tested < walked)
