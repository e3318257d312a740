"""The port stands alone: it imports neither JAX nor ``st3d``; each CUDA
wrapper runs its plain version for a CPU tensor and nothing else; asking
for CUDA without a GPU raises; and its own I/O (PNG, OBJ, resize) agrees
with the JAX package's."""

import os
import subprocess
import sys

import jax.image
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from st3d_torch.core.primitives import ico_sphere
from st3d_torch.io import image as timg
from st3d_torch.io import obj as tobj
from st3d_torch.kernels import conv as kconv
from st3d_torch.kernels import raster as kraster

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax_and_no_st3d():
    code = (
        "import sys\n"
        "import st3d_torch, st3d_torch.second_approach\n"
        "import st3d_torch.kernels.conv, st3d_torch.kernels.raster\n"
        "import st3d_torch.convert, st3d_torch.engine.pipelines\n"
        "import st3d_torch.first_approach, st3d_torch.kernels.stage1\n"
        "import st3d_torch.engine.style_transfer2d\n"
        "import st3d_torch.render.soft, st3d_torch.render.topk\n"
        "import st3d_torch.render.renderer, st3d_torch.ops.losses\n"
        "import st3d_torch.core.mesh, st3d_torch.kernels.stage1v3\n"
        "import st3d_torch.morton_order\n"
        "import st3d_torch.utils.checkpoint, st3d_torch.utils.debug\n"
        "import st3d_torch.core.uv, st3d_torch.engine.multistyle\n"
        "import st3d_torch.engine.fleetbatch\n"
        "import st3d_torch.multi_style, st3d_torch.fleet\n"
        "import st3d_torch.parallel.sharding, st3d_torch.parallel.tiles\n"
        "import st3d_torch.parallel.grid\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert 'st3d' not in sys.modules, 'st3d imported'\n"
        "print('clean')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"


def test_cpu_tensors_take_the_plain_versions():
    before = {**kconv.LAUNCHES, **kraster.LAUNCHES}
    rng = np.random.RandomState(0)
    x = torch.tensor(rng.randn(1, 8, 8, 16).astype(np.float32))
    w = torch.tensor(rng.randn(3, 3, 16, 16).astype(np.float32))
    b = torch.zeros(16)
    torch.testing.assert_close(kconv.conv3x3_nhwc(x, w, b, True),
                               kconv.conv3x3_nhwc_plain(x, w, b, True),
                               atol=0, rtol=0)
    torch.testing.assert_close(kconv.gram_nhwc(x), kconv.gram_nhwc_plain(x),
                               atol=0, rtol=0)
    fv = torch.tensor(rng.rand(1, 5, 3, 3).astype(np.float32) * 16)
    fv[..., 2] += 1.0
    coeffs, bounds, _ = kraster.preprocess(fv)
    got = kraster.raster_hard(coeffs, bounds, 16, 16)
    want = kraster.raster_hard_plain(coeffs, bounds, 16, 16)
    for a, c in zip(got, want):
        torch.testing.assert_close(a, c, atol=0, rtol=0)
    for a, c in zip(kraster.raster_soft(coeffs, bounds, 16, 16, 8.0, 256),
                    kraster.raster_soft_plain(coeffs, bounds, 16, 16, 8.0,
                                              256)):
        torch.testing.assert_close(a, c, atol=0, rtol=0)
    ranges = kraster.stream_ranges(bounds, 16, 16, 256, 0.0)
    got = kraster.raster_stream(coeffs, bounds, ranges, 16, 16, 256, False)
    want = kraster.raster_stream_plain(coeffs, ranges, 16, 16, 256, False)
    for a, c in zip(got[:2], want[:2]):
        torch.testing.assert_close(a, c, atol=0, rtol=0)
    torch.testing.assert_close(
        kraster.raster_topk(coeffs, bounds, 16, 16, 3, 2.0),
        kraster.raster_topk_plain(coeffs, bounds, 16, 16, 3, 2.0),
        atol=0, rtol=0)
    assert {**kconv.LAUNCHES, **kraster.LAUNCHES} == before


def test_wrappers_reject_bad_operands():
    x = torch.zeros(1, 4, 4, 8)
    with pytest.raises(ValueError):
        kconv.conv3x3_nhwc(x, torch.zeros(3, 3, 4, 8), torch.zeros(8))
    with pytest.raises(ValueError):
        kconv.conv3x3_nhwc(x, torch.zeros(3, 3, 8, 8), torch.zeros(4))
    with pytest.raises(ValueError):
        kraster.raster_hard(torch.zeros(1, 12, 128), torch.zeros(1, 2, 1),
                            4, 4)
    coeffs = torch.zeros(1, 20, 128)
    with pytest.raises(ValueError):
        kraster.raster_soft(coeffs, torch.zeros(1, 2, 2), 4, 4, 8.0, 256)
    with pytest.raises(ValueError):
        kraster.raster_stream(coeffs, torch.zeros(1, 2, 1),
                              torch.zeros(1, 3, 2, dtype=torch.int32),
                              4, 4, 256, False)
    with pytest.raises(ValueError):
        kraster.raster_topk(coeffs, torch.zeros(1, 2, 1), 4, 4, 17, 1.0)


def test_cuda_without_gpu_raises(monkeypatch, tmp_path):
    from st3d_torch.engine import pipelines

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        pipelines.resolve_device("cuda")
    cfg = pipelines.PipelineConfig(output_path=str(tmp_path / "o"),
                                   device="cuda")
    for run in (pipelines.run_second_approach, pipelines.run_first_approach):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            run(cfg)
    assert pipelines.resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("channels", [3, 4])
def test_png_round_trip_and_pillow_agree(tmp_path, channels):
    from PIL import Image

    img = (np.random.RandomState(1).rand(13, 17, channels) * 255).astype(
        np.uint8)
    path = str(tmp_path / "a.png")
    timg.write_png(path, img)
    np.testing.assert_array_equal(timg.read_png(path), img)
    with Image.open(path) as im:
        np.testing.assert_array_equal(np.asarray(im), img)
    # Pillow's writer uses the adaptive row filters; the reader undoes them.
    Image.fromarray(img).save(str(tmp_path / "b.png"))
    np.testing.assert_array_equal(timg.read_png(str(tmp_path / "b.png")), img)


@pytest.mark.parametrize("src,dst", [(40, 24), (24, 40), (64, 64), (31, 8)])
def test_resize_matches_jax_image_resize(src, dst):
    img = np.random.RandomState(2).rand(3, src, src).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(img), (3, dst, dst),
                                       "bilinear"))
    got = timg.resize_bilinear_chw(torch.tensor(img), dst).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_obj_round_trip_matches_jax_parser(tmp_path):
    from st3d.io.obj import load_obj as jax_load_obj

    mesh = ico_sphere(level=1, texture_size=8)
    path = str(tmp_path / "m" / "ico.obj")
    tobj.save_mesh(mesh, path)
    back = tobj.load_mesh(path)
    ref = jax_load_obj(path, use_native=False)
    np.testing.assert_array_equal(back.faces.numpy(), ref.faces)
    np.testing.assert_array_equal(back.verts.numpy(), ref.verts)
    np.testing.assert_array_equal(back.verts_uvs.numpy(), ref.verts_uvs)
    np.testing.assert_allclose(back.texture.numpy(),
                               mesh.texture.numpy(), atol=0.5 / 255 + 1e-7)
    tex = next(iter(ref.texture_images.values()))
    np.testing.assert_array_equal(back.texture.numpy(), tex)
