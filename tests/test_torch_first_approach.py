"""The first-approach slice: hot loop A (``style_transfer``), the first
approach's losses, logger and CLI, and ``run_first_approach`` end to end,
each held against its ``st3d`` counterpart on the CPU (the port's kernels
through their plain versions).

The end-to-end comparison uses camera seed 3. The final texture is fitted
by Adam, which scales each texel's step by that texel's own gradient size.
A texel whose gradient nearly cancels therefore amplifies the ~1e-6
difference between the port's visibility UVs and XLA's (XLA contracts the
jitted barycentrics into FMAs). At camera seeds 0-2, 3 to 6 texels of 12,288
end 1.5e-4 to 5e-4 apart. ``test_texture_gap_is_the_visibility_uv`` shows
that seed 2's gap closes to within 1e-4 once the port samples the JAX
package's UVs.
"""

import os

import numpy as np
import pytest
import torch

import st3d.models.vgg as jvgg
from st3d.engine import pipelines as jpipe
from st3d.engine.config import parse_first_approach as jax_parse

from st3d_torch.convert import vgg19_from_numpy
from st3d_torch.core.primitives import ico_sphere
from st3d_torch.engine import pipelines as tpipe
from st3d_torch.engine.config import PipelineConfig, parse_first_approach
from st3d_torch.first_approach import main
from st3d_torch.io.image import read_png, write_png
from st3d_torch.io.obj import save_mesh
from st3d_torch.models.vgg import save_vgg19_npz

SIZE = 64
ROUTES = {"default": {},
          "no_stage1_no_packed": {"ST3D_NO_STAGE1_V2": "1",
                                  "ST3D_NO_PACKED1": "1"}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the CPU. With torch's default of one thread per
    core they oversubscribe it, and at these sizes the thread pool's waits
    then cost more than the work (a 64² run took 150 times longer)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _set_route(monkeypatch, route):
    for k in ("ST3D_NO_STAGE1_V2", "ST3D_NO_PACKED1", "ST3D_STAGE1"):
        monkeypatch.delenv(k, raising=False)
    for k, v in ROUTES[route].items():
        monkeypatch.setenv(k, v)


def _read_log(path):
    """[(batch, step, loss)] of a first-approach ``log.txt``."""
    with open(os.path.join(path, "log.txt")) as f:
        lines = f.read().strip().splitlines()
    assert lines[0] == "Logger:"
    out = []
    for line in lines[1:]:
        b, s, l = (part.rsplit(" ", 1)[1] for part in line.split(", "))
        out.append((int(b), int(s), float(l)))
    return out


def _tree(path):
    return sorted(os.path.relpath(os.path.join(d, f), path)
                  for d, _, fs in os.walk(path) for f in fs)


@pytest.fixture(scope="module")
def models():
    jm = jvgg.init_random_vgg19(0)
    tm = vgg19_from_numpy([np.asarray(k) for k in jm.kernels],
                          [np.asarray(b) for b in jm.biases])
    return jm, tm


@pytest.fixture(scope="module")
def scene(tmp_path_factory, models):
    root = tmp_path_factory.mktemp("first")
    rng = np.random.RandomState(0)
    mesh = ico_sphere(level=2, texture_size=SIZE)
    mesh = mesh.replace(texture=torch.tensor(
        rng.rand(SIZE, SIZE, 3).astype(np.float32)))
    save_mesh(mesh, str(root / "scene" / "ico.obj"))
    write_png(str(root / "style.png"),
              (rng.rand(SIZE, SIZE, 3) * 255).astype(np.uint8))
    save_vgg19_npz(models[1], str(root / "vgg.npz"))
    argv = ["--obj_path", str(root / "scene" / "ico.obj"),
            "--style_path", str(root / "style.png"), "--size", str(SIZE),
            "--n_views", "2", "--batch_size", "2",
            "--n_style_transfer_steps", "5", "--n_mse_steps", "5",
            "--compute_dtype", "float32", "--vgg_weights",
            str(root / "vgg.npz")]
    return root, argv


@pytest.fixture(scope="module")
def jax_first(scene):
    root, argv = scene
    out = str(root / "jax")
    final = jpipe.run_first_approach(
        jax_parse(argv + ["--seed", "3", "--output_path", out]))
    return out, np.asarray(final.texture)


@pytest.mark.parametrize("route", list(ROUTES))
def test_first_approach_matches_jax(scene, jax_first, monkeypatch, route):
    """Losses within rel 1e-3 (the first within 1e-4), the final texture
    within atol 1e-4, the stylised views within one PNG level, and the same
    files as the JAX package writes, ``checkpoint.npz`` included."""
    root, argv = scene
    jax_out, tex_j = jax_first
    _set_route(monkeypatch, route)
    out = str(root / f"port_{route}")
    final = main(argv + ["--seed", "3", "--output_path", out,
                         "--device", "cpu"])

    lj, lt = _read_log(jax_out), _read_log(out)
    assert [r[:2] for r in lt] == [r[:2] for r in lj] == [
        (0, s) for s in range(5)]
    assert lt[0][2] == pytest.approx(lj[0][2], rel=1e-4)
    for a, b in zip(lt[1:], lj[1:]):
        assert a[2] == pytest.approx(b[2], rel=1e-3)
    assert lt[-1][2] < lt[0][2]
    np.testing.assert_allclose(final.texture.numpy(), tex_j, atol=1e-4)

    assert _tree(out) == _tree(jax_out)
    assert len(os.listdir(os.path.join(out, "final_render"))) == 12
    for j in range(2):
        name = os.path.join("2d_style_transfer", f"view_{j}.png")
        a = read_png(os.path.join(out, name)).astype(int)
        b = read_png(os.path.join(jax_out, name)).astype(int)
        assert np.abs(a - b).max() <= 1


def test_texture_gap_is_the_visibility_uv(scene, monkeypatch):
    """At camera seed 2 the textures end up to 5e-4 apart. With the port
    sampling the JAX package's (jitted) visibility UVs, the gap is within the
    end-to-end test's 1e-4."""
    from st3d.render.rasterize import RasterizationSettings as JaxSettings

    import jax

    root, argv = scene
    argv = argv + ["--seed", "2"]
    final_j = jpipe.run_first_approach(
        jax_parse(argv + ["--output_path", str(root / "jax_seed2")]))
    jc = jax_parse(argv)
    uv_j = jax.jit(lambda m, c: jpipe.precompute_visibility(
        m, c, JaxSettings(image_size=SIZE)))(
            jpipe.load_scene(jc), jpipe.build_cameras(jc)[0:2])["uv"]
    real = tpipe.precompute_visibility

    def with_jax_uv(mesh, cams, settings):
        vis = real(mesh, cams, settings)
        uv = torch.tensor(np.asarray(uv_j))
        covered = vis["mask"].bool()
        assert float((vis["uv"] - uv).abs()[covered].max()) < 1e-5
        vis["uv"] = uv
        return vis

    monkeypatch.setattr(tpipe, "precompute_visibility", with_jax_uv)
    final_t = main(argv + ["--output_path", str(root / "port_seed2"),
                           "--device", "cpu"])
    np.testing.assert_allclose(final_t.texture.numpy(),
                               np.asarray(final_j.texture), atol=1e-4)


@pytest.mark.parametrize("init", ["noise", "current"])
def test_other_inits_run(scene, init):
    root, argv = scene
    out = str(root / f"init_{init}")
    main(argv + ["--output_path", out, "--device", "cpu",
                 "--style_transfer_init", init, "--n_style_transfer_steps",
                 "1", "--n_mse_steps", "2"])
    losses = [r[2] for r in _read_log(out)]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert sorted(os.listdir(os.path.join(out, "2d_style_transfer"))) == [
        "view_0.png", "view_1.png"]


# ---------------------------------------------------------------------------
# Hot loop A
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", list(ROUTES))
def test_style_transfer_matches_jax(models, monkeypatch, route):
    """Five Adam steps on the pixels, float32: within atol 1e-5 of the JAX
    package (pixels in [0, 1]; each step moves a pixel by at most lr=0.01,
    and the gradients agree to reassociation)."""
    import jax.numpy as jnp

    from st3d.engine.style_transfer2d import style_transfer as jax_st

    from st3d_torch.engine.style_transfer2d import style_transfer

    jm, tm = models
    _set_route(monkeypatch, route)
    rng = np.random.RandomState(3)
    content, style = (rng.rand(2, 3, 32, 32).astype(np.float32)
                      for _ in range(2))
    init = np.clip(content + 0.1 * rng.randn(*content.shape), 0, 1).astype(
        np.float32)
    want = np.asarray(jax_st(jnp.asarray(init), jnp.asarray(content),
                             jnp.asarray(style), jm, steps=5, lr=0.01,
                             progress=False))
    got = style_transfer(torch.tensor(init), torch.tensor(content),
                         torch.tensor(style), tm, steps=5, lr=0.01)
    assert got.shape == (2, 3, 32, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert np.abs(want - init).max() > 1e-3          # the pixels moved


def test_style_transfer_bf16_keeps_a_float32_buffer(models):
    from st3d_torch.engine.style_transfer2d import style_transfer

    _, tm = models
    rng = np.random.RandomState(4)
    content, style = (torch.tensor(rng.rand(1, 3, 16, 16).astype(np.float32))
                      for _ in range(2))
    got = style_transfer(content, content, style, tm, steps=2, lr=0.01,
                         dtype=torch.bfloat16)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert float((got - content).abs().max()) > 0


# ---------------------------------------------------------------------------
# Losses, logger, CLI
# ---------------------------------------------------------------------------

def test_perceptual_loss_matches_jax(models):
    import jax.numpy as jnp

    from st3d.ops.losses import compute_perceptual_loss as jax_loss

    from st3d_torch.ops.losses import compute_perceptual_loss

    jm, tm = models
    rng = np.random.RandomState(5)
    imgs = [rng.rand(2, 3, 16, 16).astype(np.float32) for _ in range(3)]
    want = float(jax_loss(*map(jnp.asarray, imgs), jm))
    got = float(compute_perceptual_loss(*map(torch.tensor, imgs), tm))
    assert got == pytest.approx(want, rel=1e-5)


def test_first_approach_loss_matches_jax():
    """The masked MSE (texture target, main_loss_weight ignored) and, for
    the mesh and both targets, main_loss_weight times it plus the mesh
    regularizers, on one ico-sphere with its topology in both packages."""
    import jax.numpy as jnp

    from st3d.core.primitives import ico_sphere as jax_ico_sphere
    from st3d.ops.losses import compute_first_approach_loss as jax_loss

    from st3d_torch.convert import mesh_from_numpy
    from st3d_torch.ops.losses import compute_first_approach_loss

    rng = np.random.RandomState(6)
    r, t = (rng.rand(2, 8, 8, 3).astype(np.float32) for _ in range(2))
    m = (rng.rand(2, 8, 8, 1) > 0.3).astype(np.float32)
    weights = PipelineConfig().loss_weights()
    weights["main_loss_weight"] = 2.5
    jm = jax_ico_sphere(level=1).with_topology()
    verts = np.asarray(jm.verts) + 0.05 * rng.randn(
        *jm.verts.shape).astype(np.float32)
    tm = mesh_from_numpy(verts, jm.faces, jm.verts_uvs, jm.faces_uvs,
                         jm.texture, topology=jm.topology)
    jmv = jm.replace(verts=jnp.asarray(verts))
    for target in ("texture", "mesh", "both"):
        want = float(jax_loss(jnp.asarray(r), jnp.asarray(m), jnp.asarray(t),
                              jnp.asarray(verts), jm.verts, jmv, weights,
                              target))
        got = float(compute_first_approach_loss(
            torch.tensor(r), torch.tensor(m), torch.tensor(t), tm.verts,
            torch.tensor(np.asarray(jm.verts)), tm, weights, target))
        assert got == pytest.approx(want, rel=1e-5), target
    with pytest.raises(ValueError):
        compute_first_approach_loss(torch.tensor(r), torch.tensor(m),
                                    torch.tensor(t), None, None, None,
                                    weights, "uv")


def test_log_step_matches_jax(tmp_path):
    from st3d.utils.logging import RunLogger as JaxLogger

    from st3d_torch.utils.logging import RunLogger

    for cls, name in ((JaxLogger, "jax"), (RunLogger, "port")):
        lg = cls(str(tmp_path / name))
        lg.log_step(0, 3, 0.25)
        lg.log_step(1, 0, 1.5e-05)
        lg.close()
    with open(tmp_path / "jax" / "log.txt") as a, \
            open(tmp_path / "port" / "log.txt") as b:
        assert a.read() == b.read()


def test_flags_and_defaults_match_jax():
    """Same flags and defaults as the JAX first-approach CLI, plus
    --device and --loss (whose one value here is the Gram loss)."""
    from st3d.engine.config import PipelineConfig as JaxConfig

    port, ref = parse_first_approach([]), jax_parse([])
    for f in JaxConfig.__dataclass_fields__:
        assert getattr(port, f) == getattr(ref, f), f
    assert port.device == "cuda"
    assert port.loss_weights() == ref.loss_weights()
    argv = ["--n_mse_steps", "7", "--style_transfer_init", "noise",
            "--mse_lr", "0.5", "--style_transfer_lr", "0.2"]
    assert parse_first_approach(argv).__dict__ == {
        **jax_parse(argv).__dict__, "device": "cuda", "loss": "gram"}
    with pytest.raises(SystemExit):
        parse_first_approach(["--style_transfer_init", "random"])


@pytest.mark.parametrize("flag", [
    ["--soft_raster", "True", "--tile_parallel", "True"],
    ["--data_parallel", "True"],
    ["--tile_parallel", "True"]])
def test_parallel_flags_run_in_a_world_of_one(scene, flag):
    """Without ``torchrun`` the process is a world of 1, where
    ``--data_parallel`` and ``--tile_parallel`` take the plain path (as the
    JAX package does on one device): the same log and final texture as
    the run without the flag."""
    root, argv = scene
    name = "_".join(flag).replace("-", "")
    base = argv + ["--device", "cpu"] + flag[:-2]
    plain = main(base + ["--output_path", str(root / f"plain{name}")])
    got = main(base + flag[-2:] + ["--output_path", str(root / name)])
    assert _read_log(str(root / name)) == _read_log(str(root / f"plain{name}"))
    assert torch.equal(got.texture, plain.texture)
