"""The second-approach slice end to end: the same OBJ+MTL+PNG scene, style
PNG and VGG weights through ``st3d.engine.pipelines.run_second_approach``
(JAX, CPU) and ``st3d_torch.second_approach.main`` (port, CPU, the kernels'
plain versions): losses, final texture and output layout; and the port on
its opt-in VGG routes (``ST3D_STAGE1=v3``, ``ST3D_FUSED_POOL=1``) against
the same JAX run. On the CPU the JAX package takes its XLA path whatever
the switches say, and every route computes the same function in float32:
losses within rtol 1e-4 first and 1e-3 after (the reassociated sums move
Adam's steps), textures within 1e-4."""

import os

import numpy as np
import pytest
import torch

import st3d.models.vgg as jvgg
from st3d.engine.config import parse_second_approach as jax_parse
from st3d.engine.pipelines import run_second_approach as jax_run

from st3d_torch.convert import vgg19_from_numpy
from st3d_torch.core.primitives import ico_sphere
from st3d_torch.engine.config import PipelineConfig, parse_second_approach
from st3d_torch.io.image import write_png
from st3d_torch.io.obj import save_mesh
from st3d_torch.models.vgg import save_vgg19_npz
from st3d_torch.second_approach import main

SIZE = 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the CPU. With torch's default of one thread per
    core they oversubscribe it, and at these sizes the thread pool's waits
    then cost more than the work (a 64² run took 150 times longer)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _read_log(path):
    with open(path) as f:
        lines = f.read().strip().splitlines()
    assert lines[0] == "Logger:"
    return [float(l.rsplit(" ", 1)[1]) for l in lines[1:]]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("slice")
    rng = np.random.RandomState(0)
    mesh = ico_sphere(level=2, texture_size=SIZE)
    mesh = mesh.replace(texture=torch.tensor(
        rng.rand(SIZE, SIZE, 3).astype(np.float32)))
    save_mesh(mesh, str(root / "scene" / "ico.obj"))
    write_png(str(root / "style.png"),
              (rng.rand(SIZE, SIZE, 3) * 255).astype(np.uint8))
    jm = jvgg.init_random_vgg19(0)
    save_vgg19_npz(vgg19_from_numpy(jm.kernels, jm.biases),
                   str(root / "vgg.npz"))
    argv = ["--obj_path", str(root / "scene" / "ico.obj"),
            "--style_path", str(root / "style.png"), "--size", str(SIZE),
            "--n_views", "2", "--batch_size", "2", "--epochs", "3",
            "--compute_dtype", "float32", "--save_intermediate", "False",
            "--vgg_weights", str(root / "vgg.npz")]
    return root, argv


@pytest.fixture(scope="module")
def jax_result(scene):
    root, argv = scene
    jax_out = str(root / "jax")
    final_j = jax_run(jax_parse(argv + ["--output_path", jax_out]))
    return jax_out, final_j


def _port_matches_jax(jax_result, argv, port_out):
    jax_out, final_j = jax_result
    final_t = main(argv + ["--output_path", port_out, "--device", "cpu"])
    lj = _read_log(os.path.join(jax_out, "log.txt"))
    lt = _read_log(os.path.join(port_out, "log.txt"))
    assert len(lj) == len(lt) == 3
    assert lt[0] == pytest.approx(lj[0], rel=1e-4)
    for a, b in zip(lt[1:], lj[1:]):
        assert a == pytest.approx(b, rel=1e-3)
    assert lt[-1] < lt[0]
    np.testing.assert_allclose(final_t.texture.numpy(),
                               np.asarray(final_j.texture), atol=1e-4)


def test_slice_matches_jax(scene, jax_result):
    root, argv = scene
    jax_out, port_out = jax_result[0], str(root / "port")
    _port_matches_jax(jax_result, argv, port_out)
    for out in (jax_out, port_out):
        for name in ("final.obj", "final.mtl", "final_texture.png",
                     "metrics.jsonl"):
            assert os.path.isfile(os.path.join(out, name)), (out, name)
        assert len(os.listdir(os.path.join(out, "final_render"))) == 12


@pytest.mark.parametrize("route,env", [
    ("v3", {"ST3D_STAGE1": "v3"}),
    ("fused_pool", {"ST3D_FUSED_POOL": "1"}),
])
def test_slice_routes_match_jax(scene, jax_result, monkeypatch, route, env):
    root, argv = scene
    for k in ("ST3D_NO_STAGE1_V2", "ST3D_NO_PACKED1", "ST3D_STAGE1",
              "ST3D_FUSED_POOL"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    _port_matches_jax(jax_result, argv, str(root / f"port_{route}"))


def test_save_intermediate_writes_current_images(scene):
    root, argv = scene
    out = str(root / "port_si")
    argv = [a if a != "False" else "True" for a in argv]
    main(argv + ["--output_path", out, "--device", "cpu", "--epochs", "1"])
    assert sorted(os.listdir(os.path.join(out, "current_images"))) == [
        "view_0.png", "view_1.png"]


@pytest.mark.parametrize("content_bg,current_bg", [("noise", "style"),
                                                   ("style", "noise")])
def test_backgrounds_run(scene, content_bg, current_bg):
    root, argv = scene
    out = str(root / f"bg_{content_bg}_{current_bg}")
    main(argv + ["--output_path", out, "--device", "cpu", "--epochs", "2",
                 "--content_background", content_bg,
                 "--current_background", current_bg])
    losses = _read_log(os.path.join(out, "log.txt"))
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_flags_and_defaults_match_jax():
    """Same flags and defaults as the JAX CLI, plus --device."""
    from st3d.engine.config import PipelineConfig as JaxConfig

    port = parse_second_approach([])
    ref = jax_parse([])
    for f in JaxConfig.__dataclass_fields__:
        assert getattr(port, f) == getattr(ref, f), f
    assert port.device == "cuda"
    assert set(PipelineConfig.__dataclass_fields__) - set(
        JaxConfig.__dataclass_fields__) == {"device"}
    with pytest.raises(SystemExit):
        parse_second_approach(["--randomize_views", "maybe"])


@pytest.mark.parametrize("flag", [
    ["--data_parallel", "True"],
    ["--optimization_target", "mesh", "--tile_parallel", "True"]])
def test_parallel_flags_run_in_a_world_of_one(scene, flag):
    """Without ``torchrun`` the process is a world of 1, where both flags
    take the plain path: the same log and final mesh as without them."""
    root, argv = scene
    name = "_".join(flag).replace("-", "")
    base = argv + ["--device", "cpu"] + flag[:-2]
    plain = main(base + ["--output_path", str(root / f"plain{name}")])
    got = main(base + flag[-2:] + ["--output_path", str(root / name)])
    assert _read_log(os.path.join(root, name, "log.txt")) == _read_log(
        os.path.join(root, f"plain{name}", "log.txt"))
    assert torch.equal(got.texture, plain.texture)
    assert torch.equal(got.verts, plain.verts)
