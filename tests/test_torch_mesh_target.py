"""The mesh and both optimisation targets against the JAX package: the
topology precompute (including a non-manifold edge), the three mesh
regularizers with their vertex gradients, and both pipelines end to end on
the same synthetic scene (ico-sphere level 2, 64², two views, float32), the
visibility re-rasterised every step. The JAX runs use the Pallas
rasterizer in interpret mode, whose chunk culling the port's kernels
share."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import st3d.models.vgg as jvgg
from st3d.core.mesh import build_mesh as jax_build_mesh
from st3d.core.mesh import compute_topology as jax_topology
from st3d.core.primitives import ico_sphere as jax_ico_sphere
from st3d.engine import pipelines as jpipe
from st3d.engine.config import parse_first_approach as jax_parse_first
from st3d.engine.config import parse_second_approach as jax_parse_second
from st3d.ops import losses as jl

from st3d_torch.convert import mesh_from_numpy, vgg19_from_numpy
from st3d_torch.core.mesh import compute_topology
from st3d_torch.core.primitives import ico_sphere
from st3d_torch.first_approach import main as first_main
from st3d_torch.io.image import write_png
from st3d_torch.io.obj import load_obj, save_mesh
from st3d_torch.models.vgg import save_vgg19_npz
from st3d_torch.ops import losses as tl
from st3d_torch.second_approach import main as second_main

SIZE = 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the CPU; torch's default thread pool would
    oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _non_manifold():
    """A fan of three triangles on edge (0, 1) plus a fourth face: edge
    (0, 1) is shared by n = 3 faces, so it yields C(3, 2) = 3 pairs."""
    verts = np.array([[0, 0, 0], [1, 0, 0], [0.5, 1, 0], [0.5, -1, 0.2],
                      [0.5, 0.2, 1], [1.5, 1, 0.1]], np.float32)
    faces = np.array([[0, 1, 2], [1, 0, 3], [0, 1, 4], [1, 5, 2]])
    return verts, faces


@pytest.mark.parametrize("which", ["ico0", "ico2", "non_manifold"])
def test_topology_matches_jax(which):
    if which == "non_manifold":
        verts, faces = _non_manifold()
    else:
        m = jax_ico_sphere(level=int(which[-1]))
        verts, faces = np.asarray(m.verts), np.asarray(m.faces)
    got = compute_topology(faces, len(verts))
    want = jax_topology(faces, len(verts))
    for f in ("edges", "degree", "nc_pairs"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    if which == "non_manifold":
        assert got.nc_pairs.shape == (4, 4)
        assert (got.nc_pairs[:, :2] == torch.tensor([0, 1])).all(1).sum() == 3


def test_with_topology_follows_the_mesh():
    mesh = ico_sphere(level=1)
    assert mesh.topology is None
    topo = mesh.with_topology()
    assert topo.with_topology() is topo
    assert topo.topology.edges.shape == (120, 2)
    moved = topo.replace(verts=topo.verts + 1.0)
    assert moved.topology is topo.topology
    assert topo.to("cpu").topology.degree.dtype == torch.float32


@pytest.mark.parametrize("which", ["ico2", "non_manifold"])
def test_regularizers_match_jax(which):
    """Each regularizer and their weighted sum: values within rel 1e-5 and
    vertex gradients within 1e-5 of the largest (float32 sums in another
    order)."""
    rng = np.random.RandomState(1)
    if which == "non_manifold":
        verts, faces = _non_manifold()
    else:
        m = jax_ico_sphere(level=2)
        verts, faces = np.asarray(m.verts), np.asarray(m.faces)
    verts = verts + 0.05 * rng.randn(*verts.shape).astype(np.float32)
    uv = np.zeros((1, 2), np.float32)
    tex = np.zeros((2, 2, 3), np.float32)
    fuv = np.zeros_like(faces)
    jm = jax_build_mesh(uv, fuv, tex, verts, faces, with_topology=True)
    tm = mesh_from_numpy(verts, faces, uv, fuv, tex).with_topology()
    target = verts + 0.01
    weights = {"mesh_verts_weight": 1.3, "mesh_edge_loss_weight": 0.7,
               "mesh_laplacian_smoothing_weight": 1.1,
               "mesh_normal_consistency_weight": 0.9}
    fns = {
        "edge": (lambda m, v: jl.mesh_edge_loss(m.replace(verts=v)),
                 lambda m, v: tl.mesh_edge_loss(m.replace(verts=v))),
        "laplacian": (
            lambda m, v: jl.mesh_laplacian_smoothing(m.replace(verts=v)),
            lambda m, v: tl.mesh_laplacian_smoothing(m.replace(verts=v))),
        "normal": (
            lambda m, v: jl.mesh_normal_consistency(m.replace(verts=v)),
            lambda m, v: tl.mesh_normal_consistency(m.replace(verts=v))),
        "total": (
            lambda m, v: jl.mesh_regularizer_loss(
                m.replace(verts=v), v, jnp.asarray(target), weights),
            lambda m, v: tl.mesh_regularizer_loss(
                m.replace(verts=v), v, torch.tensor(target), weights)),
    }
    for name, (jf, tf) in fns.items():
        want, g_want = jax.value_and_grad(lambda v: jf(jm, v))(
            jnp.asarray(verts))
        v = torch.tensor(verts, requires_grad=True)
        got = tf(tm, v)
        got.backward()
        assert float(got) == pytest.approx(float(want), rel=1e-5), name
        g = np.asarray(g_want)
        np.testing.assert_allclose(v.grad.numpy(), g, rtol=0,
                                   atol=1e-5 * float(np.abs(g).max()),
                                   err_msg=name)


def test_regularizers_need_topology():
    mesh = ico_sphere(level=0)
    with pytest.raises(ValueError, match="with_topology"):
        tl.mesh_edge_loss(mesh)


@pytest.mark.parametrize("with_targets", [False, True])
def test_second_approach_loss_matches_jax(with_targets):
    """The perceptual loss (texture target, main_loss_weight ignored) and,
    for the mesh and both targets, main_loss_weight times it plus the mesh
    regularizers, with the features extracted here or from precomputed
    targets: within rel 1e-5 (float32 sums in another order)."""
    rng = np.random.RandomState(7)
    cur, content, style = (rng.rand(2, 3, 16, 16).astype(np.float32)
                           for _ in range(3))
    jvg = jvgg.init_random_vgg19(0)
    tvg = vgg19_from_numpy([np.asarray(k) for k in jvg.kernels],
                           [np.asarray(b) for b in jvg.biases])
    jm = jax_ico_sphere(level=1).with_topology()
    verts = np.asarray(jm.verts) + 0.05 * rng.randn(
        *jm.verts.shape).astype(np.float32)
    tm = mesh_from_numpy(verts, jm.faces, jm.verts_uvs, jm.faces_uvs,
                         jm.texture, topology=jm.topology)
    jmv = jm.replace(verts=jnp.asarray(verts))
    weights = {"mesh_verts_weight": 1.0, "mesh_edge_loss_weight": 1.0,
               "mesh_laplacian_smoothing_weight": 1.0,
               "mesh_normal_consistency_weight": 1.0,
               "main_loss_weight": 2.5e-6}
    jt = tt = None
    if with_targets:
        jt = jl.StyleContentTargets.create(jnp.asarray(content),
                                           jnp.asarray(style), jvg)
        tt = tl.StyleContentTargets.create(torch.tensor(content),
                                           torch.tensor(style), tvg)
    for target in ("texture", "mesh", "both"):
        want = float(jl.compute_second_approach_loss(
            jnp.asarray(cur), jnp.asarray(content), jnp.asarray(style), jvg,
            1e6, 1.0, jnp.asarray(verts), jm.verts, jmv, weights, target,
            targets=jt))
        got = float(tl.compute_second_approach_loss(
            torch.tensor(cur), torch.tensor(content), torch.tensor(style),
            tvg, 1e6, 1.0, tm.verts, torch.tensor(np.asarray(jm.verts)), tm,
            weights, target, targets=tt))
        assert got == pytest.approx(want, rel=1e-5), target
    with pytest.raises(ValueError):
        tl.compute_second_approach_loss(
            torch.tensor(cur), torch.tensor(content), torch.tensor(style),
            tvg, 1e6, 1.0, tm.verts, tm.verts, tm, weights, "uv")


# ---------------------------------------------------------------------------
# End to end
# ---------------------------------------------------------------------------

def _read_log(path):
    with open(os.path.join(path, "log.txt")) as f:
        lines = f.read().strip().splitlines()
    assert lines[0] == "Logger:"
    return [float(l.rsplit(" ", 1)[1]) for l in lines[1:]]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_target")
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
            "--n_views", "2", "--batch_size", "2", "--compute_dtype",
            "float32", "--vgg_weights", str(root / "vgg.npz"),
            "--raster_backend", "pallas"]
    return root, argv


def _input_verts(root):
    return load_obj(str(root / "scene" / "ico.obj"),
                    load_textures=False).verts


def _displacement_gap(final_t, final_j, v0):
    """|port displacement - JAX displacement|_1 over |JAX displacement|_1.

    Adam divides each coordinate's step by that coordinate's own gradient
    size. Where symmetry makes a gradient cancel to rounding noise (about
    6% of the sphere's coordinates), the step is set by that noise and the
    two packages' float32 sums give different ones, up to a whole step of
    lr in either direction; elsewhere the vertices agree to 1e-5. So the
    vertices are held in the aggregate."""
    dj = np.asarray(final_j.verts) - v0
    dt = final_t.verts.numpy() - v0
    return float(np.abs(dt - dj).sum() / np.abs(dj).sum())


@pytest.mark.parametrize("target,mode,rel,gap", [
    ("both", [], 1e-3, 0.05), ("mesh", ["--soft_raster", "True"], 3e-3, 0.2)])
def test_second_approach_matches_jax(scene, target, mode, rel, gap):
    """Three epochs re-rasterised every step: losses per epoch within
    ``rel`` and the vertex displacements within ``gap`` in the aggregate
    (``_displacement_gap``). Hard mode's losses agree to 1e-4 at the first
    epoch and 1e-3 after, its displacements to 5%. Soft mode's first loss
    is already 1e-3 apart (measured 9.6e-4) and its displacements 10%: the
    two projections differ in the last bits, which flips the nearest face
    at near-ties of the ring pixels (test_render_rgba_matches_jax), and
    each flip moves the gradients of the vertices around it."""
    root, argv = scene
    name = f"{target}_{'soft' if mode else 'hard'}"
    argv = argv + ["--epochs", "3", "--save_intermediate", "False",
                   "--optimization_target", target] + mode
    jax_out, port_out = str(root / f"jax_{name}"), str(root / f"port_{name}")
    final_j = jpipe.run_second_approach(
        jax_parse_second(argv + ["--output_path", jax_out]))
    final_t = second_main(argv + ["--output_path", port_out, "--device",
                                  "cpu"])
    lj, lt = _read_log(jax_out), _read_log(port_out)
    assert len(lj) == len(lt) == 3
    if not mode:
        assert lt[0] == pytest.approx(lj[0], rel=1e-4)
    for a, b in zip(lt, lj):
        assert a == pytest.approx(b, rel=rel)
    assert lt[-1] < lt[0]
    v0 = _input_verts(root)
    assert _displacement_gap(final_t, final_j, v0) < gap
    moved = load_obj(os.path.join(port_out, "final.obj"),
                     load_textures=False).verts
    assert np.abs(moved - v0).max() > 1e-2
    if target == "mesh":
        np.testing.assert_array_equal(final_t.texture.numpy(),
                                      np.asarray(final_j.texture))


def test_first_approach_both_matches_jax(scene):
    """Two style-transfer and three MSE steps on the both target: losses
    per step within rel 1e-3 (the first within 1e-4), the vertex
    displacements within 5% in the aggregate, the texture within 5e-4
    (Adam's per-texel step amplifies the ~1e-6 visibility-UV differences
    where a texel's gradient nearly cancels; test_torch_first_approach's
    module docstring measures 1.5e-4 to 5e-4 on the texture target)."""
    root, argv = scene
    argv = argv + ["--n_style_transfer_steps", "2", "--n_mse_steps", "3",
                   "--optimization_target", "both"]
    jax_out, port_out = str(root / "jax_first"), str(root / "port_first")
    final_j = jpipe.run_first_approach(
        jax_parse_first(argv + ["--output_path", jax_out]))
    final_t = first_main(argv + ["--output_path", port_out, "--device",
                                 "cpu"])
    lj, lt = _read_log(jax_out), _read_log(port_out)
    assert len(lj) == len(lt) == 3
    assert lt[0] == pytest.approx(lj[0], rel=1e-4)
    for a, b in zip(lt[1:], lj[1:]):
        assert a == pytest.approx(b, rel=1e-3)
    assert _displacement_gap(final_t, final_j, _input_verts(root)) < 0.05
    np.testing.assert_allclose(final_t.texture.numpy(),
                               np.asarray(final_j.texture), atol=5e-4)


@pytest.mark.parametrize("mode", [
    ["--soft_raster", "True", "--faces_per_pixel", "3"],
    ["--blur_radius", "4e-4", "--faces_per_pixel", "2"]])
def test_top_k_modes_move_the_vertices(scene, mode):
    """SoftRas (K7 every step) and the hard blur window (K7 with slack
    slots): finite falling losses, moved vertices in final.obj."""
    root, argv = scene
    out = str(root / f"port_topk_{mode[1]}")
    second_main(argv + ["--epochs", "3", "--save_intermediate", "False",
                        "--optimization_target", "both", "--device", "cpu",
                        "--output_path", out] + mode)
    losses = _read_log(out)
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    moved = load_obj(os.path.join(out, "final.obj"),
                     load_textures=False).verts
    assert np.abs(moved - _input_verts(root)).max() > 1e-2
