"""The plain reference held to the port's CPU path at 64², and ``correct``
seen false for the control and for each fault a cell can have.

The tests may import the port; the reference may not
(``test_portbench_isolation``). On a CPU the port runs its kernels' plain
versions, in float32: the cells here take the float32 configuration with
each mix, judged by the float32 texture cell's limits.
"""

import copy
import os
import tempfile
import time

import numpy as np
import pytest
import torch

from portbench import cells, harness, judge
from portbench.inputs import make_inputs
from portbench.reference import camera, follow, loss, render, vgg

SIZE = 64
CPU = torch.device("cpu")
GRAM = cells.load_loss(cells.ROOT, "gram")
MIXES = ("texture", "both-hard", "styles3")


# Texture and vertices, K1 every step, the regularizers at the reference's
# weights: a mix no cell runs yet (PERF.md, Open questions), tested here
# for the vertex target's reference.
VERTEX_MIX = {
    "entry": "second_approach", "styles": 1, "warmup_epochs": 3,
    "flags": {"optimization_target": "both", "soft_raster": False,
              "faces_per_pixel": 1, "blur_radius": 0.0,
              "main_loss_weight": 3.0, "mesh_edge_loss_weight": 1.0,
              "mesh_laplacian_smoothing_weight": 1.0,
              "mesh_normal_consistency_weight": 1.0,
              "mesh_verts_weight": 1.0}}


def tiny(mix: str, size: int = SIZE, dtype: str = "float32") -> cells.Cell:
    """The ``dtype`` configuration with ``mix`` at ``size``², 4 views in
    batches of 2, on a level-3 sphere, judged by the float32 texture
    cell's limits."""
    base = cells.resolve("vgg19-768x6-f32.texture")
    bench = cells._load(os.path.join(cells.ROOT, "BENCHMARK.json"))
    cell = copy.deepcopy(base)
    cell.name = f"vgg19-{size}x4-{dtype}.{mix}"
    cell.mix = copy.deepcopy(VERTEX_MIX) if mix == "both-hard" else (
        cells._load(os.path.join(cells.BENCH_DIR, "mixes", mix + ".json")))
    cell.config["flags"]["compute_dtype"] = dtype
    cell.config["flags"].update(size=size, n_views=4, batch_size=2)
    cell.config["scene"]["ico_level"] = 3
    cell.per_layer = bench["per_layer"]
    return cell


@pytest.fixture(scope="module")
def scene():
    with tempfile.TemporaryDirectory() as d:
        yield make_inputs(d, 2 ** 31 + 11, SIZE, 1, 3, CPU)


def test_rig_and_projection_match_the_port(scene):
    from st3d_torch.core.cameras import (
        build_random_cameras,
        transform_points_screen,
    )

    cams = build_random_cameras(6, seed=12345)
    R, T = camera.random_rig(6, 12345)
    torch.testing.assert_close(R, cams.R, rtol=0, atol=2e-6)
    torch.testing.assert_close(T, cams.T, rtol=0, atol=2e-6)
    v = torch.as_tensor(scene.verts)
    torch.testing.assert_close(camera.to_screen(v, R, T, SIZE),
                               transform_points_screen(cams, v, (SIZE, SIZE)),
                               rtol=1e-5, atol=1e-4)


def test_raster_and_shading_match_the_port(scene):
    from st3d_torch.core.cameras import build_random_cameras
    from st3d_torch.kernels.raster import rasterize_batched
    from st3d_torch.render.rasterize import face_verts_screen
    from st3d_torch.render.shading import shade_textured

    R, T = camera.random_rig(4, 7)
    v = torch.as_tensor(scene.verts)
    faces = torch.as_tensor(scene.faces)
    scr = camera.to_screen(v, R, T, SIZE)
    p2f = render.rasterize(scr, faces, SIZE).reshape(4, SIZE, SIZE)
    fv = face_verts_screen(v, faces, build_random_cameras(4, seed=7), SIZE)
    port, _ = rasterize_batched(fv, SIZE)
    assert torch.equal(p2f, port.long())
    same = p2f == port.long()
    uvs = torch.as_tensor(scene.verts_uvs)
    fuv = torch.as_tensor(scene.faces_uvs)
    tex = torch.as_tensor(scene.texture).float() / 255.0
    img, _ = render.render(scr, faces, uvs[fuv], tex, SIZE,
                           p2f.reshape(4, -1))
    ref = shade_textured(fv, port, uvs, fuv, tex)[..., :3].permute(0, 3, 1, 2)
    diff = (img - ref).abs().amax(dim=1)
    assert float(diff[same].max()) < 1e-4


def test_vgg_taps_and_loss_match_the_port(scene):
    from st3d_torch.models.vgg import load_vgg19_npz, get_features
    from st3d_torch.ops.losses import StyleContentTargets, style_content_loss

    x = torch.rand((2, 3, SIZE, SIZE), generator=torch.Generator()
                   .manual_seed(3))
    s = torch.rand((2, 3, SIZE, SIZE), generator=torch.Generator()
                   .manual_seed(4))
    c = torch.rand((2, 3, SIZE, SIZE), generator=torch.Generator()
                   .manual_seed(5))
    with tempfile.TemporaryDirectory() as d:
        np.savez(os.path.join(d, "w.npz"), **scene.vgg)
        model = load_vgg19_npz(os.path.join(d, "w.npz"))
    w = vgg.load_weights(scene.vgg, CPU)
    ours = vgg.taps(x, w, GRAM.TAPS)
    theirs = get_features(x, model)
    assert set(ours) == set(GRAM.TAPS)
    for k in GRAM.TAPS:
        torch.testing.assert_close(ours[k], theirs[k], rtol=1e-4, atol=1e-4)
    tg = StyleContentTargets.create(c, s, model)
    want = style_content_loss(get_features(x, model), tg, 1e6, 1.0)
    grams = {t: GRAM.gram(vgg.taps(s, w, GRAM.TAPS)[t])
             for t in GRAM.STYLE_TAPS}
    got = GRAM.style_content(ours, vgg.taps(c, w, GRAM.TAPS)[
        GRAM.CONTENT_TAP], grams, 1e6, 1.0)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=0)


def test_regularizers_match_the_port(scene):
    from st3d_torch.core.mesh import compute_topology, Mesh
    from st3d_torch.ops.losses import mesh_regularizer_loss

    v0 = torch.as_tensor(scene.verts)
    v = v0 + 0.01 * torch.randn(v0.shape, generator=torch.Generator()
                                .manual_seed(1))
    faces = torch.as_tensor(scene.faces)
    w = {"mesh_verts_weight": 1.0, "mesh_edge_loss_weight": 1.0,
         "mesh_laplacian_smoothing_weight": 1.0,
         "mesh_normal_consistency_weight": 1.0}
    mesh = Mesh(verts=v, faces=faces, verts_uvs=torch.zeros(1, 2),
                faces_uvs=torch.zeros_like(faces), texture=torch.zeros(2, 2, 3),
                topology=compute_topology(scene.faces, len(v)))
    want = mesh_regularizer_loss(mesh, v, v0, w)
    got = loss.regularizers(v, v0, loss.Topology(scene.faces, len(v), CPU), w)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7)


def test_adam_matches_torch():
    g = torch.Generator().manual_seed(0)
    p0 = torch.randn(50, generator=g)
    ours = {"p": p0.clone()}
    opt = follow.Adam(ours, 0.01)
    leaf = p0.clone().requires_grad_(True)
    theirs = torch.optim.Adam([leaf], lr=0.01)
    for _ in range(3):
        grad = torch.randn(50, generator=g)
        opt.step({"p": grad})
        leaf.grad = grad.clone()
        theirs.step()
    torch.testing.assert_close(ours["p"], leaf.detach(), rtol=1e-6, atol=1e-7)


def _run(cell, seed=2 ** 31 + 3):
    return harness.run_cell(cell, seed, 0.5, False, CPU, time.perf_counter(),
                            lambda m: None)


@pytest.mark.parametrize("mix", MIXES)
def test_the_port_on_the_cpu_is_correct(mix):
    r = _run(tiny(mix))
    assert r["correct"], r["compared"]
    assert r["attempted"] > 0 and r["failed"] == 0
    # The window's epochs vary with the host's load; a p95 needs two.
    assert {"setup_s", "epoch_ms"} <= set(r["metrics"]) <= {
        "setup_s", "epoch_ms", "epoch_p95_ms"}


@pytest.mark.parametrize("mix", MIXES)
def test_the_control_is_not_correct(mix):
    """The reference in the port's place, in TF32 (the precision below the
    configuration's float32), fails the float32 limits."""
    cell = tiny(mix)
    with tempfile.TemporaryDirectory() as d:
        inp = harness.make_cell_inputs(cell, 5, d, CPU)
        ref = harness.reference_readings(cell, inp, CPU)
        ctl = harness.reference_readings(cell, inp, CPU, "tf32")
    checks = judge.compare(ctl, ref, cell.limits, cell.loss)
    assert any(c["value"] > c["limit"] for c in checks.values()), checks


def _unchanged(monkeypatch):
    """Every step leaves the leaves as they were."""
    from torch.optim.optimizer import (
        register_optimizer_step_post_hook,
        register_optimizer_step_pre_hook,
    )

    saved = {}

    def pre(opt, args, kwargs):
        saved["p"] = [p.detach().clone() for g in opt.param_groups
                      for p in g["params"]]

    def post(opt, args, kwargs):
        with torch.no_grad():
            for p, old in zip((p for g in opt.param_groups
                               for p in g["params"]), saved["p"]):
                p.copy_(old)

    hooks = [register_optimizer_step_pre_hook(pre),
             register_optimizer_step_post_hook(post)]
    return lambda: [h.remove() for h in hooks]


def _half_batch(monkeypatch):
    """The loss over the first half of each batch's views, the mean taken
    over them."""
    from st3d_torch.engine import multistyle, pipelines
    from st3d_torch.ops.losses import StyleContentTargets

    orig = pipelines.style_content_loss

    def half(feats, tg, *a, **k):
        n = max(tg.content_features.shape[0] // 2, 1)
        return orig({key: v[:n] for key, v in feats.items()},
                    StyleContentTargets(
                        tg.content_features[:n],
                        {key: v[:n] for key, v in tg.style_grams.items()},
                        tg.feature_shapes), *a, **k)

    monkeypatch.setattr(pipelines, "style_content_loss", half)
    orig_ms = multistyle._multi_style_content_loss

    def half_ms(feats, cfeat, grams, *a):
        # feats (G, S, B, ...), cfeat (G, 1, B, ...), grams (S, B, C, C).
        n = max(cfeat.shape[2] // 2, 1)
        return orig_ms({key: v[:, :, :n] for key, v in feats.items()},
                       cfeat[:, :, :n],
                       {key: v[:, :n] for key, v in grams.items()}, *a)

    monkeypatch.setattr(multistyle, "_multi_style_content_loss", half_ms)
    return lambda: None


def _altered(monkeypatch):
    """The renders' colours come out a tenth too dark where they are
    produced."""
    from st3d_torch.engine import multistyle, pipelines

    for mod, name in ((pipelines, "render_rgba_static"),
                      (pipelines, "render_rgba"),
                      (multistyle, "shade_compact_styles")):
        orig = getattr(mod, name)

        def darker(*a, _orig=orig, **k):
            out = _orig(*a, **k)
            if out.shape[-1] == 4:
                return torch.cat([0.9 * out[..., :3], out[..., 3:]], -1)
            return 0.9 * out

        monkeypatch.setattr(mod, name, darker)
    return lambda: None


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered],
                         ids=["state_unchanged", "half_batch",
                              "answer_altered"])
@pytest.mark.parametrize("mix", MIXES)
def test_a_fault_is_not_correct(mix, fault, monkeypatch):
    undo = fault(monkeypatch)
    try:
        r = _run(tiny(mix))
    finally:
        undo()
    assert not r["correct"], r["compared"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["vgg19-768x6-f32.texture",
                                      "vgg19-768x6-bf16.texture",
                                      "vgg19-768x6-bf16.styles3"])
def test_the_control_fails_at_the_cell_size_on_the_card(workload, card):
    """The control at the cell's own size on three seeds: each fails the
    cell's limits."""
    from portbench.calibrate import CONTROL

    cell = cells.resolve(workload)
    for seed in (101, 202, 303):
        with tempfile.TemporaryDirectory() as d:
            inp = harness.make_cell_inputs(cell, seed, d, card)
            ref = harness.reference_readings(cell, inp, card)
            ctl = harness.reference_readings(cell, inp, card,
                                             CONTROL[cell.dtype])
        checks = judge.compare(ctl, ref, cell.limits, cell.loss)
        assert any(c["value"] > c["limit"] for c in checks.values()), checks


@pytest.mark.parametrize("mix", ["texture", "styles3"])
def test_the_grams_come_from_the_ports_first_step(mix):
    """``FirstStepTap`` keeps the Grams of the port's first VGG call with a
    gradient, one (B, C, C) per style tap (and style), and puts the port's
    ``get_features`` back."""
    from st3d_torch.engine import multistyle, pipelines

    before = (pipelines.get_features, multistyle.get_features)
    cell = tiny(mix)
    with tempfile.TemporaryDirectory() as d:
        inp = harness.make_cell_inputs(cell, 9, d, CPU)
        prog = harness.run_program(cell, 0.2, False, CPU, d, inp)
    assert (pipelines.get_features, multistyle.get_features) == before
    grams = prog["readings"]["first_step"]
    suffixes = [f".s{k}" for k in range(cell.styles)] if (
        mix == "styles3") else [""]
    assert set(grams) == {t + s for t in GRAM.STYLE_TAPS for s in suffixes}
    batch = int(cell.flags["batch_size"])
    for k, g in grams.items():
        c = g.shape[-1]
        assert g.shape == (batch, c, c) and torch.isfinite(g).all(), k


@pytest.mark.parametrize("dtype,fmt", [("float32", "tf32"),
                                       ("bfloat16", "fp8")])
def test_gram_diff_tells_the_port_from_the_control(dtype, fmt):
    """The port's first-step Grams sit at least 3 times nearer the float64
    reference than the reference computed one precision lower does."""
    cell = tiny("texture", dtype=dtype)
    with tempfile.TemporaryDirectory() as d:
        inp = harness.make_cell_inputs(cell, 12, d, CPU)
        ref = harness.reference_readings(cell, inp, CPU)
        prog = harness.run_program(cell, 0.2, False, CPU, d, inp)
        ctl = harness.reference_readings(cell, inp, CPU, fmt)
    every = judge.unlimited(cell.loss)
    port = judge.compare(prog["readings"], ref, every, cell.loss)["gram_diff"]
    control = judge.compare(ctl, ref, every, cell.loss)["gram_diff"]
    assert 3 * port["value"] < control["value"], (port, control)


class _Profiler:
    def __init__(self):
        self.running, self.marks, self.starts = False, 0, 0

    def start(self):
        self.running, self.starts = True, self.starts + 1

    def mark(self):
        self.marks += 1

    def stop(self):
        self.running = False


def test_a_traced_window_times_its_first_half_untraced():
    """The profiler starts past half the window and marks every later
    epoch end; the untraced epochs are those before it started."""
    prof = _Profiler()
    win = harness.Window(1, 3, 0.2, CPU, prof)
    opt = torch.optim.Adam([torch.zeros(2, 2, 3, requires_grad=True)])
    try:
        while True:
            win.pre(opt, (), {})
            time.sleep(0.01)
            win.post(opt, (), {})
    except harness.StopRun:
        pass
    assert prof.starts == 1 and not prof.running
    untraced, whole = win.untraced_s, win.epoch_s
    assert 0.1 <= sum(untraced) < 0.2 <= sum(whole)
    assert untraced == whole[:len(untraced)]
    assert prof.marks == len(whole) - len(untraced)
