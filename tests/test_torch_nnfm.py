"""ARF's NNFM loss in the port (``--loss nnfm``): ``ops/nnfm.py``,
``kernels/nnfm.py`` and the conv3 block of ``models/vgg.py``.

On the CPU the port's float32 path is held to the benchmark's plain
reference (``portbench/losses/nnfm.py``, loaded by path, float64): the
loss and the input gradient at 64² and 32², the texture's first gradient
through a second-approach step, and ``relu3:nn`` / ``relu3:nn_cos`` where
every match beats the second best by a clear gap. ``get_features`` stops
at conv3_3 and reads only the seven convs of a VGG-16 file; the Gram
path's taps and routes stay as they were; every entry point without NNFM
refuses ``--loss nnfm`` while parsing. The certified matching's plain
versions (``filter_plain``, ``match_certified_plain``) and a model of the
kernel's per-lane lists: the bound covers |H - exact| on random data and on
a pair that H misorders, the exact argmax is always a candidate, a row past
``CAP`` is marked, and the answer equals ``match_plain``, ties included. On
a card (``cuda`` marker, skipped here) both matching kernels against a
float64 blockwise argmax at edge shapes, on near-copies of a style row
that force the fallback, and at one view of the cell's 36,864 x 36,864 x
768.
"""

import importlib.util
import os
import tempfile

import numpy as np
import pytest
import torch

from st3d_torch.kernels import nnfm as knnfm
from st3d_torch.models import vgg as tvgg
from st3d_torch.ops import nnfm as onnfm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _load("portbench_loss_nnfm_test", "portbench/losses/nnfm.py")
RVGG = _load("portbench_reference_vgg_test", "portbench/reference/vgg.py")
CELL = {"style_weight": 1.0, "content_weight": 0.005}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the CPU (see test_torch_slice.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    """Seeded VGG-19 weights as the port loads them and as the reference
    does (float64), from one .npz."""
    model = tvgg.init_random_vgg19(3)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "w.npz")
        tvgg.save_vgg19_npz(model, path)
        with np.load(path) as data:
            arrays = {k: data[k] for k in data.files}
    ref = [(k.double(), b.double())
           for k, b in RVGG.load_weights(arrays, torch.device("cpu"))]
    return model, ref


def _images(seed, n, size):
    return torch.rand((n, 3, size, size),
                      generator=torch.Generator().manual_seed(seed))


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.mark.parametrize("size", [64, 32])
def test_loss_and_gradient_follow_the_reference(weights, size):
    model, ref_w = weights
    x, style, content = (_images(1, 2, size), _images(2, 1, size),
                         _images(3, 2, size))
    st = onnfm.style_target(style, model)
    ct = onnfm.content_target(content, model)
    leaf = x.clone().requires_grad_(True)
    feats = tvgg.get_features(leaf, model, nnfm=st.operand)
    got = onnfm.nnfm_loss(feats, ct, st, CELL["style_weight"],
                          CELL["content_weight"])
    got.backward()

    leaf64 = x.double().requires_grad_(True)
    taps = lambda im: RVGG.taps(im, ref_w, REF.TAPS)  # noqa: E731
    target = REF.targets(taps(style.double()), taps(content.double()), 2,
                         "float64")
    want = REF.loss(taps(leaf64), target, CELL, "float64")
    want.backward()
    assert float(got.detach()) == pytest.approx(float(want.detach()),
                                                rel=1e-5)
    assert _rel(leaf.grad, leaf64.grad) < 1e-4
    assert feats["relu3"].shape == (2, (size // 4) ** 2, 768)
    assert feats["relu3:nn"].dtype == torch.int32


def _permuted_block(seed, p, c=768):
    """A block and a style block whose rows are the block's, shuffled and
    lightly perturbed: each row's best match beats its second by far."""
    g = torch.Generator().manual_seed(seed)
    f = torch.relu(torch.randn((1, p, c), generator=g, dtype=torch.float64))
    perm = torch.randperm(p, generator=g)
    s = f[0, perm] + 0.01 * torch.rand((p, c), generator=g,
                                       dtype=torch.float64)
    return f, s, torch.argsort(perm)


@pytest.mark.parametrize("p", [300, 1024])
def test_nn_and_nn_cos_match_the_reference_at_a_clear_gap(p):
    f, s, want_nn = _permuted_block(p, p)
    s_hat = REF.normalized(s[None])[0]
    ref_nn, ref_cos = REF.match(REF.normalized(f).reshape(p, -1), s_hat,
                                "float64")
    sim = REF.normalized(f)[0] @ s_hat.t()
    top2 = sim.topk(2, dim=1).values
    assert float((top2[:, 0] - top2[:, 1]).min()) > 1e-3
    assert torch.equal(ref_nn, want_nn)
    out = tvgg._match_block(f.float(), knnfm.style_operand(
        knnfm.center_normalize(s[None].float())))
    assert torch.equal(out["relu3:nn"][0].long(), ref_nn)
    assert out["relu3:nn"].dtype == torch.int32
    assert float((out["relu3:nn_cos"][0].double() - ref_cos).abs().max()) \
        < 1e-5


def test_get_features_matches_a_render_to_itself(weights):
    """The style image as the render: every position's match is itself,
    at a centred cosine of 1, the reference's too."""
    model, ref_w = weights
    style = _images(4, 1, 32)
    st = onnfm.style_target(style, model)
    feats = tvgg.get_features(style, model, nnfm=st.operand)
    p = 64
    assert torch.equal(feats["relu3:nn"][0], torch.arange(p,
                                                          dtype=torch.int32))
    assert float((feats["relu3:nn_cos"] - 1).abs().max()) < 1e-5
    taps = RVGG.taps(style.double(), ref_w, REF.TAPS)
    target = REF.targets(taps, taps, 1, "float64")
    REF.loss(taps, target, CELL, "float64")
    want = REF.first_step(taps, "float64")
    got = REF.port_first_step(feats)
    assert set(got) == set(want) == {"relu3:nn_cos"}
    assert _rel(got["relu3:nn_cos"], want["relu3:nn_cos"]) < 1e-5


def test_texture_gradient_follows_the_reference():
    """One second-approach step of the port with ``--loss nnfm`` against
    the reference's: the epoch losses and the texture's first gradient."""
    import copy

    from portbench import cells, harness, judge

    cell = copy.deepcopy(cells.resolve("nnfm-vgg16-768x6-f32.texture"))
    cell.config["flags"].update(size=32, n_views=4, batch_size=2)
    cell.config["scene"]["ico_level"] = 3
    cpu = torch.device("cpu")
    with tempfile.TemporaryDirectory() as d:
        inp = harness.make_cell_inputs(cell, 2 ** 31 + 21, d, cpu)
        prog = harness.run_program(cell, 0.2, False, cpu, d, inp)
        ref = harness.reference_readings(cell, inp, cpu)
    got = judge.compare(prog["readings"], ref, judge.unlimited(cell.loss),
                        cell.loss)
    assert got["grad_diff"]["value"] < 1e-4, got
    assert got["loss_gap"]["value"] < 1e-5, got
    assert got["nn_cos_diff"]["value"] < 1e-5, got


def _recording(monkeypatch):
    """Record the conv routes ``get_features`` takes, with each weight's
    (Cin, Cout)."""
    calls = []
    for name in ("conv3x3_bias", "conv3x3_bias_relu", "conv3x3_bias_gram",
                 "conv3x3_bias_relu_pool_packed", "conv1_1_relu_stats",
                 "conv1_2_relu_pool"):
        orig = getattr(tvgg, name)

        def rec(x, w, b, _orig=orig, _name=name):
            calls.append((_name, tuple(w.shape[2:])))
            return _orig(x, w, b)

        monkeypatch.setattr(tvgg, name, rec)
    return calls


def test_the_block_stops_at_conv3_3(weights, monkeypatch):
    model, _ = weights
    calls = _recording(monkeypatch)
    f = tvgg.get_features(_images(5, 1, 64), model, relu3=True)["relu3"]
    assert calls == [("conv1_1_relu_stats", (3, 64)),
                     ("conv1_2_relu_pool", (64, 64)),
                     ("conv3x3_bias_relu", (64, 128)),
                     ("conv3x3_bias_relu", (128, 128)),
                     ("conv3x3_bias_relu", (128, 256)),
                     ("conv3x3_bias_relu", (256, 256)),
                     ("conv3x3_bias_relu", (256, 256))]
    assert f.shape == (1, 256, 768) and float(f.min()) >= 0.0
    # Seven convs are all the block needs; the Gram path needs thirteen.
    short = tvgg.VGG19(model.kernels[:7], model.biases[:7], convs=7)
    assert torch.equal(tvgg.get_features(_images(5, 1, 64), short,
                                         relu3=True)["relu3"], f)
    with pytest.raises(ValueError, match="conv 12"):
        tvgg.get_features(_images(5, 1, 64), short, gram1=True)


def test_the_gram_path_keeps_its_taps_and_routes(weights, monkeypatch):
    model, _ = weights
    calls = _recording(monkeypatch)
    feats = tvgg.get_features(_images(6, 1, 64), model, layout="NHWC",
                              input_layout="NCHW", gram1=True)
    assert set(feats) == {"conv1_1:gram", "conv2_1:gram", "conv3_1:gram",
                          "conv4_1:gram", "conv5_1:gram", "conv4_2"}
    relu, gram = "conv3x3_bias_relu", "conv3x3_bias_gram"
    assert calls == [
        ("conv1_1_relu_stats", (3, 64)), ("conv1_2_relu_pool", (64, 64)),
        (gram, (64, 128)), (relu, (128, 128)),
        (gram, (128, 256)), (relu, (256, 256)), (relu, (256, 256)),
        (relu, (256, 256)),
        (gram, (256, 512)), ("conv3x3_bias", (512, 512)), (relu, (512, 512)),
        (relu, (512, 512)),
        (gram, (512, 512))]
    calls.clear()
    taps = tvgg.get_features(_images(6, 1, 64), model)
    assert set(taps) == set(tvgg.TAP_CONV_INDEX)
    tap = "conv3x3_bias"
    assert calls == [                  # conv1_1 is an im2col matmul
        ("conv3x3_bias_relu_pool_packed", (64, 64)),
        (tap, (64, 128)), (relu, (128, 128)),
        (tap, (128, 256)), (relu, (256, 256)), (relu, (256, 256)),
        (relu, (256, 256)),
        (tap, (256, 512)), (tap, (512, 512)), (relu, (512, 512)),
        (relu, (512, 512)),
        (tap, (512, 512))]


def test_a_vgg16_file_serves_the_block(weights, tmp_path):
    """VGG-16's eighth conv is conv4_1 (256 -> 512), VGG-19's conv3_4: the
    loader reads and checks only the seven convs the block needs."""
    model, _ = weights
    widths = [64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512]
    arrays, c_in = {}, 3
    for i, c_out in enumerate(widths):
        w = model.kernels[i] if i < 7 else torch.zeros(3, 3, c_in, c_out)
        b = model.biases[i] if i < 7 else torch.zeros(c_out)
        arrays[f"conv{i}_kernel"] = w.numpy()
        arrays[f"conv{i}_bias"] = b.numpy()
        c_in = c_out
    path = str(tmp_path / "vgg16.npz")
    np.savez(path, **arrays)
    with pytest.raises((ValueError, KeyError)):
        tvgg.load_vgg19_npz(path)
    vgg16 = tvgg.get_vgg(path, convs=tvgg.BLOCK3_CONVS)
    assert vgg16.num_convs == 7
    x = _images(7, 1, 32)
    assert torch.equal(tvgg.get_features(x, vgg16, relu3=True)["relu3"],
                       tvgg.get_features(x, model, relu3=True)["relu3"])


@pytest.mark.parametrize("entry", ["first_approach", "multi_style", "fleet",
                                   "data_parallel"])
def test_entries_without_nnfm_refuse_it_while_parsing(entry, capsys):
    from st3d_torch import first_approach, fleet, multi_style, second_approach

    argv = ["--loss", "nnfm", "--device", "cpu"]
    main = {"first_approach": first_approach.main,
            "multi_style": multi_style.main, "fleet": fleet.main,
            "data_parallel": second_approach.main}[entry]
    if entry == "data_parallel":
        argv += ["--data_parallel", "True"]
    with pytest.raises(SystemExit) as e:
        main(argv)
    assert e.value.code == 2
    assert "--loss" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# The certified matching's plain versions
# ---------------------------------------------------------------------------

def _smooth_rows(seed, n, c, per=100):
    """Centred, normalised rows along a path through random anchors,
    ``per`` rows from one anchor to the next: neighbours nearly equal, as a
    smooth style's positions are, so rows have many near-best columns."""
    g = torch.Generator().manual_seed(seed)
    anchors = torch.randn((n // per + 2, c), generator=g)
    t = torch.arange(n, dtype=torch.float32) / per
    k = t.floor().long()
    w = (t - k)[:, None]
    rows = (1 - w) * anchors[k] + w * anchors[k + 1]
    return knnfm.center_normalize(torch.relu(rows + 0.5)[None])


def _exact(fhat, shat):
    return fhat.double() @ shat.double().t()


def test_the_nearest_split_is_exact_and_rounds_to_nearest():
    """``split_tf32_nearest``: hi the tf32 value nearest t (of the one
    truncation gives and the next one away from zero; a tie goes away from
    zero), hi + lo == t bit for bit, -0.0 included."""
    from st3d_torch.kernels.conv import split_tf32

    g = torch.Generator().manual_seed(3)
    t = torch.randn(4096, generator=g) * torch.logspace(-3, 3, 4096)
    half = 2.0 ** -11                       # half a tf32 step at 1
    t[:6] = torch.tensor([-0.0, 0.0, 1.0 + half, -(1.0 + half),
                          1.0 + 0.99 * half, 1.0 + 1.01 * half])
    hi, lo = knnfm.split_tf32_nearest(t)
    assert torch.equal((hi + lo).view(torch.int32), t.view(torch.int32))
    trunc, _ = split_tf32(t)
    up = (trunc.view(torch.int32) + 8192).view(torch.float32)
    nearer_up = ((up.double() - t.double()).abs()
                 <= (t.double() - trunc.double()).abs())
    assert torch.equal(hi, torch.where(nearer_up, up, trunc))
    assert hi[2:6].tolist() == [1.0 + 2 * half, -(1.0 + 2 * half), 1.0,
                                1.0 + 2 * half]


@pytest.mark.parametrize("seed,c", [(0, 64), (1, 64), (2, 768), (3, 36)])
def test_the_row_bound_covers_the_hi_product(seed, c):
    g = torch.Generator().manual_seed(seed)
    fh = knnfm.center_normalize(torch.relu(torch.randn((1, 200, c),
                                                       generator=g) + 0.3))
    sh = _smooth_rows(seed + 10, 300, c)
    h, eps, _ = knnfm.filter_plain(fh, sh)
    gap = (h.double() - _exact(fh, sh)).abs()
    assert bool((gap <= eps.double()[:, None]).all())


def _misordered_pair(c=768):
    """A render row a and style rows b1, b2 with a . b1 > a . b2 exactly but
    a_hi . b1_hi < a_hi . b2_hi: b1 sits just under half a tf32 step above
    a tf32 value in every channel (its hi rounds down to it), b2 on that
    value in most channels and just over half a step above it in a few
    (rounds up a whole step). The other style rows are far from a."""
    g = torch.Generator().manual_seed(7)
    a = torch.nn.functional.normalize(torch.rand((c,), generator=g) + 0.5,
                                      dim=0)
    base = torch.nn.functional.normalize(a + 0.05 * torch.rand(
        (c,), generator=g), dim=0)
    hi, _ = knnfm.split_tf32_nearest(base)
    ulp = (hi.view(torch.int32) + 8192).view(torch.float32) - hi
    b1 = hi + 0.49 * ulp
    b2 = hi.clone()
    b2[:3] = hi[:3] + 0.51 * ulp[:3]
    others = knnfm.center_normalize(torch.randn((1, 50, c), generator=g))
    return a[None], torch.cat([others[:20], b1[None], b2[None], others[20:]])


def test_the_row_bound_covers_a_misordered_pair():
    a, sh = _misordered_pair()
    h, eps, cand = knnfm.filter_plain(a, sh)
    e = _exact(a, sh)
    assert float(e[0, 20]) > float(e[0, 21])            # b1 wins exactly
    assert float(h[0, 20]) < float(h[0, 21])            # H says b2
    assert bool(((h.double() - e).abs() <= eps.double()[:, None]).all())
    assert bool(cand[0, 20]) and bool(cand[0, 21])
    idx, val, full = knnfm.match_certified_plain(a, sh)
    assert int(idx[0]) == 20 and not bool(full[0])
    assert abs(float(val[0]) - float(e[0, 20])) < 2e-6


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_exact_argmax_is_always_a_candidate(seed):
    sh = _smooth_rows(seed, 600, 64)
    g = torch.Generator().manual_seed(seed + 100)
    pick = torch.randint(0, 600, (400,), generator=g)
    fh = torch.nn.functional.normalize(
        sh[pick] + 0.002 * torch.randn((400, 64), generator=g), dim=1)
    _, _, cand = knnfm.filter_plain(fh, sh)
    best = _exact(fh, sh).argmax(dim=1)
    assert bool(cand[torch.arange(400), best].all())
    assert float(cand.sum(1).float().mean()) > 2     # the lists are busy


def _near_copies(seed, n_copies, c=64, n=400, m=120):
    """Style rows with ``n_copies`` near-copies of one row (1e-4 apart) and
    render rows near that row: each of those has every copy within its
    bound."""
    g = torch.Generator().manual_seed(seed)
    sh = knnfm.center_normalize(torch.randn((1, n, c), generator=g))
    sh[100:100 + n_copies] = sh[100] + 1e-4 * torch.randn(
        (n_copies, c), generator=g)
    fh = knnfm.center_normalize(torch.randn((1, m, c), generator=g))
    fh[:m // 2] = torch.nn.functional.normalize(
        sh[100] + 1e-3 * torch.randn((m // 2, c), generator=g), dim=1)
    return fh, sh


def test_an_overflowing_row_is_marked():
    fh, sh = _near_copies(5, knnfm.CAP + 20)
    _, _, cand = knnfm.filter_plain(fh, sh)
    idx, val, full = knnfm.match_certified_plain(fh, sh)
    assert bool((cand.sum(1) > knnfm.CAP).eq(full).all())
    assert bool(full[:60].all()) and not bool(full[60:].any())
    e = _exact(fh, sh)
    assert torch.equal(idx.long(), e.argmax(dim=1))
    assert float((val.double() - e.max(dim=1).values).abs().max()) < 2e-6
    # Under CAP copies, no row is marked.
    fh, sh = _near_copies(5, knnfm.CAP // 2)
    assert not bool(knnfm.match_certified_plain(fh, sh)[2].any())


@pytest.mark.parametrize("dup", [False, True])
def test_the_certified_match_equals_match_plain(dup):
    g = torch.Generator().manual_seed(11)
    m, n = 1024, 700
    fh = knnfm.center_normalize(torch.randn((1, m, 64), generator=g))
    sh = knnfm.center_normalize(torch.randn((1, n, 64), generator=g))
    if dup:
        # As the card test: style rows 3 and n // 2 equal, half the render
        # rows equal to them; exact ties, which the lowest row wins.
        sh[n // 2] = sh[3]
        fh[:m // 2] = sh[3]
    idx, val, full = knnfm.match_certified_plain(fh, sh)
    want_i, want_v = knnfm.match_plain(fh, sh)
    assert torch.equal(idx, want_i)
    assert float((val - want_v).abs().max()) < 2e-6
    assert not bool(full.any())
    if dup:
        assert bool((idx[:m // 2] == 3).all())


def _lane_lists(h, eps, chunks, chunk_tiles, slots, cap):
    """The filter kernel's lists for one row of H (N,) with bound eps, in
    the order its items run: the row's chunks in lockstep, a column tile
    (``FILTER_TILE``) each a step, the lanes' columns in order (lane
    (j % 8) // 2 of the tile). Each chunk keeps a running max, shares it
    through rmax (read back one tile late), takes every H >= max - 2 eps
    into its lane's ``slots`` (the first slot fallen below the threshold;
    a full list is flushed to the row's list first) and at its end appends
    what stays above the final threshold. The flush that takes the count
    past ``cap`` marks the row dead: that lane stops at once, the row's
    other chunks once they read rmax back, and a dead row appends nothing
    at its end. Returns the row's count and its columns."""
    n, tile = h.shape[0], knnfm.FILTER_TILE
    n_tiles = -(-n // tile)
    twice = 2.0 * eps
    rmax, dead = -float("inf"), False
    top = [-float("inf")] * chunks
    seen = [float("nan")] * chunks
    seen_dead = [False] * chunks
    lane_dead = [[False] * 4 for _ in range(chunks)]
    lists = [[[(-float("inf"), 0)] * slots for _ in range(4)]
             for _ in range(chunks)]
    out, count = [], 0

    def flush(lst):
        nonlocal count, dead
        out.extend(col for _, col in lst)
        count += len(lst)
        dead = dead or count > cap
        return count > cap

    for step in range(chunk_tiles):
        for c in range(chunks):
            nt = c * chunk_tiles + step
            if nt >= n_tiles:
                continue
            cols = range(nt * tile, min(n, nt * tile + tile))
            tm = max(float(h[j]) for j in cols)
            other = seen[c]
            top[c] = max(top[c], tm, other if other == other else tm)
            thr = top[c] - twice
            chunk_dead = seen_dead[c]
            seen[c], rmax = rmax, max(rmax, top[c])
            seen_dead[c] = seen_dead[c] or dead
            for lane in range(4):
                lst = lists[c][lane]
                for j in (j for j in cols if (j % 8) // 2 == lane):
                    x = float(h[j])
                    if chunk_dead or lane_dead[c][lane] or x < thr:
                        continue
                    slot = next((s for s, (v, _) in enumerate(lst)
                                 if v < thr), None)
                    if slot is None:
                        lane_dead[c][lane] = flush(lst)
                        lst[:] = [(-float("inf"), 0)] * slots
                        slot = 0
                    lst[slot] = (x, j)
    for c in range(chunks):
        other, rmax = rmax, max(rmax, top[c])
        t_end = max(top[c], other) - twice
        for lane in range(4):
            if not (dead or lane_dead[c][lane]):
                flush([e for e in lists[c][lane] if e[0] >= t_end])
    return count, out[:cap]


@pytest.mark.parametrize("slots", [2, knnfm.LIST])
def test_the_lane_lists_keep_every_candidate(slots):
    """The kernel's list mechanics (``_lane_lists``) on smooth style rows,
    with few slots (many flushes) and the kernel's: every plain candidate
    of a row under CAP is listed, a row with more is marked, and
    re-scoring the lists gives the exact argmax."""
    sh = _smooth_rows(4, 1100, 64, per=300)
    g = torch.Generator().manual_seed(40)
    pick = torch.randint(0, 1100, (48,), generator=g)
    fh = torch.nn.functional.normalize(
        sh[pick] + 0.002 * torch.randn((48, 64), generator=g), dim=1)
    h, eps, cand = knnfm.filter_plain(fh, sh)
    chunks, chunk_tiles = knnfm.match_chunks(1100, knnfm.FILTER_TILE)
    e = _exact(fh, sh)
    marked = 0
    for i in range(48):
        count, cols = _lane_lists(h[i], float(eps[i]), chunks, chunk_tiles,
                                  slots, knnfm.CAP)
        want = set(torch.nonzero(cand[i])[:, 0].tolist())
        if count > knnfm.CAP:
            marked += 1
            assert len(want) > knnfm.CAP or slots < knnfm.LIST
            continue
        assert want <= set(cols)
        assert max(cols, key=lambda j: (float(e[i, j]), -j)) \
            == int(e[i].argmax())
    assert marked < 48


@pytest.mark.parametrize("slots", [2, knnfm.LIST])
def test_the_lane_lists_mark_a_row_past_cap(slots):
    """Near-copies of one style row past CAP: the model's lists mark the
    rows near them (count past CAP, which stops their lanes) and list
    every candidate of the others."""
    fh, sh = _near_copies(8, knnfm.CAP + 40, n=700, m=40)
    h, eps, cand = knnfm.filter_plain(fh, sh)
    chunks, chunk_tiles = knnfm.match_chunks(700, knnfm.FILTER_TILE)
    for i in range(40):
        count, cols = _lane_lists(h[i], float(eps[i]), chunks, chunk_tiles,
                                  slots, knnfm.CAP)
        if i < 20:
            assert count > knnfm.CAP
        else:
            assert count <= knnfm.CAP
            assert set(torch.nonzero(cand[i])[:, 0].tolist()) <= set(cols)


# ---------------------------------------------------------------------------
# On a card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


ROUTES = {"certified": (lambda fh, st: knnfm.match(fh, st),
                         "nnfm_match_certified"),
          "full": (knnfm.match_full, "nnfm_match_tf32x3")}


def _kernel_against_float64(dev, m, n, k, dup, route, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    fh = knnfm.center_normalize(torch.randn((1, m, k), generator=g,
                                            device=dev))
    sh = knnfm.center_normalize(torch.randn((1, n, k), generator=g,
                                            device=dev))
    if dup:
        # Style rows 3 and n // 2 equal, and half the render rows equal to
        # them: exact ties, which the lowest row wins.
        sh[n // 2] = sh[3]
        fh[:m // 2] = sh[3]
    fn, key = ROUTES[route]
    n0 = knnfm.LAUNCHES[key]
    idx, val = fn(fh, knnfm.style_operand(sh))
    torch.cuda.synchronize()
    assert knnfm.LAUNCHES[key] == n0 + 1
    ref_idx, ref_val = knnfm.match_plain(fh.double(), sh.double(), 2048)
    return idx, val, ref_idx, ref_val


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k,dup", [
    (77, 5, 768, False),        # under one row tile and one column tile
    (128, 200, 768, False),     # one row tile; columns past the last tile
    (384, 1000, 768, True),     # three row tiles; ties across chunks
    (300, 129, 36, False),      # a slab past C, zero-filled
    (1, 300, 64, False)])
@pytest.mark.parametrize("route", ["certified", "full"])
def test_the_match_kernel_takes_float64s_argmax(card, m, n, k, dup, route):
    idx, val, ref_idx, ref_val = _kernel_against_float64(card, m, n, k, dup,
                                                         route)
    assert idx.dtype == torch.int32 and idx.shape == (m,)
    assert torch.equal(idx.long(), ref_idx)
    assert float((val.double() - ref_val).abs().max()) < 2e-6
    if dup:
        assert bool((idx[:m // 2] == 3).all())


@pytest.mark.cuda
@pytest.mark.parametrize("c", [768, 64])
def test_the_match_kernel_falls_back_on_near_copies(card, c):
    """200 near-copies (1e-4 apart) of one style row, and render rows near
    it: every copy lies within those rows' bounds, so they pass CAP and are
    scored in full; the answer is float64's where its best beats its
    runner-up by over 4e-6."""
    fh, sh = _near_copies(6, 200, c=c, n=3000, m=1000)
    fh, sh = fh.to(card), sh.to(card)
    stats = torch.zeros(2, dtype=torch.int64, device=card)
    idx, val = knnfm.match(fh, knnfm.style_operand(sh), stats)
    e = _exact(fh, sh)
    top2 = e.topk(2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]) > 4e-6
    assert torch.equal(idx.long()[clear], e.argmax(dim=1)[clear])
    assert float((val.double() - top2[:, 0]).abs().max()) < 2e-6
    cand, full = (int(v) for v in stats.tolist())
    assert full >= 500 and cand > 0


@pytest.mark.cuda
def test_the_match_kernel_at_the_cells_shape(card):
    """One view: 36,864 render rows against 36,864 style rows at 768
    channels; 8,192 rows checked against float64."""
    p = 36864
    g = torch.Generator(device=card).manual_seed(1)
    fh = knnfm.center_normalize(torch.relu(
        torch.randn((1, p, 768), generator=g, device=card) + 0.3))
    sh = knnfm.center_normalize(torch.relu(
        torch.randn((1, p, 768), generator=g, device=card) + 0.3))
    idx, val = knnfm.match(fh, knnfm.style_operand(sh))
    ref_idx, ref_val = knnfm.match_plain(fh[:8192].double(), sh.double(),
                                         1024)
    assert torch.equal(idx[:8192].long(), ref_idx)
    assert float((val[:8192].double() - ref_val).abs().max()) < 2e-6


@pytest.mark.cuda
def test_the_row_kernels_follow_their_plain_versions(card):
    g = torch.Generator(device=card).manual_seed(2)
    f = torch.rand((2, 1000, 768), generator=g, device=card)
    torch.testing.assert_close(knnfm.center_normalize(f),
                               knnfm.center_normalize_plain(f.double())
                               .float(), rtol=1e-5, atol=1e-6)
    m, n = 2000, 700
    rows = f.reshape(-1, 768)[:m]
    unit = torch.nn.functional.normalize(torch.randn((n, 768), generator=g,
                                                     device=card), dim=-1)
    content = torch.rand((m, 768), generator=g, device=card)
    nn = torch.randint(0, n, (m,), generator=g, device=card,
                       dtype=torch.int32)
    a = rows.clone().requires_grad_(True)
    b = rows.double().clone().requires_grad_(True)
    got = knnfm.loss_rows(a, unit, content, nn, 0.3, 0.02)
    want = knnfm.loss_rows_plain(b, unit.double(), content.double(), nn,
                                 0.3, 0.02)
    got.sum().backward()
    want.sum().backward()
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(a.grad.double(), b.grad, rtol=1e-5,
                               atol=1e-7)
