"""``portbench/spans.py``: the attribution of device work, syncs and idle
gaps to the port's spans, on a CPU trace of a tiny run (host operators
stand in for kernels) and on made-up events; and the set-up and host time
of the in-memory log."""

import os

import pytest
import torch

from portbench import devtrace, spans
from portbench.spans import Ev


@pytest.fixture(scope="module")
def cpu_trace(tmp_path_factory):
    """The events of a 32² second-approach run on the CPU (two steps, one
    epoch) under ``torch.profiler`` with the port's spans on, between two
    epoch marks."""
    from st3d_torch.engine.config import parse_second_approach
    from st3d_torch.engine.pipelines import run_second_approach
    from st3d_torch.models.vgg import init_random_vgg19, save_vgg19_npz
    from st3d_torch.profile_step import write_sphere_scene
    from st3d_torch.utils import trace

    root = tmp_path_factory.mktemp("spans")
    obj, style = write_sphere_scene(str(root), 32, 0, 2)
    save_vgg19_npz(init_random_vgg19(0), str(root / "vgg.npz"))
    cfg = parse_second_approach([
        "--obj_path", obj, "--style_path", style, "--size", "32",
        "--n_views", "3", "--batch_size", "2", "--epochs", "1",
        "--save_intermediate", "False", "--device", "cpu",
        "--vgg_weights", str(root / "vgg.npz"),
        "--output_path", str(root / "out")])
    prof = devtrace.Profiler(cuda=False)
    trace.enable()
    try:
        prof.start()
        prof.mark()
        run_second_approach(cfg)
        prof.mark()
    finally:
        prof.stop()
        trace.disable()
    return spans.normalize(prof.events())


def _as_kernels(evs, ops):
    """Each of ``ops`` as a launch call just after its start and a device
    event as long as the op."""
    out = list(evs)
    for k, op in enumerate(ops):
        out.append(Ev("call", "cudaLaunchKernel", op.start + 1,
                      op.start + 2, op.tid, corr=10 ** 9 + k))
        out.append(Ev("device", f"k{k}:{op.name}", op.start, op.end,
                      corr=10 ** 9 + k))
    return out


def test_backward_work_goes_to_the_forward_span(cpu_trace):
    """Every backward node's work goes to the span of its forward
    operator, by ``(sequence_nr, fwd_thread_id)``, not to
    ``st3d.backward`` where it ran; VGG's and the render's among them."""
    nodes = [e for e in cpu_trace if e.kind == "op" and e.backward
             and not e.name.startswith("autograd::")]
    assert nodes
    red = spans.reduce_trace(_as_kernels(cpu_trace, nodes))
    by_span = {s: set(k.split(":", 1)[1] for k in ks)
               for s, ks in red.kernels_by_span.items()}
    assert "st3d.backward" not in by_span and spans.NONE not in by_span
    assert any("Conv3x3" in n for n in by_span["st3d.vgg"])
    assert by_span.get("st3d.render")
    assert set(by_span) <= {"st3d.vgg", "st3d.render", "st3d.loss",
                            "st3d.forward"}


def test_forward_work_goes_to_the_innermost_span(cpu_trace):
    """Forward operators' work goes to the innermost span open at the
    launch: VGG's matmuls to ``st3d.vgg``, Adam's updates to
    ``st3d.optim``."""
    ops = [e for e in cpu_trace if e.kind == "op" and not e.backward
           and e.name in ("aten::bmm", "aten::addcdiv_", "aten::lerp_")]
    red = spans.reduce_trace(_as_kernels(cpu_trace, ops))
    names = {s: set(k.split(":", 1)[1] for k in ks)
             for s, ks in red.kernels_by_span.items()}
    assert names["st3d.vgg"] == {"aten::bmm"}
    assert names["st3d.optim"] == {"aten::addcdiv_", "aten::lerp_"}


K = 1000


def _made_up():
    """Two epochs between marks at 0, 100 and 200 (× K ns). In each: the
    port's epoch end with a stream sync, a sync with no span open, then a
    step whose forward holds a kernel, a stream sync and a device sync of
    the port's own, and whose optim holds the harness's device sync (with
    its driver call inside) just before the next mark."""
    evs = [Ev("mark", devtrace.MARK, m * K, m * K + 1) for m in (0, 100,
                                                                200)]
    for o in (0, 100):
        def at(a, b=None):
            return (o + a) * K, (o + (a if b is None else b)) * K + 10

        evs += [
            Ev("span", "st3d.epoch_end", *at(1, 5), tid=1),
            Ev("call", "cudaStreamSynchronize", *at(2), tid=1),
            Ev("call", "cudaStreamSynchronize", *at(9), tid=1),
            Ev("span", "st3d.step", *at(10, 99), tid=1),
            Ev("span", "st3d.forward", *at(12, 40), tid=1),
            Ev("op", "aten::mm", *at(13, 14), tid=1),
            Ev("call", "cudaLaunchKernel", *at(13), tid=1, corr=o + 1),
            Ev("device", "gemm", *at(15, 35), corr=o + 1),
            Ev("call", "cudaStreamSynchronize", *at(30), tid=1),
            Ev("call", "cudaDeviceSynchronize", *at(36), tid=1),
            Ev("span", "st3d.optim", *at(60, 98), tid=1),
            Ev("call", "cudaDeviceSynchronize", *at(70, 97), tid=1),
            Ev("call", "cuCtxSynchronize", *at(71, 96), tid=1),
        ]
    return evs


def test_every_sync_and_gap_has_a_span_or_none():
    red = spans.reduce_trace(_made_up())
    assert red.epochs == 2
    assert red.syncs == {"st3d.epoch_end": 2, spans.NONE: 2,
                         "st3d.forward": 4}
    assert red.step_syncs == 4
    # The gaps: [0, 15] with no span open at its middle, then [35, 115]
    # and [135, 200] in the harness's wait inside st3d.optim.
    assert red.idle_s == {
        spans.NONE: pytest.approx(15 * K / 1e9),
        "st3d.optim": pytest.approx((145 * K - 20) / 1e9)}
    assert red.device_s == {"st3d.forward": pytest.approx(2 * (20 * K + 10)
                                                          / 1e9)}
    assert red.launches == {"st3d.forward": 2}
    share = red.per_epoch()["idle_unattributed_share"]
    assert 0 < share < 1


def test_the_harness_sync_before_each_mark_is_discounted():
    red = spans.reduce_trace(_made_up())
    # The harness's runtime call and its driver call, in each epoch.
    assert red.harness_syncs == 4
    calls = red.sync_calls
    assert calls["st3d.forward cudaDeviceSynchronize"] == 2
    assert "st3d.optim cudaDeviceSynchronize" not in calls
    assert not any("cuCtxSynchronize" in k for k in calls)


def test_the_log_gives_set_up_by_phase_and_host_time():
    ms = 10 ** 6
    recs = [("setup", -1, 0, 100 * ms), ("setup.scene", 0, 1 * ms, 11 * ms),
            ("kernels.load", 1, 2 * ms, 4 * ms),
            ("setup.targets", 0, 20 * ms, 50 * ms),
            ("kernels.load", 3, 21 * ms, 22 * ms),
            ("setup", -1, 110 * ms, 120 * ms),
            ("step", -1, 200 * ms, 210 * ms), ("forward", 6, 201 * ms,
                                               204 * ms),
            ("backward", 6, 204 * ms, 206 * ms),
            ("kernels.load", 8, 205 * ms, 206 * ms),
            ("step", -1, 300 * ms, 310 * ms), ("forward", 10, 301 * ms,
                                                303 * ms),
            ("backward", 10, 303 * ms, 304 * ms)]
    log = spans.reduce_log(recs, 150 * ms, (250 * ms, 400 * ms), epochs=1)
    assert log["setup_s"] == pytest.approx(0.110)
    assert log["setup_phases_s"]["setup.scene"] == pytest.approx(0.010)
    assert log["kernel_load_s"] == pytest.approx(0.003)
    assert log["dispatch_host_ms"] == pytest.approx(3.0)
    assert log["host_ms"]["step"] == pytest.approx(10.0)


def test_the_tool_runs_without_a_card(monkeypatch):
    """Without CUDA the tool exits as ``run.py`` does, with no result, and
    leaves the spans off."""
    from st3d_torch.utils import trace

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "TORCH_EXTENSIONS_DIR",
                "TRITON_CACHE_DIR", "USE_FLAX"):     # run.py's _env sets them
        monkeypatch.setenv(var, os.environ.get(var, ""))
    assert spans.main(["--workload", "vgg19-768x6-bf16.texture", "--seed",
                       "1", "--seconds", "1"]) == 2
    assert not trace.enabled()
