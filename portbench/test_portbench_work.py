"""The work counter's anchors: VGG-19's published size and the 768² step."""

import pytest

from portbench import cells, work

GRAM = cells.load_loss(cells.ROOT, "gram")


def test_vgg19_sixteen_convs_at_224():
    flops = work.conv_forward_flops(224, 224, 16)
    assert flops == 777_600 * 224 ** 2
    assert flops / 2 == pytest.approx(19.5e9, rel=2e-3)   # 19.6 G less FCs


def test_forward_to_conv5_1_and_grams():
    assert work.deepest(GRAM.TAPS) == "conv5_1"
    assert work.convs_to(work.deepest(GRAM.TAPS)) == 13
    assert work.conv_forward_flops(768, 768, 13) == 722_304 * 768 ** 2
    assert GRAM.flops(768, 768) == 69_632 * 768 ** 2


def test_the_768_step():
    assert work.image_step_flops(768, 768, GRAM) == pytest.approx(
        893.1e9, rel=1e-4)
    assert work.epoch_flops(768, 6, 1, GRAM) == pytest.approx(5.36e12,
                                                              rel=1e-3)
    assert work.epoch_flops(768, 6, 3, GRAM) == pytest.approx(16.08e12,
                                                              rel=1e-3)


@pytest.mark.parametrize("workload", ["vgg19-768x6-f32.texture",
                                      "vgg19-768x6-bf16.texture",
                                      "vgg19-768x6-bf16.styles3"])
def test_the_gram_configurations_count_893_gflop_an_image(workload):
    """The configurations name the Gram loss, and ``work.summary`` of their
    cells counts 893.1 GFLOP an image at 768²."""
    cell = cells.resolve(workload)
    assert cell.config["model"]["loss"] == "gram" and cell.loss is GRAM
    s = work.summary(cell)
    assert s["epoch_flops"] / s["images_per_epoch"] == pytest.approx(
        893.1e9, rel=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_bound_is_at_least_the_flops_over_the_peak(dtype):
    bound = work.vgg_bound_s(768, 6, dtype, GRAM)
    flops = work.epoch_flops(768, 6, 1, GRAM)
    assert bound >= flops / work.PEAK_FLOPS[dtype] * (1 - 1e-9)
    assert bound < 2 * flops / work.PEAK_FLOPS[dtype]
