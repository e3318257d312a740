"""The work counter's anchors: VGG-19's published size and the 768² step."""

import pytest

from portbench import work


def test_vgg19_sixteen_convs_at_224():
    flops = work.conv_forward_flops(224, 224, 16)
    assert flops == 777_600 * 224 ** 2
    assert flops / 2 == pytest.approx(19.5e9, rel=2e-3)   # 19.6 G less FCs


def test_forward_to_conv5_1_and_grams():
    assert work.convs_to() == 13
    assert work.conv_forward_flops(768, 768, 13) == 722_304 * 768 ** 2
    assert work.gram_flops(768, 768) == 69_632 * 768 ** 2


def test_the_768_step():
    assert work.image_step_flops(768, 768) == pytest.approx(893.1e9,
                                                            rel=1e-4)
    assert work.epoch_flops(768, 6, 1) == pytest.approx(5.36e12, rel=1e-3)
    assert work.epoch_flops(768, 6, 3) == pytest.approx(16.08e12, rel=1e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_bound_is_at_least_the_flops_over_the_peak(dtype):
    bound = work.vgg_bound_s(768, 6, dtype)
    assert bound >= work.epoch_flops(768, 6, 1) / work.PEAK_FLOPS[dtype] * (
        1 - 1e-9)
    assert bound < 2 * work.epoch_flops(768, 6, 1) / work.PEAK_FLOPS[dtype]
