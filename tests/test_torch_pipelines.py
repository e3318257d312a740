"""What ``st3d_torch.engine.pipelines`` refuses before any work: an
unknown rasterizer backend (ValueError); every option of the JAX package
runs, checkpoints, ``--resume``, ``--profile`` and ``--debug_nan``
included (``tests/test_torch_checkpoint.py``), and ``--data_parallel`` and
``--tile_parallel`` (``tests/test_torch_parallel*.py``)."""

import pytest

from st3d_torch.engine import pipelines
from st3d_torch.engine.config import PipelineConfig


@pytest.mark.parametrize("overrides", [
    {}, {"checkpoint_every": 10, "resume": True},
    {"profile": True, "debug_nan": True}])
def test_default_config_runs(overrides):
    pipelines._check_config(PipelineConfig(**overrides))


def test_unknown_raster_backend_raises():
    with pytest.raises(ValueError, match="backend"):
        pipelines._check_config(PipelineConfig(raster_backend="cuda"))
