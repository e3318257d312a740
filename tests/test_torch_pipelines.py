"""What ``st3d_torch.engine.pipelines`` refuses before any work: the one
option the port does not run yet (data and tile parallelism) is named in
the NotImplementedError, by what it is and never by a ROADMAP item number
(those numbers move whenever the queues are re-anchored); checkpoints,
``--resume``, ``--profile`` and ``--debug_nan`` run
(``tests/test_torch_checkpoint.py``)."""

import pytest

from st3d_torch.engine import pipelines
from st3d_torch.engine.config import PipelineConfig


@pytest.mark.parametrize("overrides,feature", [
    ({"data_parallel": True}, "parallelism"),
    ({"tile_parallel": True}, "parallelism")])
def test_unported_option_is_named_without_an_item_number(overrides, feature):
    cfg = PipelineConfig(**overrides)
    why = pipelines._unsupported(cfg)
    assert feature in why
    assert "item" not in why.lower() and "roadmap" not in why.lower()
    with pytest.raises(NotImplementedError, match=feature):
        pipelines._check_config(cfg)


@pytest.mark.parametrize("overrides", [
    {}, {"checkpoint_every": 10, "resume": True},
    {"profile": True, "debug_nan": True}])
def test_default_config_runs(overrides):
    assert pipelines._unsupported(PipelineConfig(**overrides)) == ""
    pipelines._check_config(PipelineConfig(**overrides))
