"""What ``st3d_torch.engine.pipelines`` refuses before any work: each
option the port does not run yet is named in the NotImplementedError, by
what it is and never by a ROADMAP item number (those numbers move whenever
the queues are re-anchored)."""

import pytest

from st3d_torch.engine import pipelines
from st3d_torch.engine.config import PipelineConfig


@pytest.mark.parametrize("overrides,feature", [
    ({"checkpoint_every": 10}, "checkpoints"),
    ({"resume": True}, "--resume"),
    ({"data_parallel": True}, "parallelism"),
    ({"tile_parallel": True}, "parallelism"),
    ({"profile": True}, "--profile"),
    ({"debug_nan": True}, "--debug_nan")])
def test_unported_option_is_named_without_an_item_number(overrides, feature):
    cfg = PipelineConfig(**overrides)
    why = pipelines._unsupported(cfg)
    assert feature in why
    assert "item" not in why.lower() and "roadmap" not in why.lower()
    with pytest.raises(NotImplementedError, match=feature):
        pipelines._check_config(cfg)


def test_default_config_runs():
    assert pipelines._unsupported(PipelineConfig()) == ""
    pipelines._check_config(PipelineConfig())
