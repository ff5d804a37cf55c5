"""Pipeline parallelism: stage partitioning, the one-device reference engine
and the multi-rank engine (port of ``repro.pipeline``)."""

from repro_torch.pipeline.engine import make_pipeline_step, reduce_replicated, reference_pipeline_grads
from repro_torch.pipeline.stage import StagedModel

__all__ = ["StagedModel", "make_pipeline_step", "reference_pipeline_grads", "reduce_replicated"]
