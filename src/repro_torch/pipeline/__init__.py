"""Pipeline parallelism: stage partitioning and the reference engine (port of ``repro.pipeline``)."""

from repro_torch.pipeline.engine import reduce_replicated, reference_pipeline_grads
from repro_torch.pipeline.stage import StagedModel

__all__ = ["StagedModel", "reference_pipeline_grads", "reduce_replicated"]
