"""Data (port of ``repro.data``)."""

from repro_torch.data.pipeline import DataConfig, SyntheticPipeline, make_batch_specs

__all__ = ["DataConfig", "SyntheticPipeline", "make_batch_specs"]
