"""Serving of the port: the generation engine, the continuous batcher and
the DVFS autoscaler."""

from repro_torch.serving.autoscale import DvfsServingSimulator
from repro_torch.serving.engine import ServeEngine, make_decode_step, make_prefill

__all__ = ["ServeEngine", "make_decode_step", "make_prefill", "DvfsServingSimulator"]
