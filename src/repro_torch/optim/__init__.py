"""The optimizer (port of ``repro.optim``): AdamW, the schedule and int8
gradient compression."""

from repro_torch.optim.adamw import (AdamWState, adamw_init, adamw_update, global_norm,
                                     opt_state_layout)
from repro_torch.optim.compress import compress_gradients
from repro_torch.optim.schedule import make_schedule

__all__ = ["AdamWState", "adamw_init", "adamw_update", "global_norm",
           "make_schedule", "compress_gradients", "opt_state_layout"]
