"""The one device rule every entry point of the port follows."""

from __future__ import annotations

import os

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` means the CUDA card (under ``torchrun``, this rank's
    ``cuda:{LOCAL_RANK}``); ``"cpu"`` must be asked for.

    Raises when the card is wanted but absent, so a run never falls back
    to the CPU without the caller saying so.
    """
    if device is None:
        rank = os.environ.get("LOCAL_RANK")
        dev = torch.device("cuda") if rank is None else torch.device("cuda", int(rank))
    else:
        dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (want 'cuda' or 'cpu')")
    return dev
