"""Elastic mesh arithmetic: the usable grid of a fleet that lost nodes.

Port of ``repro.runtime.elastic.shrink_mesh_plan`` (plain integer
arithmetic); re-sharding state onto the smaller mesh is not ported.
"""

from __future__ import annotations

from typing import Tuple


def shrink_mesh_plan(n_alive: int, prefer_model: int = 16
                     ) -> Tuple[int, int]:
    """(data, model) for the largest usable grid ≤ n_alive chips.

    Keeps the model axis at ``prefer_model`` if possible (weights must
    still fit per-chip), else the largest power-of-two divisor.
    """
    model = prefer_model
    while model > 1 and n_alive // model < 1:
        model //= 2
    data = n_alive // model
    # largest power of two ≤ data (collectives want power-of-two groups)
    p = 1
    while p * 2 <= data:
        p *= 2
    return p, model
