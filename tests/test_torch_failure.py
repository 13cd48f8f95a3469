"""The port's failure models and mesh arithmetic against the JAX package's.

``FailureModel`` is numpy: its sampled up/down matrices, event lists,
schedules and ``nodes_fn`` builders must be bit-equal for the three named
models (and a few more) and two seeds; ``shrink_mesh_plan`` must agree
for every surviving count.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import scenarios as jscn
from repro.runtime import elastic as jelastic
from repro.runtime import fault as jfault
from repro_torch.core import scenarios as tscn
from repro_torch.runtime import elastic as telastic
from repro_torch.runtime import fault as tfault


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as every new port test file pins (ROADMAP C)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _models():
    """Port and reference models: the three named ones and two more."""
    extra = dict(wear_out=dict(n_nodes=12, n_racks=3, weibull_k=2.0, mttf_steps=64.0),
                 all_rack=dict(n_nodes=5, n_racks=2, rack_fraction=1.0,
                               mttf_steps=40.0, alive_floor=2))
    out = {name: (tscn.FAILURE_MODELS[name], jscn.FAILURE_MODELS[name])
           for name in ("rack_failure", "cascade", "flaky_fleet")}
    for name, kw in extra.items():
        out[name] = (tfault.FailureModel(**kw), jfault.FailureModel(**kw))
    return out


MODELS = _models()


def test_named_models_carry_the_same_parameters():
    for name, (t, j) in MODELS.items():
        assert dataclasses.asdict(t) == dataclasses.asdict(j), name


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("seed", [0, 1])
def test_sample_and_schedules_bit_equal(name, seed):
    t, j = MODELS[name]
    n = 600
    # a shorter MTTF so every model fails within the trace
    t, j = (dataclasses.replace(m, mttf_steps=min(m.mttf_steps, 150.0)) for m in (t, j))
    ts, js = t.sample(n, seed), j.sample(n, np.random.default_rng(seed))
    np.testing.assert_array_equal(ts.alive, js.alive)
    assert [tuple(e) for e in ts.events] == [tuple(e) for e in js.events]
    assert len(ts.events) > 0
    for fn in ("alive_counts", "alive_fraction", "node_schedule"):
        a, b = getattr(t, fn)(n, seed), getattr(j, fn)(n, seed)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for frac in (None, 1 / 3, 1 / 8):
        for steps in (64, 512):
            a = t.nodes_fn(mttf_frac=frac)(steps, np.random.default_rng([seed, 7]))
            b = j.nodes_fn(mttf_frac=frac)(steps, np.random.default_rng([seed, 7]))
            np.testing.assert_array_equal(a, b)


def test_rack_members_and_validation_match():
    for name, (t, j) in MODELS.items():
        for a, b in zip(t.rack_members(), j.rack_members()):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(t._hazards(), j._hazards())
    for bad in (dict(n_nodes=0), dict(n_racks=9), dict(mttf_steps=0.0),
                dict(weibull_k=0.0), dict(repair_sigma=-1.0), dict(rack_fraction=1.5),
                dict(cascade_factor=0.5), dict(alive_floor=0)):
        with pytest.raises(ValueError) as te:
            tfault.FailureModel(**bad)
        with pytest.raises(ValueError) as je:
            jfault.FailureModel(**bad)
        assert str(te.value) == str(je.value)


@pytest.mark.parametrize("prefer", [1, 4, 8, 16])
def test_shrink_mesh_plan_matches(prefer):
    for n_alive in range(1, 65):
        assert telastic.shrink_mesh_plan(n_alive, prefer) == \
            jelastic.shrink_mesh_plan(n_alive, prefer), n_alive
    assert telastic.shrink_mesh_plan(64) == jelastic.shrink_mesh_plan(64)
