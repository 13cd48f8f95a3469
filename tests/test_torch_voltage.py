"""The closure half of ``core/voltage.py`` in the port, against the JAX
package's, on the CPU.

* ``fpga_delay_fn`` / ``tpu_delay_fn`` and the power models'
  closures, the characterization helpers they read
  (``core_delay_factor``, ``bram_delay_factor``, ``tpu_core_delay_factor``,
  ``tpu_hbm_delay_factor``, ``AppPowerModel.power_breakdown`` / ``beta``)
  and ``PlatformSpec``'s closure fields, against JAX's;
* ``optimize_batch`` and ``build_operating_table`` for the five Table I
  accelerators (and the §III analytic and a TPU platform) × the default,
  core-only, BRAM-only and frequency-only grids × 25 bin levels and a
  spread of levels: grid points and ``feasible`` equal, power within
  1e-5 relative;
* the port's closure and params paths (``optimize_batch_params`` with the
  technique's mask on the full grid, ``build_bin_tables`` through B1's
  plain version) pick the same grid points;
* ``OperatingTable.lookup`` ceils and clips, and the cases of
  ``tests/test_voltage_opt.py``, in the port.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import characterization as jchar
from repro.core import controller as jctl
from repro.core import voltage as jvolt
from repro.core.accelerators import ACCELERATORS as JACC
from repro_torch.core import characterization as char
from repro_torch.core import controller as ctl
from repro_torch.core import voltage as volt
from repro_torch.core.accelerators import ACCELERATORS

RTOL = 1e-5
GRIDS = ("default", "core_only", "bram_only", "frequency_only")
MASK_OF = {"default": "proposed", "core_only": "core_only", "bram_only": "bram_only",
           "frequency_only": "freq_only"}
LEVELS = np.concatenate([np.asarray(jvolt.bin_frequency_levels(25, 0.05, 0.10)),
                         np.linspace(0.02, 1.0, 17, dtype=np.float32)]).astype(np.float32)


def _platforms(name):
    if name in ACCELERATORS:
        return jctl.fpga_platform(JACC[name]), ctl.fpga_platform(ACCELERATORS[name])
    if name == "analytic":
        return jctl.analytic_platform(0.2, 0.4), ctl.analytic_platform(0.2, 0.4)
    args = (1e-3, 2.5e-3, 0.4e-3)
    return (jctl.tpu_platform(*args, composition="sum"),
            ctl.tpu_platform(*args, composition="sum"))


def _grids(kind):
    j = jvolt.VoltageGrids.default() if kind == "default" else getattr(jvolt.VoltageGrids, kind)()
    t = volt.VoltageGrids.default() if kind == "default" else getattr(volt.VoltageGrids, kind)()
    return j, t


def _hold_points(got, want, what):
    for field in ("v_core", "v_bram", "f_rel", "feasible"):
        np.testing.assert_array_equal(getattr(got, field).cpu().numpy(),
                                      np.asarray(getattr(want, field)), err_msg=f"{what} {field}")
    np.testing.assert_allclose(got.power.cpu().numpy(), np.asarray(want.power), rtol=RTOL,
                               atol=0, err_msg=f"{what} power")


PLATFORMS = sorted(ACCELERATORS) + ["analytic", "tpu"]


def test_platform_list_is_table_one():
    assert sorted(ACCELERATORS) == sorted(JACC) and len(ACCELERATORS) == 5


@pytest.mark.parametrize("kind", GRIDS)
@pytest.mark.parametrize("name", PLATFORMS)
def test_optimize_batch_matches_jax(name, kind):
    jp, tp = _platforms(name)
    jg, tg = _grids(kind)
    want = jvolt.optimize_batch(jp.delay_fn, jp.power_fn, jnp.asarray(LEVELS), jg)
    got = volt.optimize_batch(tp.delay_fn, tp.power_fn, torch.from_numpy(LEVELS), tg)
    _hold_points(got, want, f"{name} {kind}")
    # one level at a time equals the batch (the JAX package's vmap)
    for i in (0, 7, 24, len(LEVELS) - 1):
        one = volt.optimize_point(tp.delay_fn, tp.power_fn, float(LEVELS[i]), tg)
        assert one.power.shape == ()
        for field in one._fields:
            assert torch.equal(getattr(one, field), getattr(got, field)[i]), (name, field, i)


@pytest.mark.parametrize("kind", GRIDS)
@pytest.mark.parametrize("name", sorted(ACCELERATORS))
def test_closure_and_params_paths_pick_the_same_points(name, kind):
    _, tp = _platforms(name)
    _, tg = _grids(kind)
    levels = torch.from_numpy(LEVELS)
    closure = volt.optimize_batch(tp.delay_fn, tp.power_fn, levels, tg)
    full = volt.VoltageGrids.default()
    params = volt.optimize_batch_params(tp.params, levels, full.core, full.bram,
                                        volt.technique_grid_mask(MASK_OF[kind], full))
    for field in ("v_core", "v_bram", "feasible"):
        assert torch.equal(getattr(closure, field), getattr(params, field)), (name, kind, field)
    torch.testing.assert_close(closure.power, params.power, rtol=RTOL, atol=0)


@pytest.mark.parametrize("technique", ["proposed", "core_only", "bram_only", "freq_only"])
@pytest.mark.parametrize("name", sorted(ACCELERATORS))
def test_build_bin_tables_agrees_with_the_operating_table(name, technique):
    """``build_bin_tables`` (the params path, B1's plain version on the CPU)
    and ``build_operating_table`` (the closure path) at the bin levels."""
    _, tp = _platforms(name)
    cfg = ctl.ControllerConfig(technique=technique)
    bt = ctl.build_bin_tables(tp, cfg, device="cpu")
    kind = {v: k for k, v in MASK_OF.items()}[technique]
    grids = volt.VoltageGrids.default() if kind == "default" else getattr(volt.VoltageGrids,
                                                                          kind)()
    table = volt.build_operating_table(
        tp.delay_fn, tp.power_fn, volt.bin_frequency_levels(cfg.n_bins, cfg.margin,
                                                            cfg.f_floor), grids)
    assert torch.equal(bt.v_core, table.v_core) and torch.equal(bt.v_bram, table.v_bram)


@pytest.mark.parametrize("kind", GRIDS)
@pytest.mark.parametrize("name", PLATFORMS)
def test_operating_table_matches_jax(name, kind):
    jp, tp = _platforms(name)
    jg, tg = _grids(kind)
    shuffled = LEVELS[np.random.default_rng(0).permutation(len(LEVELS))]
    # JAX's analytic power_fn calls float() on a traced value, so its jitted
    # table build raises (a reference quirk); op by op it runs
    with jax.disable_jit() if name == "analytic" else contextlib.nullcontext():
        want = jvolt.build_operating_table(jp.delay_fn, jp.power_fn, jnp.asarray(shuffled),
                                           jg)
    got = volt.build_operating_table(tp.delay_fn, tp.power_fn, torch.from_numpy(shuffled), tg)
    for field in ("f_levels", "v_core", "v_bram"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)), err_msg=field)
    np.testing.assert_allclose(got.power.numpy(), np.asarray(want.power), rtol=RTOL)
    for f in (0.0, 0.05, 0.37, 0.42, float(LEVELS[3]), 0.999, 1.0, 1.5):
        _hold_points(got.lookup(f), want.lookup(jnp.asarray(f)), f"{name} {kind} lookup {f}")
    batch = torch.tensor([[0.1, 0.6], [0.37, 2.0]])
    pts = got.lookup(batch)
    assert pts.power.shape == (2, 2) and bool(pts.feasible.all())


def test_delay_and_power_helpers_match_jax():
    v = np.linspace(0.5, 0.95, 19, dtype=np.float32)
    tv, jv = torch.from_numpy(v), jnp.asarray(v)
    mix = {"logic": 0.3, "routing": 0.5, "dsp": 0.2}
    pairs = [(char.core_delay_factor(tv), jchar.core_delay_factor(jv)),
             (char.core_delay_factor(tv, mix), jchar.core_delay_factor(jv, mix)),
             (char.bram_delay_factor(tv), jchar.bram_delay_factor(jv)),
             (char.tpu_core_delay_factor(tv), jchar.tpu_core_delay_factor(jv)),
             (char.tpu_hbm_delay_factor(tv), jchar.tpu_hbm_delay_factor(jv))]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)
    vb = v[::-1].copy()
    for name in sorted(ACCELERATORS):
        tpm, jpm = ACCELERATORS[name].power_model(), JACC[name].power_model()
        got = tpm.power_breakdown(tv, torch.from_numpy(vb), torch.tensor(0.6))
        want = jpm.power_breakdown(jv, jnp.asarray(vb), jnp.asarray(0.6))
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=RTOL,
                                       err_msg=f"{name} {k}")
        torch.testing.assert_close(sum(got.values()), tpm.power(tv, torch.from_numpy(vb),
                                                                torch.tensor(0.6)), rtol=1e-6,
                                   atol=0)
        assert tpm.beta() == pytest.approx(jpm.beta(), rel=RTOL)


@pytest.mark.parametrize("name", PLATFORMS)
def test_platform_spec_closures_match_jax(name):
    jp, tp = _platforms(name)
    assert tp.nominal_power_arb == pytest.approx(jp.nominal_power_arb, rel=RTOL)
    assert tp.watts_scale == pytest.approx(jp.watts_scale, rel=RTOL)
    vc = np.linspace(0.5, 0.8, 13, dtype=np.float32)[:, None]
    vb = np.linspace(0.5, 0.95, 19, dtype=np.float32)[None, :]
    t = (torch.from_numpy(vc), torch.from_numpy(vb))
    j = (jnp.asarray(vc), jnp.asarray(vb))
    np.testing.assert_allclose(tp.delay_fn(*t).numpy(), np.asarray(jp.delay_fn(*j)), rtol=RTOL)
    np.testing.assert_allclose(tp.power_watts(*t, torch.tensor(0.7)).numpy(),
                               np.asarray(jp.power_watts(*j, jnp.asarray(0.7))), rtol=RTOL)
    # the closures agree with the params model of the same spec
    np.testing.assert_allclose(tp.delay_fn(*t).numpy(),
                               char.params_delay(tp.params, *t).numpy(), rtol=RTOL)


# ------------------------------------------------ tests/test_voltage_opt.py, in the port


def _platform(name="tabla"):
    return ctl.fpga_platform(ACCELERATORS[name])


def test_nominal_frequency_feasible_at_nominal_voltages():
    p = _platform()
    pt = volt.optimize_point(p.delay_fn, p.power_fn, 1.0, volt.VoltageGrids.default())
    assert bool(pt.feasible)
    assert float(pt.v_core) >= char.V_CORE_NOM - 1e-6


def test_joint_beats_single_rail_everywhere():
    p = _platform()
    for f in (0.3, 0.5, 0.7, 0.9):
        joint = volt.optimize_point(p.delay_fn, p.power_fn, f, volt.VoltageGrids.default())
        core = volt.optimize_point(p.delay_fn, p.power_fn, f, volt.VoltageGrids.core_only())
        bram = volt.optimize_point(p.delay_fn, p.power_fn, f, volt.VoltageGrids.bram_only())
        assert float(joint.power) <= float(core.power) + 1e-6
        assert float(joint.power) <= float(bram.power) + 1e-6


def test_selected_point_meets_timing():
    p = _platform("diannao")
    for f in (0.25, 0.5, 0.75, 1.0):
        pt = volt.optimize_point(p.delay_fn, p.power_fn, f, volt.VoltageGrids.default())
        assert float(p.delay_fn(pt.v_core, pt.v_bram)) <= 1.0 / f + 1e-5


@settings(max_examples=30, deadline=None)
@given(f=st.floats(min_value=0.1, max_value=1.0))
def test_power_monotone_in_frequency(f):
    p = _platform()
    grids = volt.VoltageGrids.default()
    lo = volt.optimize_point(p.delay_fn, p.power_fn, f, grids)
    hi = volt.optimize_point(p.delay_fn, p.power_fn, 1.0, grids)
    assert float(lo.power) <= float(hi.power) + 1e-6


def test_operating_table_lookup_ceils():
    p = _platform()
    levels = volt.bin_frequency_levels(10, 0.05)
    table = volt.build_operating_table(p.delay_fn, p.power_fn, levels)
    for f in (0.0, 0.42, 0.5, 0.99):
        pt = table.lookup(f)
        assert float(pt.f_rel) >= f
        i = int(torch.searchsorted(table.f_levels, torch.tensor(f)))
        assert i == 0 or float(table.f_levels[i - 1]) < f      # the lowest such level
    assert float(table.lookup(1.5).f_rel) == float(table.f_levels[-1])   # clipped


def test_voltages_on_grid_resolution():
    p = _platform()
    pt = volt.optimize_point(p.delay_fn, p.power_fn, 0.5, volt.VoltageGrids.default())
    for v in (float(pt.v_core), float(pt.v_bram)):
        steps = (v - char.V_CRASH) / char.V_STEP
        assert abs(steps - round(steps)) < 1e-4


def test_first_index_tie_and_infeasible_fallback():
    """A power flat along V_bram ties a whole row: the first index (lowest
    V_bram) wins, as ``masked_grid_argmin`` picks; a level nothing meets
    falls back to the nominal corner at the nominal point's power."""
    grids = volt.VoltageGrids.default()
    flat = lambda vc, vb, f: (vc * vc * f) + 0.0 * vb                      # noqa: E731
    delay = lambda vc, vb: char.core_delay_factor(vc) + 0.0 * vb           # noqa: E731
    pt = volt.optimize_batch(delay, flat, torch.tensor([0.5, 0.9]), grids)
    assert torch.equal(pt.v_bram, grids.bram[[0, 0]])
    never = lambda vc, vb: 10.0 + 0.0 * vc * vb                            # noqa: E731
    pt = volt.optimize_point(never, flat, 0.8, grids)
    assert not bool(pt.feasible)
    assert float(pt.v_core) == float(grids.core[-1]) and float(pt.v_bram) == float(grids.bram[-1])
    assert float(pt.power) == pytest.approx(float(grids.core[-1]) ** 2 * 0.8, rel=1e-6)
