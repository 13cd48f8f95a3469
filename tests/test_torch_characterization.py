"""The PyTorch port's platform model against the JAX package, on the CPU.

Both packages must compute on the same constants: the padded
``PlatformParams`` leaves of every platform constructor agree within 1e-6
(they come out bit-equal today), the delay/power closed forms agree at
random operating points, and the numpy workload generator is
bit-identical.  JAX runs on the CPU; data crosses as numpy arrays.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import characterization as jchar
from repro.core import controller as jctl
from repro.core import pll as jpll
from repro.core import voltage as jvolt
from repro.core import workload as jwl
from repro.core.accelerators import ACCELERATORS as JACC
from repro.core.accelerators import PAPER_TABLE_II as J_TABLE_II
from repro_torch import convert
from repro_torch.core import characterization as tchar
from repro_torch.core import controller as tctl
from repro_torch.core import pll as tpll
from repro_torch.core import voltage as tvolt
from repro_torch.core import workload as twl
from repro_torch.core.accelerators import ACCELERATORS as TACC
from repro_torch.core.accelerators import PAPER_TABLE_II as T_TABLE_II

TOL = 1e-6

# (name, jax constructor, port constructor): every platform constructor of the slice.
BUILDERS = (
    [(f"fpga:{n}", lambda n=n: jctl.fpga_platform(JACC[n]).params,
      lambda n=n: tctl.fpga_platform(TACC[n]).params) for n in sorted(JACC)]
    + [(f"analytic:{a}:{b}",
        lambda a=a, b=b: jchar.analytic_platform_params(a, b),
        lambda a=a, b=b: tchar.analytic_platform_params(a, b))
       for a, b in ((0.2, 0.4), (0.05, 0.9))]
    + [(f"tpu:{c}", lambda c=c: jchar.tpu_platform_params(0.002, 0.012, 0.001, c),
        lambda c=c: tchar.tpu_platform_params(0.002, 0.012, 0.001, c))
       for c in ("max", "sum")]
)


def _leaves(params) -> dict:
    return {f: np.asarray(x) for f, x in zip(params._fields, params)}


@pytest.mark.parametrize("name,jfn,tfn", BUILDERS, ids=[b[0] for b in BUILDERS])
def test_platform_params_match(name, jfn, tfn):
    ref, port = _leaves(jfn()), tfn()
    assert port._fields == jchar.PlatformParams._fields
    for f, x in zip(port._fields, port):
        want = torch.int32 if f in tchar.INT_FIELDS else torch.float32
        assert x.dtype == want, f
        assert x.shape == ref[f].shape, f
        np.testing.assert_allclose(x.numpy(), ref[f], rtol=TOL, atol=0, err_msg=f)


@pytest.mark.parametrize("name,jfn,tfn", BUILDERS, ids=[b[0] for b in BUILDERS])
def test_platform_params_from_numpy_round_trips(name, jfn, tfn):
    ref = _leaves(jfn())
    port = convert.platform_params_from_numpy(ref, device="cpu")
    for f, x in zip(port._fields, port):
        np.testing.assert_array_equal(x.numpy(), ref[f], err_msg=f)
        assert x.numpy().dtype == ref[f].dtype, f
    # and it matches what the port builds on its own
    for a, b in zip(port, tfn()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=TOL, atol=0)


def test_platform_params_from_numpy_rejects_wrong_fields():
    leaves = _leaves(jchar.analytic_platform_params())
    del leaves["watts_scale"]
    with pytest.raises(ValueError, match="watts_scale"):
        convert.platform_params_from_numpy(leaves, device="cpu")


@pytest.mark.parametrize("seed", [0, 1])
def test_params_delay_and_power_match_at_random_points(seed):
    """The closed forms of a stacked fleet at random rails and clocks."""
    rng = np.random.default_rng(seed)
    jp = jchar.stack_platform_params([b[1]() for b in BUILDERS])
    tp = convert.platform_params_from_numpy(_leaves(jp), device="cpu")
    n = len(BUILDERS)
    vc = rng.uniform(0.5, 0.8, (16, n)).astype(np.float32)
    vb = rng.uniform(0.5, 0.95, (16, n)).astype(np.float32)
    f = rng.uniform(0.1, 1.0, (16, n)).astype(np.float32)
    d_ref = np.asarray(jchar.params_delay(jp, vc, vb))
    p_ref = np.asarray(jchar.params_power_watts(jp, vc, vb, f))
    d = tchar.params_delay(tp, torch.from_numpy(vc), torch.from_numpy(vb))
    p = tchar.params_power_watts(tp, torch.from_numpy(vc), torch.from_numpy(vb),
                                 torch.from_numpy(f))
    np.testing.assert_allclose(d.numpy(), d_ref, rtol=TOL)
    np.testing.assert_allclose(p.numpy(), p_ref, rtol=TOL)


def test_device_model_and_app_power_match():
    for name in sorted(JACC):
        ja, ta = JACC[name], TACC[name]
        assert dataclasses.asdict(ja.util) == dataclasses.asdict(ta.util)
        assert dataclasses.asdict(ja.device()) == dataclasses.asdict(ta.device())
        assert ja.alpha == ta.alpha and dict(ja.core_mix) == dict(ta.core_mix)
        j_pm, t_pm = ja.power_model(), ta.power_model()
        assert j_pm._counts() == t_pm._counts()
        np.testing.assert_allclose(float(t_pm.nominal_power()),
                                   float(j_pm.nominal_power()), rtol=TOL)
    assert T_TABLE_II == J_TABLE_II
    np.testing.assert_allclose(float(tchar.TpuChipPowerModel().nominal_power()),
                               float(jchar.TpuChipPowerModel().nominal_power()),
                               rtol=TOL)
    for lib in ("FPGA_LIBRARY", "TPU_LIBRARY"):
        j_lib, t_lib = getattr(jchar, lib), getattr(tchar, lib)
        assert {k: dataclasses.asdict(v) for k, v in j_lib.items()} == \
            {k: dataclasses.asdict(v) for k, v in t_lib.items()}


@pytest.mark.parametrize("step", [0.025, 0.05, 0.03])
def test_voltage_grids_masks_and_levels_match(step):
    for gname in ("default", "core_only", "bram_only"):
        jg, tg = getattr(jvolt.VoltageGrids, gname)(step), \
            getattr(tvolt.VoltageGrids, gname)(step)
        np.testing.assert_array_equal(tg.core.numpy(), np.asarray(jg.core))
        np.testing.assert_array_equal(tg.bram.numpy(), np.asarray(jg.bram))
        for tech in jctl.TECHNIQUES:
            np.testing.assert_array_equal(
                tvolt.technique_grid_mask(tech, tg).numpy(),
                np.asarray(jvolt.technique_grid_mask(tech, jg)))
    fo_j, fo_t = jvolt.VoltageGrids.frequency_only(), tvolt.VoltageGrids.frequency_only()
    np.testing.assert_array_equal(fo_t.core.numpy(), np.asarray(fo_j.core))
    for m, margin, floor in ((25, 0.05, 0.10), (7, 0.2, 0.05)):
        np.testing.assert_array_equal(
            tvolt.bin_frequency_levels(m, margin, floor).numpy(),
            np.asarray(jvolt.bin_frequency_levels(m, margin, floor)))


def test_optimize_batch_params_matches():
    """One platform's per-level operating points (the §V table rows)."""
    grids_j, grids_t = jvolt.VoltageGrids.default(), tvolt.VoltageGrids.default()
    levels = np.linspace(0.1, 1.0, 19).astype(np.float32)
    ref_fn = jax.jit(jvolt.optimize_batch_params)
    for name in sorted(JACC):
        jp = jctl.fpga_platform(JACC[name]).params
        tp = convert.platform_params_from_numpy(_leaves(jp), device="cpu")
        for tech in ("proposed", "core_only", "bram_only", "freq_only"):
            ref = ref_fn(
                jp, jnp.asarray(levels), grids_j.core, grids_j.bram,
                jvolt.technique_grid_mask(tech, grids_j))
            out = tvolt.optimize_batch_params(
                tp, torch.from_numpy(levels), grids_t.core, grids_t.bram,
                tvolt.technique_grid_mask(tech, grids_t))
            for f in ("v_core", "v_bram", "f_rel"):
                np.testing.assert_array_equal(getattr(out, f).numpy(),
                                              np.asarray(getattr(ref, f)), err_msg=f)
            np.testing.assert_array_equal(out.feasible.numpy(), np.asarray(ref.feasible))
            np.testing.assert_allclose(out.power.numpy(), np.asarray(ref.power),
                                       rtol=1e-5)


def test_pll_stall_fraction_matches():
    for dual in (True, False):
        for tau in (1e-6, 1e-4, 1.0):
            j_cfg, t_cfg = jpll.PllConfig(dual=dual), tpll.PllConfig(dual=dual)
            assert dataclasses.asdict(j_cfg) == dataclasses.asdict(t_cfg)
            assert tpll.stall_fraction(t_cfg, tau) == jpll.stall_fraction(j_cfg, tau)


@pytest.mark.parametrize("cfg", [
    dict(n_steps=2048, seed=0),
    dict(n_steps=1024, seed=0),
    dict(n_steps=300, seed=7, mean_load=0.6, hurst=0.9, idc=50.0, aggregate=4),
    dict(n_steps=64, seed=3, hurst=0.5, aggregate=1),
], ids=["table2_2048", "table2_1024", "custom", "white_noise"])
def test_generate_trace_is_bit_identical(cfg):
    ref = jwl.generate_trace(jwl.WorkloadConfig(**cfg))
    out = twl.generate_trace(twl.WorkloadConfig(**cfg))
    assert out.dtype == ref.dtype and out.shape == ref.shape
    np.testing.assert_array_equal(out, ref)


_PLL_CONFIGS = {"default": {}, "single": dict(dual=False),
                "other": dict(t_lock=50e-6, p_pll=0.3, p_design=35.0, dual=False)}


@pytest.mark.parametrize("cfg_name", list(_PLL_CONFIGS))
@pytest.mark.parametrize("tau", ["1e-4", "1e-3", "breakeven-10%", "breakeven+10%", "1", "60"])
@pytest.mark.parametrize("dual", [True, False])
def test_pll_energy_overheads_and_breakeven_match(cfg_name, tau, dual):
    """Eq. 4-5: every function of ``core/pll`` equals the reference's, exactly."""
    kw = dict(_PLL_CONFIGS[cfg_name], dual=dual)
    j_cfg, t_cfg = jpll.PllConfig(**kw), tpll.PllConfig(**kw)
    assert dataclasses.asdict(j_cfg) == dataclasses.asdict(t_cfg)
    be = jpll.breakeven_tau(j_cfg)
    assert tpll.breakeven_tau(t_cfg) == be
    t = {"breakeven-10%": 0.9 * be, "breakeven+10%": 1.1 * be}.get(tau) or float(tau)
    for fn in ("energy_overhead_single", "energy_overhead_dual", "energy_overhead",
               "stall_fraction", "should_use_dual"):
        assert getattr(tpll, fn)(t_cfg, t) == getattr(jpll, fn)(j_cfg, t), fn
    assert tpll.should_use_dual(t_cfg, t) == tau.startswith(("breakeven-", "1e-"))
