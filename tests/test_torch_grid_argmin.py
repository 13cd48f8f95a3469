"""The port's grid-argmin op (plain PyTorch version, CPU) against the JAX op.

The JAX op runs twice: through its lax reference (``impl="ref"``) and
through the Pallas kernel body in interpret mode (``impl="interpret"``),
as ``tests/test_kernels_grid_argmin.py`` runs it on the CPU.  The sweep
covers every technique row plus the hybrid gear rows, both grid shapes,
one roofline (``delay_mode`` = max) platform and one row with nothing
feasible.  Power agrees within 1e-5 (the Pallas body sums the power terms
in another order), ``feasible`` and both voltages exactly.

The CUDA kernel itself runs only on the card; ``chip_smoke.py`` holds it
against the same plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import characterization as jchar
from repro.core import controller as jctl
from repro.core import voltage as jvolt
from repro.core.accelerators import ACCELERATORS as JACC
from repro.kernels.grid_argmin import grid_argmin as j_grid_argmin
from repro_torch import convert
from repro_torch.core import characterization as tchar
from repro_torch.core import voltage as tvolt
from repro_torch.kernels.grid_argmin import grid_argmin, grid_argmin_ref

POWER_TOL = 1e-5


def _fleet():
    """Five Table I accelerators plus one roofline platform, as numpy leaves."""
    jp = jchar.stack_platform_params(
        [jctl.fpga_platform(JACC[n]).params for n in sorted(JACC)]
        + [jchar.tpu_platform_params(0.002, 0.012, 0.001, "max")])
    return jp, {f: np.asarray(x) for f, x in zip(jp._fields, jp)}


def _rows(grids, n_bins=25, margin=0.05):
    """[R, C, B] masks and [R, M] levels: every technique, every hybrid
    gear, and one row that excludes the nominal corner at f = 1."""
    levels = np.asarray(jvolt.bin_frequency_levels(n_bins, margin, 0.10))
    masks = [np.asarray(jvolt.technique_grid_mask(t, grids)) for t in jctl.TECHNIQUES]
    rows = [levels] * len(masks)
    _, f_node, _ = jctl._hybrid_gears(jctl.ControllerConfig(n_bins=n_bins, margin=margin))
    full = np.asarray(jvolt.technique_grid_mask("hybrid", grids))
    masks += [full] * f_node.shape[0]
    rows += list(np.asarray(f_node))
    no_nominal = np.ones_like(full)
    no_nominal[-1, -1] = False
    masks.append(no_nominal)
    rows.append(np.ones(n_bins, np.float32))
    return np.stack(masks), np.stack(rows).astype(np.float32)


@pytest.mark.parametrize("impl", ["ref", "interpret"])
@pytest.mark.parametrize("grid_name", ["default", "core_only"])
def test_plain_sweep_matches_jax_op(grid_name, impl):
    jg = getattr(jvolt.VoltageGrids, grid_name)()
    tg = getattr(tvolt.VoltageGrids, grid_name)()
    jp, leaves = _fleet()
    masks, levels = _rows(jg)
    ref = j_grid_argmin(jp, jnp.asarray(masks), jnp.asarray(levels), jg.core,
                        jg.bram, impl=impl)
    tp = convert.platform_params_from_numpy(leaves, device="cpu")
    before = grid_argmin.launches
    out = grid_argmin(tp, torch.from_numpy(masks), torch.from_numpy(levels),
                      tg.core, tg.bram)
    assert grid_argmin.launches == before  # the plain version launches nothing
    n_p, n_r, n_m = len(JACC) + 1, masks.shape[0], levels.shape[1]
    for f in ("v_core", "v_bram", "f_rel", "power", "feasible"):
        assert tuple(getattr(out, f).shape) == (n_p, n_r, n_m), f
    np.testing.assert_array_equal(out.feasible.numpy(), np.asarray(ref.feasible))
    np.testing.assert_array_equal(out.v_core.numpy(), np.asarray(ref.v_core))
    np.testing.assert_array_equal(out.v_bram.numpy(), np.asarray(ref.v_bram))
    np.testing.assert_array_equal(out.f_rel.numpy(), np.asarray(ref.f_rel))
    np.testing.assert_allclose(out.power.numpy(), np.asarray(ref.power),
                               rtol=POWER_TOL, atol=POWER_TOL)
    # the FPGA platforms find nothing feasible on the last row: the
    # nominal-corner fallback is exercised
    assert not out.feasible[:len(JACC), -1].any()
    np.testing.assert_array_equal(out.v_core[:len(JACC), -1].numpy(),
                                  tg.core[-1].item())
    np.testing.assert_array_equal(out.v_bram[:len(JACC), -1].numpy(),
                                  tg.bram[-1].item())


def test_masked_grid_argmin_breaks_ties_toward_first_flat_index():
    rng = np.random.default_rng(0)
    c, b = 4, 5
    power = np.full((3, c, b), 2.0, np.float32)
    power[0] = rng.uniform(1.0, 2.0, (c, b))
    power[0, 1, 2] = power[0, 3, 0] = 0.5   # tie between flat 7 and 15
    feasible = np.ones((3, c, b), bool)
    feasible[2] = False                     # nothing feasible: fallback
    core = np.linspace(0.5, 0.8, c).astype(np.float32)
    bram = np.linspace(0.5, 0.95, b).astype(np.float32)
    f = np.float32(0.5)
    fallback = np.float32(9.0)
    ref = jax.vmap(jvolt.masked_grid_argmin, in_axes=(0, 0, None, None, None, None))(
        jnp.asarray(power), jnp.asarray(feasible), jnp.asarray(core),
        jnp.asarray(bram), f, fallback)
    out = tvolt.masked_grid_argmin(torch.from_numpy(power), torch.from_numpy(feasible),
                                   torch.from_numpy(core), torch.from_numpy(bram),
                                   torch.tensor(f), torch.tensor(fallback))
    for field in out._fields:
        np.testing.assert_array_equal(getattr(out, field).numpy(),
                                      np.asarray(getattr(ref, field)), err_msg=field)
    assert out.v_core[0].item() == core[1] and out.v_bram[0].item() == bram[2]
    assert out.v_core[1].item() == core[0] and out.v_bram[1].item() == bram[0]
    assert out.power[2].item() == 9.0 and not out.feasible[2]


def _table2_inputs():
    tp = tchar.stack_platform_params(
        [tchar.analytic_platform_params(), tchar.analytic_platform_params(0.3, 0.5)])
    g = tvolt.VoltageGrids.default()
    masks = torch.stack([tvolt.technique_grid_mask("proposed", g)])
    levels = tvolt.bin_frequency_levels(5, 0.25)[None]
    return tp, masks, levels, g


def test_op_checks_dtype_shape_and_devices():
    tp, masks, levels, g = _table2_inputs()
    with pytest.raises(TypeError, match="masks"):
        grid_argmin(tp, masks.float(), levels, g.core, g.bram)
    with pytest.raises(TypeError, match="levels"):
        grid_argmin(tp, masks, levels.double(), g.core, g.bram)
    with pytest.raises(ValueError, match="masks"):
        grid_argmin(tp, masks[:, :-1], levels, g.core, g.bram)
    with pytest.raises(ValueError, match="levels"):
        grid_argmin(tp, masks, torch.cat([levels, levels]), g.core, g.bram)
    with pytest.raises(ValueError, match="pw_kappa"):
        grid_argmin(tp._replace(pw_kappa=tp.pw_kappa[:, :-1]), masks, levels,
                    g.core, g.bram)
    with pytest.raises(ValueError, match="devices"):
        grid_argmin(tp, masks.to("meta"), levels, g.core, g.bram)


def test_op_on_cpu_equals_plain_version():
    tp, masks, levels, g = _table2_inputs()
    out = grid_argmin(tp, masks, levels, g.core, g.bram)
    ref = grid_argmin_ref(tp, masks, levels, g.core, g.bram)
    for field in out._fields:
        assert torch.equal(getattr(out, field), getattr(ref, field)), field
