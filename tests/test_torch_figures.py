"""The paper's §III analytic platform through the port, on the CPU.

Fig. 4–6 sweep the analytic (α, β) platform.  The port's
``analytic_platform`` must carry the JAX package's parameters, its tables
must match the JAX package's (the closure path ``run_technique`` uses)
within 1e-5, and the plain grid argmin must match the JAX op's reference
on analytic platforms (α = 0 gives the BRAM delay term weight 0).  The
figure rows themselves are in ``test_torch_figure_rows.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import characterization as jchar
from repro.core import controller as jctl
from repro.core import voltage as jvolt
from repro.kernels.grid_argmin import grid_argmin as j_grid_argmin
from repro_torch.core import characterization as tchar
from repro_torch.core import controller as tctl
from repro_torch.core import voltage as tvolt
from repro_torch.core import workload as twl
from repro_torch.kernels.grid_argmin import grid_argmin

RTOL = 1e-5
ALPHA_BETA = [(0.0, 0.4), (0.2, 0.4), (0.8, 0.4), (0.2, 2.0)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as every new port test file pins (ROADMAP C)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("alpha, beta", ALPHA_BETA)
def test_analytic_platform_matches_jax(alpha, beta):
    t, j = tctl.analytic_platform(alpha, beta), jctl.analytic_platform(alpha, beta)
    assert t.name == j.name and t.watts_nominal == j.watts_nominal
    for f, x in zip(t.params._fields, t.params):
        np.testing.assert_array_equal(x.numpy(), np.asarray(getattr(j.params, f)), err_msg=f)
    np.testing.assert_allclose(t.params.nominal_power_arb.item(), 1.0 + beta, rtol=1e-6)
    np.testing.assert_allclose(tctl.nominal_node_watts(t), jctl.nominal_node_watts(j),
                               rtol=RTOL)
    for tech in jctl.TECHNIQUES:
        want = jctl.build_bin_tables(j, jctl.ControllerConfig(technique=tech))
        got = tctl.build_bin_tables(t, tctl.ControllerConfig(technique=tech), device="cpu")
        for f in want._fields:
            np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                       rtol=RTOL, atol=0, err_msg=f"{tech}: {f}")


@pytest.mark.parametrize("v_step", [0.025, 0.005])
def test_plain_sweep_on_analytic_platforms_matches_jax_op(v_step):
    """B1's plain version on the analytic platforms stacked (α = 0 among
    them), every technique's mask and every hybrid gear, against the JAX
    op's reference."""
    jp = jchar.stack_platform_params([jchar.analytic_platform_params(a, b)
                                      for a, b in ALPHA_BETA])
    tp = tchar.stack_platform_params([tchar.analytic_platform_params(a, b)
                                      for a, b in ALPHA_BETA])
    assert float(tp.dl_weight[0, -1]) == 0.0       # α = 0: a zero-weight BRAM term
    cfg = jctl.ControllerConfig(v_step=v_step)
    jg, tg = jvolt.VoltageGrids.default(v_step), tvolt.VoltageGrids.default(v_step)
    _, _, masks, levels = jctl._sweep_rows(cfg, jctl.TECHNIQUES)
    ref = j_grid_argmin(jp, masks, levels, jg.core, jg.bram, impl="ref")
    out = grid_argmin(tp, torch.tensor(np.asarray(masks)),
                      torch.tensor(np.asarray(levels)), tg.core, tg.bram)
    np.testing.assert_array_equal(out.feasible.numpy(), np.asarray(ref.feasible))
    np.testing.assert_array_equal(out.v_core.numpy(), np.asarray(ref.v_core))
    np.testing.assert_array_equal(out.v_bram.numpy(), np.asarray(ref.v_bram))
    np.testing.assert_allclose(out.power.numpy(), np.asarray(ref.power), rtol=RTOL, atol=RTOL)
    # α = 0: the BRAM rail sets no delay, so every DVFS row drops it to its floor
    np.testing.assert_array_equal(out.v_bram[0, 0].numpy(), tg.bram[0].item())


def test_compare_all_is_run_technique_per_technique():
    plat = tctl.analytic_platform(alpha=0.4, beta=1.0)
    trace = twl.generate_trace(twl.WorkloadConfig(n_steps=96, seed=2))
    out = tctl.compare_all(plat, trace, device="cpu", n_nodes=16)
    assert list(out) == list(tctl.DEFAULT_TECHNIQUES)
    for tech, s in out.items():
        assert s == tctl.run_technique(plat, trace, tech, device="cpu", n_nodes=16)
    want = jctl.run_technique(jctl.analytic_platform(alpha=0.4, beta=1.0),
                              jnp.asarray(trace), "hybrid", n_nodes=16)
    for f in ("power_gain", "qos_violation_rate", "mean_backlog", "served_fraction"):
        np.testing.assert_allclose(getattr(out["hybrid"], f), getattr(want, f), rtol=RTOL,
                                   err_msg=f)
    assert out["hybrid"].misprediction_rate == want.misprediction_rate
