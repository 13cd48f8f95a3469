"""The port's serving slice against the JAX package's, on the CPU.

``ServeEngine.generate`` on REDUCED llama3.2-1b in float32, with the JAX
package's weights carried over, must give the JAX engine's tokens (shapes
of ``tests/test_serving.py``); ``DvfsServingSimulator.run_trace`` and
``compare_techniques`` must give its ``Summary`` within 1e-5 relative
(float32 sums taken in other orders), miss rates exactly, on the trace
of ``launch/serve.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import workload as jwl
from repro.models import common as jcommon
from repro.models import transformer as jtf
from repro.serving import autoscale as jauto
from repro.serving.engine import ServeEngine as JaxEngine
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import characterization as tchar
from repro_torch.core import controller as tctl
from repro_torch.core import workload as twl
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as ttf
from repro_torch.serving import autoscale as tauto
from repro_torch.serving.engine import ServeEngine, greedy_sample

RTOL = 1e-5
MISS_FIELDS = ("misprediction_rate", "margin_misprediction_rate")
TECHNIQUES = ("proposed", "core_only", "bram_only", "freq_only", "power_gating", "hybrid")


@pytest.fixture(scope="module")
def llama():
    """REDUCED llama3.2-1b in float32: (jax cfg, port cfg, jax params, port params)."""
    jcfg = dataclasses.replace(jax_config("llama3.2-1b", reduced=True), dtype="float32")
    tcfg = dataclasses.replace(get_config("llama3.2-1b", reduced=True), dtype="float32")
    jp = jcommon.init_params(jax.random.PRNGKey(0), jtf.model_layout(jcfg))
    tp = convert.model_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, tcfg, jp, tp


def _prompts(b, s, seed=1):
    return np.random.default_rng(seed).integers(0, 512, (b, s)).astype(np.int32)


@pytest.mark.parametrize("b, s, n_new, capacity", [(2, 16, 8, 48), (1, 8, 4, 32)])
def test_generate_matches_jax_tokens(llama, b, s, n_new, capacity):
    jcfg, tcfg, jp, tp = llama
    prompts = _prompts(b, s)
    ref = JaxEngine(cfg=jcfg, params=jp, capacity=capacity, batch_size=b) \
        .generate(jnp.asarray(prompts), n_new)
    eng = ServeEngine(cfg=tcfg, params=tp, capacity=capacity, batch_size=b, device="cpu")
    out = eng.generate(torch.from_numpy(prompts), n_new)
    assert out.dtype == torch.int32 and out.shape == (b, n_new)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(eng.generate(torch.from_numpy(prompts), n_new).numpy(),
                                  out.numpy())   # deterministic


def test_generate_returns_exactly_n_new_tokens(llama):
    _, tcfg, _, tp = llama
    eng = ServeEngine(cfg=tcfg, params=tp, capacity=32, batch_size=2, device="cpu")
    prompts = torch.from_numpy(_prompts(2, 8))
    outs = {n: eng.generate(prompts, n) for n in (0, 1, 4)}
    for n, out in outs.items():
        assert out.shape == (2, n), n
    np.testing.assert_array_equal(outs[1].numpy(), outs[4][:, :1].numpy())
    with pytest.raises(ValueError, match="capacity"):
        eng.generate(prompts, 26)


def test_generate_matches_teacher_forced_forward(llama):
    """Cache == recompute: each generated token is the argmax of a full
    forward over the prompt and the tokens before it."""
    _, tcfg, _, tp = llama
    eng = ServeEngine(cfg=tcfg, params=tp, capacity=32, batch_size=1, device="cpu")
    prompts = torch.from_numpy(_prompts(1, 8, seed=4))
    gen = eng.generate(prompts, 4)
    logits, _, _ = ttf.forward(tp, tcfg, {"tokens": torch.cat([prompts, gen], dim=1)})
    np.testing.assert_array_equal(greedy_sample(logits[0, 7:11]).numpy(), gen[0].numpy())


def test_engine_bf16_copy_keeps_norms_float32(llama):
    """The default config serves in bf16: matmul weights are cast once,
    norm weights stay float32 for rms_norm."""
    _, _, _, tp = llama
    cfg = get_config("llama3.2-1b", reduced=True)
    eng = ServeEngine(cfg=cfg, params=tp, capacity=24, batch_size=2, device="cpu")
    layer = eng._params["slots"][0]
    assert layer["attn"]["wq"].dtype == torch.bfloat16
    assert eng._params["embed"].dtype == torch.bfloat16
    assert layer["ln1"].dtype == eng._params["final_norm"].dtype == torch.float32
    assert tp["slots"][0]["attn"]["wq"].dtype == torch.float32     # caller's tree intact
    out = eng.generate(torch.from_numpy(_prompts(2, 8)), 4)
    assert out.shape == (2, 4) and int(out.max()) < cfg.vocab_size


def _assert_summary(out, ref, msg):
    for f in dataclasses.fields(ref):
        a, b = getattr(ref, f.name), getattr(out, f.name)
        if f.name == "technique" or f.name in MISS_FIELDS:
            assert a == b, f"{msg}: {f.name}"
        elif np.isnan(a):
            assert np.isnan(b), f"{msg}: {f.name}"
        else:
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=1e-12, err_msg=f"{msg}: {f.name}")


TERMS = dict(t_compute=0.002, t_memory=0.012, t_collective=0.001)


@pytest.mark.parametrize("technique", TECHNIQUES)
def test_run_trace_matches_jax(technique):
    trace = twl.generate_trace(twl.WorkloadConfig(n_steps=512, seed=3))
    np.testing.assert_array_equal(
        trace, jwl.generate_trace(jwl.WorkloadConfig(n_steps=512, seed=3)))
    ref = jauto.DvfsServingSimulator(terms=jauto.RooflineTerms(**TERMS),
                                     technique=technique).run_trace(trace)
    sim = tauto.DvfsServingSimulator(terms=tauto.RooflineTerms(**TERMS),
                                     technique=technique, device="cpu")
    assert tauto.RooflineTerms(**TERMS).alpha_tpu == jauto.RooflineTerms(**TERMS).alpha_tpu
    _assert_summary(sim.run_trace(trace), ref, technique)


def test_compare_techniques_matches_jax():
    trace = twl.generate_trace(twl.WorkloadConfig(n_steps=512, seed=3))
    ref = jauto.compare_techniques(jauto.RooflineTerms(**TERMS), trace)
    out = tauto.compare_techniques(tauto.RooflineTerms(**TERMS), trace, device="cpu")
    assert list(out) == list(ref) == list(TECHNIQUES)
    for tech in TECHNIQUES:
        _assert_summary(out[tech], ref[tech], tech)


def test_simulate_and_summarize_with_failures_match_jax():
    """The single-platform loop under a usable-node schedule: per-step
    fields and the availability-priced Summary."""
    from repro.core import controller as jctl

    trace = twl.generate_trace(twl.WorkloadConfig(n_steps=256, seed=7))
    avail = np.full(256, 8.0, np.float32)
    avail[60:90], avail[150:160] = 5.0, 2.0
    for technique in ("proposed", "hybrid"):
        jplat = jctl.tpu_platform(**TERMS)
        jcfg = jctl.ControllerConfig(technique=technique, gated_power_frac=0.05)
        tplat = tctl.tpu_platform(**TERMS)
        tcfg = tctl.ControllerConfig(technique=technique, gated_power_frac=0.05)
        jres = jctl.simulate(jplat, jcfg, trace, avail=avail)
        tres = tctl.simulate(tplat, tcfg, trace, avail=avail, device="cpu")
        for f in ("predicted_bin", "n_active", "violations", "mispredictions"):
            np.testing.assert_array_equal(getattr(tres, f).numpy(),
                                          np.asarray(getattr(jres, f)), err_msg=f)
        np.testing.assert_allclose(tres.power.numpy(), np.asarray(jres.power),
                                   rtol=RTOL, atol=1e-6)
        _assert_summary(tctl.summarize(tplat, tcfg, trace, tres, avail=avail),
                        jctl.summarize(jplat, jcfg, trace, jres, avail=avail), technique)


def test_single_platform_tables_match_fleet_path():
    """``build_bin_tables`` is the fleet sweep on a one-platform fleet."""
    plat = tctl.tpu_platform(**TERMS)
    for technique in ("proposed", "hybrid", "power_gating"):
        cfg = tctl.ControllerConfig(technique=technique)
        one = tctl.build_bin_tables(plat, cfg, device="cpu")
        fleet = tctl.fleet_bin_tables(
            tchar.stack_platform_params([plat.params]), cfg, (technique,),
            device="cpu")
        for a, b in zip(one, fleet):
            assert torch.equal(a, b[0, 0])
    assert tctl.nominal_node_watts(plat) == pytest.approx(200.0, rel=1e-6)


def test_serve_main_runs_on_cpu(capsys):
    assert tserve.main(["--device", "cpu", "--new-tokens", "6", "--prompt-len", "10",
                        "--technique", "hybrid"]) == 0
    out = capsys.readouterr().out
    assert "generated (4, 6) tokens" in out
    assert "technique=hybrid power_gain=" in out
