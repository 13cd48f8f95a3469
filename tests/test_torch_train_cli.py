"""``launch.train`` and llama3-405b in the port, on the CPU.

* ``launch.train.main --device cpu`` REDUCED prints the lines of
  ``repro.launch.train``, whose format strings are read from its source
  (its ``main`` itself stops in a sharding constraint that the installed
  jax refuses on its host mesh, a fault of the reference), resumes from ``--ckpt-dir``, trains
  falcon-mamba-7b through the scan's autograd Function (its plain
  backward on the CPU; ``chip_smoke.py`` phase 18 trains it on the card
  through the backward kernel), and refuses a training state larger than
  the device before drawing weights (``--full`` llama3-405b);
* llama3-405b's config, layout and ``count_params`` equal JAX's, and its
  REDUCED forward, decode and ``generate`` tokens equal JAX's in float32
  (logits within 1e-4, as ``test_torch_models.py`` holds llama3.2-1b);
* the elastic-training example twin prints the JAX example's lines.
"""

import dataclasses
import re
import runpy
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import get_config as jax_config
from repro.launch import train as jtrain
from repro.models import common as jcommon
from repro.models import transformer as jtf
from repro.serving.engine import ServeEngine as JaxEngine
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.configs import get_config
from repro_torch.launch import train as ttrain
from repro_torch.models import common as tcommon
from repro_torch.models import transformer as ttf
from repro_torch.serving.engine import ServeEngine

torch.set_num_threads(1)

ARGS = ["--steps", "40", "--batch", "4", "--seq", "32", "--lr", "3e-3", "--log-every", "10"]
STEP_LINE = r"step +\d+ loss=\d+\.\d{4} grad_norm=\d+\.\d{3} \d+ ms/step"
LAST_LINE = r"loss \d+\.\d{4} → \d+\.\d{4} \((improved|NOT improved)\)"


def _lines(text):
    return [ln for ln in text.splitlines() if ln.strip()]


def test_train_main_prints_the_reference_lines(capsys):
    src = open(jtrain.__file__).read()
    for fmt in ('f"step {i+1:5d} loss={losses[-1]:.4f} "',
                'f"grad_norm={float(metrics[\'grad_norm\']):.3f} "',
                'f"{dt*1e3:.0f} ms/step"', 'f"loss {first:.4f} → {last:.4f} "',
                "f\"({'improved' if last < first else 'NOT improved'})\"",
                'f"restored checkpoint at step {start}"'):
        assert fmt in src, fmt
    assert ttrain.main(ARGS + ["--device", "cpu"]) == 0
    out = _lines(capsys.readouterr().out)
    assert len(out) == 5
    for i, line in enumerate(out[:4]):
        assert re.fullmatch(STEP_LINE, line) and line.split()[1] == str(10 * (i + 1)), line
    assert re.fullmatch(LAST_LINE, out[-1]) and out[-1].endswith("(improved)")


def test_train_main_resumes_from_ckpt_dir(capsys, tmp_path):
    args = ["--device", "cpu", "--batch", "2", "--seq", "16", "--log-every", "2",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "3"]
    ttrain.main(args + ["--steps", "6"])
    capsys.readouterr()
    ttrain.main(args + ["--steps", "8"])
    out = _lines(capsys.readouterr().out)
    assert out[0] == "restored checkpoint at step 6"
    assert re.fullmatch(STEP_LINE, out[1]) and out[1].split()[1] == "8"


def test_falcon_mamba_trains_on_cpu_through_the_plain_scan(capsys):
    assert ttrain.main(["--arch", "falcon-mamba-7b", "--device", "cpu", "--steps", "2",
                        "--batch", "2", "--seq", "16", "--log-every", "1"]) == 0
    out = _lines(capsys.readouterr().out)
    assert len(out) == 3 and re.fullmatch(LAST_LINE, out[-1])


def test_full_falcon_mamba_is_refused_on_one_80gb_card_by_its_state(monkeypatch):
    """No family is refused on the card any more; full falcon-mamba-7b's
    float32 state (count_params × 16 bytes, 112 GB) exceeds one 80 GB card."""
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(total_memory=80 * 10**9))
    why = ttrain.refusal(get_config("falcon-mamba-7b"), torch.device("cuda"))
    assert "7,003,176,960 parameters, 112.1 GB" in why and "does not fit" in why
    assert ttrain.refusal(get_config("falcon-mamba-7b", True), torch.device("cuda")) is None


def test_full_llama3_405b_is_refused_before_drawing_weights(monkeypatch):
    drawn = []
    monkeypatch.setattr(tcommon, "init_params", lambda *a, **k: drawn.append(1))
    with pytest.raises(SystemExit, match="does not fit one cpu device"):
        ttrain.main(["--arch", "llama3-405b", "--full", "--device", "cpu"])
    assert not drawn
    cfg = get_config("llama3-405b")
    assert cfg.moment_dtype == "bfloat16" and cfg.fsdp
    assert ttrain.train_state_bytes(cfg) == tbase.count_params(cfg) * 12
    assert ttrain.refusal(get_config("llama3.2-1b"), torch.device("cpu")) is None


@pytest.mark.parametrize("reduced", [False, True])
def test_llama3_405b_config_and_layout_match_jax(reduced):
    j, t = jax_config("llama3-405b", reduced), get_config("llama3-405b", reduced)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert tbase.count_params(t) == jbase.count_params(j)
    jl = dict(tcommon.tree_leaves(jtf.model_layout(j)))
    tl = dict(tcommon.tree_leaves(ttf.model_layout(t)))
    assert list(jl) == list(tl)
    for path, d in jl.items():
        assert (tl[path].shape, tl[path].axes, tl[path].init) == (d.shape, d.axes, d.init)
        assert tl[path].scale == pytest.approx(d.scale, rel=1e-12), path
    if not reduced:
        assert t.n_layers == 126 and t.d_model == 16384 and t.d_ff == 53248
        assert (t.attention.n_heads, t.attention.n_kv_heads, t.attention.head_dim) == \
            (128, 8, 128)
        assert "lm_head" in tl and tl["embed"].shape == (t.padded_vocab, 16384)


@pytest.fixture(scope="module")
def llama405():
    jcfg = dataclasses.replace(jax_config("llama3-405b", True), dtype="float32")
    tcfg = dataclasses.replace(get_config("llama3-405b", True), dtype="float32")
    jp = jcommon.init_params(jax.random.PRNGKey(0), jtf.model_layout(jcfg))
    return jcfg, tcfg, jp, convert.model_params_from_numpy(jax.tree.map(np.asarray, jp),
                                                           tcfg, "cpu")


def test_llama3_405b_forward_and_decode_match_jax(llama405):
    jcfg, tcfg, jp, tp = llama405
    tok = np.random.default_rng(0).integers(0, tcfg.vocab_size, (2, 24)).astype(np.int32)
    jl, jc, _ = jtf.forward(jp, jcfg, {"tokens": jnp.asarray(tok)}, return_state=True,
                            cache_capacity=28)
    tl, tc, _ = ttf.forward(tp, tcfg, {"tokens": torch.from_numpy(tok)}, return_state=True,
                            cache_capacity=28)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    for step in range(3):
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
        pos = np.full((2,), 24 + step, np.int32)
        jl, jc, _ = jtf.forward(jp, jcfg, {"tokens": jnp.asarray(nxt)}, cache=jc,
                                cache_pos=jnp.asarray(pos))
        tl, tc, _ = ttf.forward(tp, tcfg, {"tokens": torch.from_numpy(nxt)}, cache=tc,
                                cache_pos=torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4,
                                   err_msg=f"decode step {step}")


def test_llama3_405b_generate_matches_jax_tokens(llama405):
    jcfg, tcfg, jp, tp = llama405
    prompts = np.random.default_rng(1).integers(0, tcfg.vocab_size, (2, 12)).astype(np.int32)
    want = JaxEngine(cfg=jcfg, params=jp, capacity=20, batch_size=2) \
        .generate(jnp.asarray(prompts), 6)
    got = ServeEngine(cfg=tcfg, params=tp, capacity=20, batch_size=2, device="cpu") \
        .generate(torch.from_numpy(prompts), 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_elastic_training_twin_prints_the_reference_lines(capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["elastic_training_torch.py", "--device", "cpu"])
    with pytest.raises(SystemExit) as e:
        runpy.run_path("examples/elastic_training_torch.py", run_name="__main__")
    assert e.value.code == 0
    out = _lines(capsys.readouterr().out)
    assert out[0] == "[fault] completed 60 steps with 2 node failures + restarts"
    assert re.fullmatch(r"\[fault\] loss \d+\.\d{3} → \d+\.\d{3}", out[1])
    first, last = map(float, re.findall(r"\d+\.\d{3}", out[1]))
    assert last < first
    # the straggler half is numpy only: the reference example's exact lines
    assert out[2:] == [
        "[straggler] batch shares after degradation: [np.int64(8), np.int64(8), "
        "np.int64(8), np.int64(8), np.int64(10), np.int64(6), np.int64(8), np.int64(8)] "
        "(node 5 gets 6)",
        "[straggler] evictions flagged: []"]
