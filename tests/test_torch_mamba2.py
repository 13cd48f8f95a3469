"""The port's Mamba-2 (SSD) block against the JAX package's, on the CPU.

``_ssd_matmul_scan`` rounds the Gram matrix C·Bᵀ, the decay-weighted M
and δ·x to bf16 and sums in fp32, as the reference does, also in a
float32 model.  On the same inputs both packages round the same operands
(C, B and δ·x are equal bit for bit), and only M's fp32 value differs by a
few ulps (the Gram sum's order, ``exp``); M rounds the other way only
where that value lies within those ulps of a bf16 rounding midpoint.  An
M entry ``M[b, h, t, τ]`` reaches ``y[b, t, h, :]`` alone, so the scan
test holds y at 1e-5 everywhere except at the (b, t, h) of such an edge
(found from a float64 recomputation), and the state, which M does not
reach, everywhere.

Through a whole block the projections that feed those operands differ by
ulps between the packages (XLA's and the port's fp32 matmuls sum in
other orders), so a rounding edge can fall anywhere; the float32 block
comparisons therefore take the SSD's bf16 roundings out of both
packages (``_ssd_in_fp32``) and hold everything else at 1e-5.  bf16
comparisons keep the roundings and run JAX op by op
(``jax.disable_jit()``), held to 2e-2 as ``tests/test_torch_ssm.py`` does;
a whole bf16 model is held block by block on JAX's inputs
(``BlockInputs``, as ``tests/test_torch_moe_models.py`` does), since a
free-running one moves by a bf16 ulp of the logits with each sum's order.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import ffn as jffn
from repro.models import ssm as jssm
from repro.models import transformer as jtf
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import ffn as tffn
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttf
from repro_torch.serving.engine import FP32_LEAVES, ServeEngine, _serving_copy

ARCH = "zamba2-2.7b"
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
EDGE_ULPS = 32   # fp32 ulps from a bf16 rounding midpoint that count as an edge


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as every new port test file pins (ROADMAP C)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Fp32Numpy:
    """``jax.numpy`` with ``bfloat16`` read as ``float32``."""

    def __getattr__(self, name):
        return jnp.float32 if name == "bfloat16" else getattr(jnp, name)


@contextlib.contextmanager
def _ssd_in_fp32():
    """The SSD's bf16 roundings out of both packages (see the module note)."""
    saved = jssm.jnp, tssm._bf16
    jssm.jnp, tssm._bf16 = _Fp32Numpy(), (lambda t: t)
    try:
        yield
    finally:
        jssm.jnp, tssm._bf16 = saved


class BlockInputs:
    """bf16: the Mamba, attention and FFN blocks of every layer, held one
    by one on JAX's input.  JAX's op-by-op run records each top-level block
    call's input and output; each of the port's calls that follow runs on
    JAX's input and hands JAX's output on, so the port's residual stream
    stays JAX's and its caches and head are its own; ``check`` holds every
    block's own input and output within 2e-2 of JAX's."""

    BLOCKS = {"mamba_apply": (jssm, tssm), "attention_apply": (jattn, tattn),
              "ffn_apply": (jffn, tffn)}

    def __init__(self, monkeypatch):
        self.jax, self.port = [], []
        for name, (jmod, tmod) in self.BLOCKS.items():
            monkeypatch.setattr(jmod, name, self._jax_spy(name, getattr(jmod, name)))
            monkeypatch.setattr(tmod, name, self._port_spy(name, getattr(tmod, name)))

    def _jax_spy(self, name, fn):
        def spy(params, x, cfg, **kw):
            out = fn(params, x, cfg, **kw)
            y = out[0] if isinstance(out, tuple) else out
            self.jax.append((name, np.asarray(x, np.float32), np.asarray(y, np.float32)))
            return out
        return spy

    def _port_spy(self, name, fn):
        def spy(params, x, cfg, **kw):
            want, x_in, y_ref = self.jax[len(self.port)]
            assert want == name, (want, name)
            out = fn(params, torch.from_numpy(x_in).to(x.dtype), cfg, **kw)
            y = out[0] if isinstance(out, tuple) else out
            self.port.append((name, x, y))
            y_ref = torch.from_numpy(y_ref).to(y.dtype)
            return (y_ref,) + tuple(out[1:]) if isinstance(out, tuple) else y_ref
        return spy

    def check(self, what):
        assert len(self.jax) == len(self.port) > 0
        for i, ((name, x_in, y_ref), (_, x, y)) in enumerate(zip(self.jax, self.port)):
            _close(x, x_in, "bfloat16", f"{what}: block {i} ({name}) input")
            _close(y, y_ref, "bfloat16", f"{what}: block {i} ({name}) output")
        names = [name for name, _, _ in self.jax]
        self.jax.clear()
        self.port.clear()
        return names


def _cfgs(dtype="float32"):
    return tuple(dataclasses.replace(f(ARCH, reduced=True), dtype=dtype)
                 for f in (jax_config, get_config))


def _layer(seed=0, dtype="float32"):
    """Layer 0's Mamba-2 block in both packages: (jcfg, tcfg, jax, port)."""
    jcfg, tcfg = _cfgs(dtype)
    jp = jcommon.init_params(jax.random.PRNGKey(seed), jtf.model_layout(jcfg))
    jl = jax.tree.map(lambda t: t[0], jp["slots"][0]["mamba"])
    return jcfg, tcfg, jl, {k: torch.from_numpy(np.array(v)) for k, v in jl.items()}


def _both(array, dtype):
    t = torch.from_numpy(array).to(getattr(torch, dtype))
    return t, jnp.asarray(t.float().numpy()).astype(dtype)


def _close(out, ref, dtype, msg=""):
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype], err_msg=msg)


def _scan_inputs(b, s, nh, p, n, seed):
    rng = np.random.default_rng(seed)
    delta = np.log1p(np.exp(rng.standard_normal((b, s, nh)) - 2.0)).astype(np.float32)
    return (delta, rng.standard_normal((b, s, n)).astype(np.float32),
            rng.standard_normal((b, s, n)).astype(np.float32),
            rng.standard_normal((b, s, nh, p)).astype(np.float32),
            (-np.exp(0.5 * rng.standard_normal(nh))).astype(np.float32))


def _bf16_edges(delta, Bm, Cm, A, chunk):
    """[B, S, nh] True where some M[b, h, t, τ] of the chunk holding t lies
    within EDGE_ULPS fp32 ulps of a bf16 rounding midpoint (float64)."""
    b, s, nh = delta.shape
    c = min(chunk, s)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16).double().numpy()  # noqa: E731
    out = np.zeros((b, s, nh), bool)
    for c0 in range(0, s, c):
        cum = np.cumsum(delta[:, c0:c0 + c].astype(np.float64) * A, axis=1)
        gram = np.einsum("btn,bsn->bts", bf(Cm[:, c0:c0 + c]), bf(Bm[:, c0:c0 + c]))
        decay = cum[:, :, None, :] - cum[:, None, :, :]
        M = gram[..., None] * np.exp(np.minimum(decay, 0.0)) * np.tril(np.ones((c, c)))[..., None]
        low = M.astype(np.float32).view(np.uint32) & 0xFFFF
        near = (np.abs(low.astype(np.int64) - 0x8000) <= EDGE_ULPS) & (M != 0)
        out[:, c0:c0 + c] = near.any(axis=2)
    return out


@pytest.mark.parametrize("s, chunk", [(64, 16), (16, 16), (48, 64)])
def test_ssd_matmul_scan_matches_jax(s, chunk):
    """S a multiple of the chunk (4 chunks), one chunk, and S below the
    chunk (``min(chunk, S)``); y and the final state on the same inputs."""
    ins = _scan_inputs(3, s, 8, 16, 8, seed=s)
    jy, jh = jssm._ssd_matmul_scan(*map(jnp.asarray, ins), chunk)
    ty, th = tssm._ssd_matmul_scan(*map(torch.from_numpy, ins), chunk)
    assert ty.dtype == th.dtype == torch.float32
    assert ty.shape == (3, s, 8, 16) and th.shape == (3, 8, 16, 8)
    _close(th, jh, "float32", "final state")
    edges = _bf16_edges(ins[0], ins[1], ins[2], ins[4], chunk)
    assert edges.mean() < 0.05, edges.mean()
    jy = np.asarray(jy)
    keep = ~edges
    np.testing.assert_allclose(ty.numpy()[keep], jy[keep], rtol=1e-5, atol=1e-5)
    # at an edge the port may round M the other way: one bf16 ulp of M a term
    np.testing.assert_allclose(ty.numpy()[edges], jy[edges], rtol=2e-2, atol=2e-2)


def test_ssd_rounds_as_the_reference():
    """Without its bf16 roundings the scan moves by far more than 1e-5 from
    the reference: the roundings are where the reference has them."""
    ins = _scan_inputs(2, 32, 4, 16, 8, seed=7)
    jy, _ = jssm._ssd_matmul_scan(*map(jnp.asarray, ins), 16)
    with _ssd_in_fp32():
        ty, _ = tssm._ssd_matmul_scan(*map(torch.from_numpy, ins), 16)
        jy32, _ = jssm._ssd_matmul_scan(*map(jnp.asarray, ins), 16)
    assert np.abs(ty.numpy() - np.asarray(jy)).max() > 1e-3
    _close(ty, jy32, "float32", "both without the roundings")


def test_ssd_keeps_the_chunk_contract():
    ins = _scan_inputs(1, 24, 2, 4, 4, seed=1)
    with pytest.raises(AssertionError):
        jssm._ssd_matmul_scan(*map(jnp.asarray, ins), 16)
    with pytest.raises(AssertionError):
        tssm._ssd_matmul_scan(*map(torch.from_numpy, ins), 16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_apply_prefill_state_and_decode(dtype):
    jcfg, tcfg, jl, tl = _layer(dtype=dtype)
    rng = np.random.default_rng(1)
    tx, jx = _both(rng.standard_normal((2, 32, 64)).astype(np.float32), dtype)
    mode = jax.disable_jit() if dtype == "bfloat16" else _ssd_in_fp32()
    with mode:
        jy, jc = jssm.mamba_apply(jl, jx, jcfg, return_state=True)
        ty, tc = tssm.mamba_apply(tl, tx, tcfg, return_state=True)
        nh, p = tcfg.ssm.n_heads(64), tcfg.ssm.head_dim
        assert ty.dtype == tx.dtype and tc["h"].dtype == torch.float32
        assert tc["h"].shape == (2, nh, p, tcfg.ssm.d_state) == jc["h"].shape
        assert tc["conv"].shape == (2, 3, 128) and tc["conv"].dtype == tx.dtype
        _close(ty, jy, dtype, "prefill y")
        _close(tc["h"], jc["h"], dtype, "prefill h")
        _close(tc["conv"], jc["conv"], dtype, "prefill conv tail")
        for step in range(3):
            txd, jxd = _both(rng.standard_normal((2, 1, 64)).astype(np.float32), dtype)
            h_before = tc["h"].clone()
            jy, jc = jssm.mamba_apply(jl, jxd, jcfg, cache=jc)
            ty, tc2 = tssm.mamba_apply(tl, txd, tcfg, cache=tc)
            assert tc2 is tc and not torch.equal(tc["h"], h_before)   # in place
            _close(ty, jy, dtype, f"decode {step} y")
            _close(tc["h"], jc["h"], dtype, f"decode {step} h")
            _close(tc["conv"], jc["conv"], dtype, f"decode {step} conv tail")


def test_skip_reads_no_D():
    """The reference's Mamba-2 skip adds xh itself; its layout's ``D`` leaf
    is read by neither package (ROADMAP C), so a D of 3 moves nothing."""
    jcfg, tcfg, jl, tl = _layer()
    x = np.random.default_rng(2).standard_normal((1, 16, 64)).astype(np.float32)
    y1, c1 = tssm.mamba_apply(tl, torch.from_numpy(x), tcfg, return_state=True)
    y3, c3 = tssm.mamba_apply(dict(tl, D=torch.full_like(tl["D"], 3.0)),
                              torch.from_numpy(x), tcfg, return_state=True)
    assert torch.equal(y1, y3) and torch.equal(c1["h"], c3["h"])
    j1, _ = jssm.mamba_apply(jl, jnp.asarray(x), jcfg)
    j3, _ = jssm.mamba_apply(dict(jl, D=jnp.full_like(jl["D"], 3.0)), jnp.asarray(x), jcfg)
    np.testing.assert_array_equal(np.asarray(j1), np.asarray(j3))
    d1, _ = tssm.mamba_apply(tl, torch.from_numpy(x[:, :1]), tcfg, cache=dict(c1))
    d3, _ = tssm.mamba_apply(dict(tl, D=torch.zeros_like(tl["D"])), torch.from_numpy(x[:, :1]),
                             tcfg, cache=dict(c3))
    assert torch.equal(d1, d3)


def test_engine_keeps_gate_norm_float32_and_matches_jax(monkeypatch):
    """The engine's bf16 serving copy keeps Mamba-2's ``gate_norm`` in
    float32, as the reference reads it (``rms_norm``'s float32 weight).
    With a ``gate_norm`` that bf16 cannot hold, the served block gives
    JAX's bf16 output bit for bit but for a few rounding edges, and the
    served model's prefill JAX's blocks and logits (``BlockInputs``); the
    same leaf rounded to bf16 moves a large share of the block's outputs
    by at least one bf16 ulp."""
    assert "gate_norm" in FP32_LEAVES
    jcfg, tcfg = _cfgs("bfloat16")
    jp = jcommon.init_params(jax.random.PRNGKey(4), jtf.model_layout(jcfg))
    g = 1.0 + 0.3 * np.random.default_rng(3).standard_normal(
        jp["slots"][0]["mamba"]["gate_norm"].shape).astype(np.float32)
    jp["slots"][0]["mamba"]["gate_norm"] = jnp.asarray(g)
    tp = convert.model_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    gate = tp["slots"][0]["mamba"]["gate_norm"]
    assert not torch.equal(gate.to(torch.bfloat16).float(), gate)        # not bf16-exact
    eng = ServeEngine(cfg=tcfg, params=tp, capacity=40, batch_size=2, device="cpu")
    served = eng._params["slots"][0]["mamba"]
    assert served["gate_norm"].dtype == torch.float32 and torch.equal(served["gate_norm"], gate)
    assert served["in_proj"].dtype == torch.bfloat16
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size, (2, 32)).astype(np.int32)
    with monkeypatch.context() as mp:
        blocks = BlockInputs(mp)
        with jax.disable_jit():
            jlog, _, _ = jtf.forward(jp, jcfg, {"tokens": jnp.asarray(toks)},
                                     return_state=True, cache_capacity=40, last_only=True)
        tlog, _ = eng._prefill(eng._params, {"tokens": torch.from_numpy(toks)})
        assert blocks.check("served prefill").count("mamba_apply") == tcfg.n_layers
    _close(tlog, np.asarray(jlog, np.float32)[:, -1], "bfloat16", "served logits")

    # one block on one bf16 input: share of outputs that differ from JAX's
    layer = lambda tree: {k: v[0] for k, v in tree.items()}  # noqa: E731
    tx, jx = _both(np.random.default_rng(6).standard_normal((2, 32, 64)).astype(np.float32),
                   "bfloat16")
    with jax.disable_jit():
        jy, _ = jssm.mamba_apply(jax.tree.map(lambda t: t[0], jp["slots"][0]["mamba"]), jx, jcfg)
    jy = torch.from_numpy(np.asarray(jy, np.float32))
    kept, _ = tssm.mamba_apply(layer(served), tx, tcfg)
    rounded, _ = tssm.mamba_apply(layer(dict(served, gate_norm=served["gate_norm"].to(
        torch.bfloat16))), tx, tcfg)
    differ = lambda y: (y.float() != jy).float().mean().item()  # noqa: E731
    assert differ(kept) < 0.02, differ(kept)
    assert differ(rounded) > 0.2, differ(rounded)
    assert tp["slots"][0]["mamba"]["in_proj"].dtype == torch.float32     # caller's tree intact


def test_serving_copy_keeps_every_fp32_leaf():
    _, tcfg = _cfgs("bfloat16")
    params = tcommon.tree_map(lambda d: torch.zeros(d.shape), ttf.model_layout(tcfg))
    served = _serving_copy(params, torch.bfloat16, torch.device("cpu"))
    mamba = served["slots"][0]["mamba"]
    assert {k for k, v in mamba.items() if v.dtype == torch.float32} == \
        {"A_log", "dt_bias", "D", "gate_norm"}
    assert served["shared"]["ln1"].dtype == torch.float32
    assert served["shared"]["attn"]["wq"].dtype == torch.bfloat16
