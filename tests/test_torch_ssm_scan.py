"""The port's ``selective_scan`` op against the JAX package, on the CPU.

On CPU tensors the op runs its plain version (``ref.py``); it is held
against the JAX oracle ``selective_scan_ref`` and against the Pallas
kernel itself, which ``repro.kernels.ssm_scan.ops.selective_scan`` runs in
interpret mode off the TPU, on the cases of ``tests/test_kernels_ssm.py``.
Tolerances are that file's: 1e-4 in fp32 (all sides compute in fp32 and
differ only in the order of the N-term dot product and in the rounding of
exp) and 3e-2 with bf16 inputs (one bf16 rounding of y).  The CUDA kernel
itself runs only on the card: ``chip_smoke.py`` phase 7 holds it against
the same plain version there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis", reason="property tests need hypothesis "
                    "(pip install -r requirements-dev.txt)")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.kernels.ssm_scan.ops import selective_scan as jax_selective_scan  # noqa: E402
from repro.kernels.ssm_scan.ref import selective_scan_ref as jax_scan_ref  # noqa: E402
from repro_torch.kernels.ssm_scan import selective_scan, selective_scan_ref  # noqa: E402
from repro_torch.kernels.ssm_scan import ops as scan_ops  # noqa: E402

CASES = [
    # b, S, D, N, chunk, block_d: tests/test_kernels_ssm.py's CASES
    (2, 128, 128, 16, 32, 64),
    (1, 64, 256, 8, 16, 128),
    (2, 128, 128, 16, 128, 128),
    (1, 256, 128, 4, 64, 128),
]
TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _inputs(b, S, D, N, seed=0):
    """delta, B, C, x, A_log as numpy float32, distributed as the JAX
    tests draw them (softplus(normal)·0.1 steps, A_log ~ 0.5·normal)."""
    rng = np.random.default_rng(seed)
    delta = np.logaddexp(rng.standard_normal((b, S, D)), 0.0) * 0.1
    B = rng.standard_normal((b, S, N))
    C = rng.standard_normal((b, S, N))
    x = rng.standard_normal((b, S, D))
    A_log = rng.standard_normal((D, N)) * 0.5
    return [a.astype(np.float32) for a in (delta, B, C, x, A_log)]


def _both(arrays, dtype):
    """The same values in both packages; delta, B, C, x rounded once to
    ``dtype``, A_log float32."""
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays[:4]]
    t.append(torch.from_numpy(arrays[4]))
    j = [jnp.asarray(x.float().numpy()).astype(dtype) for x in t[:4]]
    j.append(jnp.asarray(arrays[4]))
    return t, j


def _close(out, ref, dtype, msg):
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype], err_msg=msg)


@pytest.mark.parametrize("case", CASES)
def test_scan_matches_jax_ref_and_pallas_kernel(case):
    b, S, D, N, chunk, block_d = case
    (t, j) = _both(_inputs(b, S, D, N), "float32")
    y, h = selective_scan(*t)
    assert y.dtype == torch.float32 and y.shape == (b, S, D)
    assert h.dtype == torch.float32 and h.shape == (b, D, N)
    yr, hr = jax_scan_ref(*j)
    _close(y, yr, "float32", "y vs JAX ref")
    _close(h, hr, "float32", "h vs JAX ref")
    yk, hk = jax_selective_scan(*j, chunk=chunk, block_d=block_d)
    _close(y, yk, "float32", "y vs Pallas kernel")
    _close(h, hk, "float32", "h vs Pallas kernel")


def test_scan_bf16_inputs():
    t, j = _both(_inputs(1, 64, 128, 8), "bfloat16")
    y, h = selective_scan(*t)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    yr, hr = jax_scan_ref(*j)
    _close(y, yr, "bfloat16", "y vs JAX ref")
    _close(h, hr, "bfloat16", "h vs JAX ref")
    yk, _ = jax_selective_scan(*j, chunk=16, block_d=128)
    _close(y, yk, "bfloat16", "y vs Pallas kernel")


def test_ref_with_initial_state_matches_jax():
    arrays = _inputs(2, 48, 64, 8, seed=3)
    h0 = np.random.default_rng(4).standard_normal((2, 64, 8)).astype(np.float32)
    t, j = _both(arrays, "float32")
    y, h = selective_scan_ref(*t, h0=torch.from_numpy(h0))
    yr, hr = jax_scan_ref(*j, h0=jnp.asarray(h0))
    _close(y, yr, "float32", "y with h0")
    _close(h, hr, "float32", "h with h0")
    # the state hands over: two halves with h0 = the first half's state
    # give the whole scan
    y1, h1 = selective_scan_ref(*[a[:, :24] for a in t[:4]], t[4])
    y2, h2 = selective_scan_ref(*[a[:, 24:] for a in t[:4]], t[4], h0=h1)
    yw, hw = selective_scan_ref(*t)
    _close(torch.cat([y1, y2], dim=1), yw.numpy(), "float32", "split scan y")
    _close(h2, hw.numpy(), "float32", "split scan h")


@settings(max_examples=8, deadline=None)
@given(seed=st.integers(min_value=0, max_value=10_000))
def test_scan_property_random_seeds(seed):
    t, j = _both(_inputs(1, 64, 128, 8, seed=seed), "float32")
    y, h = selective_scan(*t)
    yr, hr = jax_scan_ref(*j)
    _close(y, yr, "float32", f"seed {seed}")
    _close(h, hr, "float32", f"seed {seed}")
    assert torch.isfinite(h).all()


def test_op_checks_raise_and_cpu_leaves_launches_at_zero():
    delta, B, C, x, A_log = map(torch.from_numpy, _inputs(2, 16, 24, 4))
    before = selective_scan.launches
    y, h = selective_scan(delta, B, C, x, A_log)
    assert selective_scan.launches == before == 0
    assert y.shape == (2, 16, 24) and h.shape == (2, 24, 4)
    with pytest.raises(ValueError, match="span devices"):
        selective_scan(delta, B.to("meta"), C, x, A_log)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        selective_scan(delta, B.bfloat16(), C, x, A_log)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        selective_scan(*(a.double() for a in (delta, B, C, x)), A_log)
    with pytest.raises(TypeError, match="float32 A_log"):
        selective_scan(delta, B, C, x, A_log.bfloat16())
    with pytest.raises(ValueError, match="b,S,D"):
        selective_scan(delta[0], B, C, x, A_log)
    with pytest.raises(ValueError, match="shapes"):
        selective_scan(delta, B, C, x[:, :8], A_log)
    with pytest.raises(ValueError, match="shapes"):
        selective_scan(delta, B, C[..., :3], x, A_log)
    with pytest.raises(ValueError, match="shapes"):
        selective_scan(delta, B, C, x, A_log[:8])
    with pytest.raises(ValueError, match="shapes"):
        selective_scan(delta[:, :0], B[:, :0], C[:, :0], x[:, :0], A_log)
    wide = torch.zeros(2, 16, scan_ops.MAX_STATE + 1)
    with pytest.raises(ValueError, match="N <= 16"):
        selective_scan(delta, wide, wide, x, torch.zeros(24, scan_ops.MAX_STATE + 1))
    assert scan_ops.MAX_STATE == 16
