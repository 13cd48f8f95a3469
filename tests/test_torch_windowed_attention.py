"""The port's ``windowed_attention`` against the JAX package's, and against
the port's own flash op with the same band, on the CPU.

``windowed_attention`` is the model zoo's banded form of causal
sliding-window attention: query chunks of ``q_chunk`` rows each attend to
``min(window + q_chunk, S)`` keys.  Inputs come from numpy seeds and are
rounded once to the dtype in both packages.  Against the JAX function:
2e-5 in float32 (the same fp32 scores and softmax, sums in other orders)
and 2e-2 in bf16 (one rounding of p to bf16 and of the output).  Against
``flash_attention(causal=True, window=w)``, the same function computed
tile by tile: 2e-5 in float32; 2e-2 in bf16, where the flash op keeps p
in fp32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import windowed_attention as jax_windowed
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.attention import windowed_attention

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
CASES = [
    # B, S, H, D, window, q_chunk, softcap
    (2, 128, 4, 16, 32, 32, None),        # window < S, four chunks
    (1, 256, 2, 32, 100, 64, 50.0),       # a window no multiple of the chunk, softcap
    (1, 96, 4, 16, 96, 32, None),         # window == S
    (1, 64, 2, 16, 200, 64, 30.0),        # window > S, one chunk
    (2, 192, 2, 16, 1, 32, None),         # each token sees only itself
    (1, 160, 2, 64, 48, 1024, 50.0),      # q_chunk > S: one chunk of S rows
]


def _inputs(b, s, h, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d), np.float32) for _ in range(3)]


def _both(arrays, dtype):
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return t, [jnp.asarray(x.float().numpy()).astype(dtype) for x in t]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_windowed_attention_matches_jax(case, dtype):
    b, s, h, d, window, q_chunk, cap = case
    (q, k, v), (jq, jk, jv) = _both(_inputs(b, s, h, d), dtype)
    scale = 1.0 / np.sqrt(d)
    out = windowed_attention(q, k, v, window=window, scale=scale, cap=cap, q_chunk=q_chunk)
    ref = jax_windowed(jq, jk, jv, window=window, scale=scale, cap=cap, q_chunk=q_chunk)
    assert out.dtype == q.dtype and out.shape == q.shape
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_windowed_attention_equals_the_flash_band(case, dtype):
    """The two banded forms of one function: whole query chunks against a
    clipped key band, and the flash op's tiles with ``window``."""
    b, s, h, d, window, q_chunk, cap = case
    (q, k, v), _ = _both(_inputs(b, s, h, d, seed=1), dtype)
    scale = 1.0 / np.sqrt(d)
    out = windowed_attention(q, k, v, window=window, scale=scale, cap=cap, q_chunk=q_chunk)
    flash = flash_attention(q, k, v, causal=True, window=window, softcap=cap, scale=scale)
    np.testing.assert_allclose(out.float().numpy(), flash.float().numpy(),
                               rtol=TOL[dtype], atol=TOL[dtype])


def test_first_row_is_v0_and_a_window_of_one_is_v():
    q, k, v = map(torch.from_numpy, _inputs(1, 64, 2, 16, seed=2))
    out = windowed_attention(q, k, v, window=8, scale=0.25, q_chunk=16)
    np.testing.assert_allclose(out[:, 0].numpy(), v[:, 0].numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(windowed_attention(q, k, v, window=1, scale=0.25,
                                                  q_chunk=16).numpy(), v.numpy(),
                               rtol=1e-6, atol=1e-6)


def test_q_chunk_must_tile_the_sequence():
    q, k, v = map(torch.from_numpy, _inputs(1, 96, 2, 16))
    with pytest.raises(ValueError, match="multiple of q_chunk"):
        windowed_attention(q, k, v, window=16, scale=0.25, q_chunk=64)
