"""The port's ``serving/kvcache.py`` against the JAX package's, on the CPU.

Sizes, dtypes and contents of a fresh cache, the split-KV rule, and the
padding of a prefill cache out to serving capacity (local layers' rings
and MLA's compressed latent cache included), with both packages' ``ValueError``s; then the property the
padding exists for: a short prefill padded to capacity decodes exactly as
a prefill built at capacity.  Models are REDUCED except for the sizes,
which are computed from layouts alone.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import common as jcommon
from repro.models import transformer as jtf
from repro.serving import kvcache as jkv
from repro_torch import convert
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.models import common as tcommon
from repro_torch.models import transformer as ttf
from repro_torch.serving import kvcache as tkv

SHORT, CAPACITY = 16, 40     # a prefill shorter than the REDUCED window of 32
# hubert-xlarge is encoder-only: no decode, so no prefill cache to pad (as the JAX
# package's tests/test_models_smoke.py leaves it out of its decode cases)
DECODING = [a for a in ARCH_NAMES if a != "hubert-xlarge"]


def _cfgs(arch, dtype="float32"):
    return (dataclasses.replace(jax_config(arch, reduced=True), dtype=dtype),
            dataclasses.replace(get_config(arch, reduced=True), dtype=dtype))


def _prefill(arch, capacity=None, seed=0):
    """Both packages' prefill caches of one REDUCED model on the same
    weights and tokens: (jcfg, tcfg, JAX cache, port cache, port params)."""
    jcfg, tcfg = _cfgs(arch)
    jp = jcommon.init_params(jax.random.PRNGKey(seed), jtf.model_layout(jcfg))
    tp = convert.model_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    toks = np.random.default_rng(seed).integers(0, 512, (2, SHORT)).astype(np.int32)
    _, jc, _ = jtf.forward(jp, jcfg, {"tokens": jnp.asarray(toks)}, return_state=True,
                           cache_capacity=capacity)
    _, tc, _ = ttf.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)}, return_state=True,
                           cache_capacity=capacity)
    return jcfg, tcfg, jc, tc, tp


def _leaves(tree):
    return dict(tcommon.tree_leaves(jax.tree.map(np.asarray, tree)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cache_dtype(dtype):
    jcfg, tcfg = _cfgs("gemma2-2b", dtype)
    assert tkv.cache_dtype(tcfg) == getattr(torch, dtype)
    assert str(tkv.cache_dtype(tcfg)).removeprefix("torch.") == jkv.cache_dtype(jcfg).name


@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_cache_bytes_matches_jax(arch, reduced):
    """From layouts alone, so full width costs nothing; the gemmas' local
    rings hold min(window, capacity) slots."""
    j, t = jax_config(arch, reduced), get_config(arch, reduced)
    for batch, capacity in ((2, 104), (1, 8192), (2, 8192)):
        assert tkv.cache_bytes(t, batch, capacity) == jkv.cache_bytes(j, batch, capacity)
    if arch == "gemma2-2b" and not reduced:
        # 13 local rings of 4096 slots and 13 global caches of 8192, k and v of
        # 4 heads × 256 in bf16, and the position tags
        per_slot = 2 * 2 * 4 * 256 * 2 + 2 * 2
        assert tkv.cache_bytes(t, 2, 8192) == 13 * (4096 + 8192) * per_slot
    if arch == "deepseek-v2-236b" and not reduced:
        # MLA: the latent (512) and the shared rope key (64) a slot, bf16, no
        # head axis and no position tags, in each of the 60 layers
        assert tkv.cache_bytes(t, 2, 8192) == 60 * 2 * 8192 * (512 + 64) * 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_init_cache_matches_jax(arch, dtype):
    """Zeros, position tags -1, every leaf in the cache dtype (the JAX
    package's ``pos`` too), on the device asked for."""
    jcfg, tcfg = _cfgs(arch, dtype)
    got = tkv.init_cache(tcfg, 2, CAPACITY, device="cpu")
    want = _leaves(jkv.init_cache(jcfg, 2, CAPACITY))
    leaves = dict(tcommon.tree_leaves(got))
    assert list(leaves) == list(want)
    for path, leaf in leaves.items():
        assert leaf.device.type == "cpu" and leaf.dtype == getattr(torch, dtype), path
        np.testing.assert_array_equal(leaf.float().numpy(), want[path].astype(np.float32),
                                      err_msg=path)
    assert sum(t.numel() * t.element_size() for t in leaves.values()) == \
        tkv.cache_bytes(tcfg, 2, CAPACITY)


def test_split_kv_needed_matches_jax():
    for arch in ARCH_NAMES:
        for reduced in (True, False):
            j, t = jax_config(arch, reduced), get_config(arch, reduced)
            for axis in (1, 2, 3, 4, 8, 16, 32):
                assert tkv.split_kv_needed(t, axis) == jkv.split_kv_needed(j, axis), \
                    (arch, reduced, axis)
    # an MLA cache (a latent with no head axis) always splits its sequence
    j, t = jax_config("gemma2-2b"), get_config("gemma2-2b")
    jm = dataclasses.replace(j, attention=dataclasses.replace(j.attention, kind="mla"))
    tm = dataclasses.replace(t, attention=dataclasses.replace(t.attention, kind="mla"))
    assert tkv.split_kv_needed(tm, 4) is jkv.split_kv_needed(jm, 4) is True
    assert tkv.split_kv_needed(get_config("falcon-mamba-7b"), 4) is False


@pytest.mark.parametrize("arch", DECODING)
def test_pad_prefill_cache_matches_jax(arch):
    """A prefill cache built at the prompt's length, padded on kv_seq to
    the layout at capacity: global k/v with zeros, ``pos`` with -1, local
    rings to min(window, capacity), the hybrid's ``shared`` caches as
    global ones; Mamba states (Mamba-2's ``[B, nh, p, n]`` too) have no
    kv_seq and stay."""
    jcfg, tcfg, jc, tc, _ = _prefill(arch)
    got = dict(tcommon.tree_leaves(tkv.pad_prefill_cache(tcfg, tc, CAPACITY)))
    want = _leaves(jkv.pad_prefill_cache(jcfg, jc, CAPACITY))
    layout = dict(tcommon.tree_leaves(ttf.cache_layout(tcfg, 2, CAPACITY)))
    before = dict(tcommon.tree_leaves(tc))
    assert list(got) == list(want) == list(layout)
    for path, leaf in got.items():
        assert tuple(leaf.shape) == want[path].shape == layout[path].shape, path
        assert leaf.dtype == before[path].dtype, path
        if path.endswith("pos"):
            np.testing.assert_array_equal(leaf.numpy(), want[path], err_msg=path)
        else:
            np.testing.assert_allclose(leaf.numpy(), want[path], rtol=1e-4, atol=1e-4,
                                       err_msg=path)


@pytest.mark.parametrize("arch", ["gemma2-2b", "gemma3-27b"])
def test_pad_prefill_cache_raises_as_jax_does(arch):
    jcfg, tcfg, jc, tc, _ = _prefill(arch)
    with pytest.raises(ValueError, match="exceeds capacity"):
        tkv.pad_prefill_cache(tcfg, tc, SHORT - 1)
    with pytest.raises(ValueError, match="exceeds capacity"):
        jkv.pad_prefill_cache(jcfg, jc, SHORT - 1)
    short = dict(tc, rem=tc["rem"] + [{"k": tc["slots"][0]["k"][0]}])
    jshort = dict(jc, rem=jc["rem"] + [{"k": jc["slots"][0]["k"][0]}])
    with pytest.raises(ValueError, match="not a .* decode cache"):
        tkv.pad_prefill_cache(tcfg, short, CAPACITY)
    with pytest.raises(ValueError, match="not a .* decode cache"):
        jkv.pad_prefill_cache(jcfg, jshort, CAPACITY)
    empty = {"prefix": [], "slots": [], "rem": []}
    assert tkv.pad_prefill_cache(tcfg, empty, CAPACITY) is empty
    same = tkv.pad_prefill_cache(tcfg, tc, SHORT)     # at its own length: values kept
    for (p, a), (_, b) in zip(tcommon.tree_leaves(same), tcommon.tree_leaves(tc)):
        assert torch.equal(a, b), p


@pytest.mark.parametrize("arch", ["gemma2-2b", "gemma3-27b", "llama3.2-1b",
                                  "qwen3-moe-235b-a22b", "deepseek-v2-236b", "zamba2-2.7b",
                                  "internvl2-1b"])
def test_padded_short_prefill_decodes_like_a_cache_built_at_capacity(arch):
    """Decode logits are equal, step for step, past the 32-slot rings' wrap
    (MLA's compressed cache padded with zeros, no position tags; the
    hybrid's shared-block caches padded as global layers')."""
    _, tcfg, _, short, tp = _prefill(arch)
    _, _, _, full, _ = _prefill(arch, capacity=CAPACITY)
    padded = tkv.pad_prefill_cache(tcfg, short, CAPACITY)
    tok = torch.full((2, 1), 7, dtype=torch.int32)
    for step in range(CAPACITY - SHORT):
        pos = torch.full((2,), SHORT + step, dtype=torch.int32)
        a, padded, _ = ttf.forward(tp, tcfg, {"tokens": tok}, cache=padded, cache_pos=pos)
        b, full, _ = ttf.forward(tp, tcfg, {"tokens": tok}, cache=full, cache_pos=pos)
        assert torch.equal(a, b), step
        tok = a[:, -1].argmax(-1).to(torch.int32)[:, None]
