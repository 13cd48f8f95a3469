"""The port's synthetic data pipeline against ``repro.data.pipeline``:
batches bit-equal for the same seed, for the token, VLM and audio
families, through the prefetch thread."""

import numpy as np
import pytest

from repro.configs import get_config as jax_config
from repro.data import pipeline as jpipe
from repro_torch.configs import get_config
from repro_torch.data import pipeline as tpipe


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "internvl2-1b", "hubert-xlarge"])
def test_batches_bit_equal(arch, seed):
    kw = dict(global_batch=3, seq_len=40, vocab_size=get_config(arch, True).vocab_size,
              seed=seed)
    t = tpipe.SyntheticPipeline(tpipe.DataConfig(**kw), get_config(arch, True))
    j = jpipe.SyntheticPipeline(jpipe.DataConfig(**kw), jax_config(arch, True))
    try:
        for _ in range(3):
            a, b = next(t), next(j)
            assert sorted(a) == sorted(b)
            for key in a:
                assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    finally:
        t.close()
        j.close()
    if arch == "internvl2-1b":
        assert a["patches"].shape[1] == get_config(arch, True).frontend_len
    if arch == "hubert-xlarge":
        assert "tokens" not in a and a["features"].shape[:2] == (3, 40)


def test_sample_deterministic_and_learnable():
    cfg = tpipe.DataConfig(global_batch=4, seq_len=32, vocab_size=97, seed=5)
    a = tpipe._sample(np.random.default_rng(5), cfg)
    b = jpipe._sample(np.random.default_rng(5), jpipe.DataConfig(4, 32, 97, 5))
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    np.testing.assert_array_equal(a["labels"], b["labels"])
    pred = (31 * a["tokens"] + 17) % 97
    assert (pred == a["labels"]).mean() > 0.85


def test_close_stops_the_thread():
    pipe = tpipe.SyntheticPipeline(tpipe.DataConfig(global_batch=2, seq_len=8,
                                                    vocab_size=50, prefetch=1))
    next(pipe)
    pipe.close()
    pipe._thread.join(timeout=5)
    assert not pipe._thread.is_alive()
