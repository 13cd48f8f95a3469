"""The data pipeline gives the same batches however slowly they are taken.

Phase 18g's falcon-mamba-7b losses differed from machine to machine
(ROADMAP C), and on one card phase 20b's llama losses left phase 18b's
at step 4.  The training step itself is bit-stable on the card
(``scripts/falcon_determinism.py``: gradients and 8 steps twice, equal,
on batches drawn beforehand).  The batches were not: the prefetch
thread, which the port copied from ``repro.data.pipeline``, dropped the
batch it held whenever the full queue did not take it within 0.5 s and
drew the next one, so a step slower than that (falcon's and llama's take
~0.48 s on the card) skipped batches depending on the host.  The port's
worker now offers the same batch again.  The CPU shows it with a
consumer that pauses longer than the wait.
"""

import time

import numpy as np
import pytest

from repro.data import pipeline as jpipe
from repro_torch.data import pipeline as tpipe

CFG = dict(global_batch=2, seq_len=8, vocab_size=50, prefetch=1)
PAUSE_S = 1.6            # over three of the worker's 0.5 s waits


def _drawn(n):
    """The first ``n`` batches of the seeded generator, drawn in order."""
    rng = np.random.default_rng(0)
    cfg = tpipe.DataConfig(**CFG)
    return [tpipe._sample(rng, cfg) for _ in range(n)]


def _taken(module, n, pause):
    pipe = module.SyntheticPipeline(module.DataConfig(**CFG))
    out = [next(pipe)]
    for _ in range(n - 1):
        time.sleep(pause)
        out.append(next(pipe))
    pipe.close()
    return out


def _equal(a, b):
    return all(x.keys() == y.keys() and all(np.array_equal(x[k], y[k]) for k in x)
               for x, y in zip(a, b))


@pytest.mark.parametrize("pause", [0.0, PAUSE_S])
def test_the_ports_pipeline_drops_no_batch(pause):
    assert _equal(_taken(tpipe, 4, pause), _drawn(4))


def test_the_reference_pipeline_skips_batches_behind_a_slow_consumer():
    """A reference fault (ROADMAP C), recorded here and not repaired in
    ``src/repro``: its fourth batch is not the generator's fourth."""
    taken = _taken(jpipe, 4, PAUSE_S)
    drawn = _drawn(12)
    assert _equal(taken[:2], drawn[:2])
    assert not _equal(taken[3:4], drawn[3:4])
