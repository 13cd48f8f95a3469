"""The port's trace-replay module against the JAX package's, on the CPU.

Both are numpy; every output must be bit-equal: resampling in all four
methods, the loaders and their round trips, replay and the seeded
builders, ``mix`` / ``splice`` compositions, and the bundled files.
"""

import os

import numpy as np
import pytest
import torch

from repro.core import traces as jtr
from repro_torch.core import traces as ttr


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as every new port test file pins (ROADMAP C)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _series(seed, n):
    return np.random.default_rng(seed).uniform(0.0, 1.0, n)


def test_bundled_files_found_in_the_same_directory():
    assert ttr.BUNDLED_DIR == jtr.BUNDLED_DIR
    assert os.path.isdir(ttr.BUNDLED_DIR)
    paths = ttr.list_bundled()
    assert set(paths) == {"azure_vm_cpu", "google_cluster"}
    assert paths == jtr.list_bundled()
    for name, src in ttr.bundled_sources().items():
        ref = jtr.load_bundled(name)
        np.testing.assert_array_equal(src.utilization, ref.utilization)
        assert (src.interval_s, src.provenance, src.name) == \
            (ref.interval_s, ref.provenance, ref.name)


@pytest.mark.parametrize("method", ttr.RESAMPLE_METHODS)
@pytest.mark.parametrize("src_s, dst_s, n", [(300.0, 60.0, 288), (150.0, 600.0, 576),
                                             (1.0, 1.0, 50), (45.0, 100.0, 97),
                                             (7.0, 3.0, 5)])
def test_resample_bit_equal(method, src_s, dst_s, n):
    w = _series(n, n)
    out = ttr.resample(w, src_s, dst_s, method)
    ref = jtr.resample(w, src_s, dst_s, method)
    assert out.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("mode", ["auto", "unit", "percent", "peak"])
def test_normalize_bit_equal(mode):
    for raw in (_series(1, 40), 100 * _series(2, 40), 400 * _series(3, 40)):
        np.testing.assert_array_equal(ttr._normalize(raw, mode), jtr._normalize(raw, mode))


def test_errors_match():
    for mod in (ttr, jtr):
        with pytest.raises(ValueError, match="unknown resample method"):
            mod.resample(np.ones(4), 1.0, 1.0, "median")
        with pytest.raises(ValueError, match="intervals must be positive"):
            mod.resample(np.ones(4), 0.0, 1.0)
        with pytest.raises(ValueError, match="unknown normalize mode"):
            mod._normalize(np.ones(4), "log")
        with pytest.raises(KeyError, match="no bundled trace"):
            mod.load_bundled("nope")
        with pytest.raises(ValueError, match="unsupported trace file"):
            mod.load("trace.parquet")
        with pytest.raises(ValueError, match="lacks 'workload_tau'"):
            mod.from_serving({})


def test_csv_and_npz_round_trips(tmp_path):
    ts = np.arange(30) * 60.0
    util = 100 * _series(4, 30)
    path = tmp_path / "trace.csv"
    np.savetxt(path, np.stack([ts, util], 1), delimiter=",",
               header="timestamp_s,cpu_pct", comments="")
    for kw in ({}, {"column": "cpu_pct", "normalize": "percent"},
               {"interval_s": 30.0, "name": "x"}):
        src, ref = ttr.load(str(path), **kw), jtr.load(str(path), **kw)
        np.testing.assert_array_equal(src.utilization, ref.utilization)
        assert (src.name, src.interval_s, src.provenance) == \
            (ref.name, ref.interval_s, ref.provenance)
        out = tmp_path / "rt.npz"
        ttr.save_npz(src, str(out))
        back, jback = ttr.load_npz(str(out), name=src.name), jtr.load_npz(str(out), name=src.name)
        np.testing.assert_array_equal(back.utilization, src.utilization)
        np.testing.assert_array_equal(back.utilization, jback.utilization)
        assert back.interval_s == src.interval_s == jback.interval_s
    bare = tmp_path / "bare.csv"
    np.savetxt(bare, util[:, None], delimiter=",", header="util", comments="")
    with pytest.raises(ValueError, match="pass interval_s"):
        ttr.load_csv(str(bare))


@pytest.mark.parametrize("tau", [None, 60.0, 900.0])
def test_replay_and_builders_bit_equal(tau):
    for name in ("azure_vm_cpu", "google_cluster"):
        src, ref = ttr.load_bundled(name), jtr.load_bundled(name)
        for n, off, loop in ((100, 0, True), (1000, 37, True), (700, 5, False)):
            np.testing.assert_array_equal(src.replay(n, tau, offset=off, loop=loop),
                                          ref.replay(n, tau, offset=off, loop=loop))
        for jitter in ("phase", "none"):
            for seed in (0, 1):
                a = src.builder(tau, jitter=jitter)(333, np.random.default_rng(seed))
                b = ref.builder(tau, jitter=jitter)(333, np.random.default_rng(seed))
                np.testing.assert_array_equal(a, b)


def _components(mod):
    """A replay, a scenario name and a raw builder, from one package."""
    az = mod.load_bundled("azure_vm_cpu")
    return [az, "flash_crowd", lambda n, rng: rng.uniform(0.0, 1.5, n)]


@pytest.mark.parametrize("seed", [0, 1])
def test_mix_and_splice_bit_equal(seed):
    tc, jc = _components(ttr), _components(jtr)
    for weights in (None, [0.6, 0.3, 0.1]):
        tm, jm = ttr.mix(tc, weights), jtr.mix(jc, weights)
        np.testing.assert_array_equal(tm.weights, jm.weights)
        for n in (64, 513):
            np.testing.assert_array_equal(tm(n, np.random.default_rng(seed)),
                                          jm(n, np.random.default_rng(seed)))
            np.testing.assert_array_equal(tm.components(n, np.random.default_rng(seed)),
                                          jm.components(n, np.random.default_rng(seed)))
    for fractions in (None, [0.75, 0.25, 0.0], [0.2, 0.5, 0.3]):
        ts, js = ttr.splice(tc, fractions), jtr.splice(jc, fractions)
        for n in (1, 64, 513):
            a = ts(n, np.random.default_rng(seed))
            np.testing.assert_array_equal(a, js(n, np.random.default_rng(seed)))
            assert a.shape == (n,)


def test_composition_errors_match():
    for mod in (ttr, jtr):
        with pytest.raises(ValueError, match="at least one component"):
            mod.mix([])
        with pytest.raises(ValueError, match="non-negative"):
            mod.splice(["burse", "ramp"], [1.0, -1.0])
        with pytest.raises(TypeError, match="workload component"):
            mod.as_trace_fn(3)


def test_from_serving_bit_equal():
    res = {"workload_tau": _series(5, 64) * 1.2}
    a, b = ttr.from_serving(res), jtr.from_serving(res)
    np.testing.assert_array_equal(a.utilization, b.utilization)
    assert (a.name, a.provenance, a.interval_s) == (b.name, b.provenance, b.interval_s)
