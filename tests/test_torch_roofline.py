"""``repro_torch.analysis.roofline`` against ``repro.analysis.roofline``.

Under ``HW_V5E`` the port's report equals the JAX package's, field for
field and in ``as_dict``, for every registered arch and every shape of
``configs.SHAPES`` (model flops from each package's own config and
``active_params``), at 1 and 256 chips.  ``HW_H100`` holds the H100 SXM5's
datasheet figures, and the port's ``mfu`` reads the report's own hardware
(the JAX package's reads v5e's peak whatever the report's hardware;
ROADMAP C).
"""

import dataclasses

import pytest

from repro.analysis import roofline as jroof
from repro.configs import ARCH_NAMES as JARCHS
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jax_config
from repro_torch.analysis import roofline as troof
from repro_torch.configs import ARCH_NAMES, SHAPES, get_config


def test_shapes_and_hardware():
    assert sorted(ARCH_NAMES) == sorted(JARCHS)
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JSHAPES.items()}
    assert dataclasses.asdict(troof.HW_V5E) == dataclasses.asdict(jroof.HW_V5E)
    h = troof.HW_H100
    assert (h.peak_flops, h.hbm_bw, h.link_bw, h.hbm_bytes) == (989.4e12, 3.35e12, 450e9,
                                                                80 * 2**30)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_model_flops_and_report_match_jax(arch, shape):
    tcfg, jcfg = get_config(arch), jax_config(arch)
    assert tcfg.active_params() == jcfg.active_params()
    want_mf = jroof.model_flops_for(jcfg, JSHAPES[shape], jcfg.active_params())
    got_mf = troof.model_flops_for(tcfg, SHAPES[shape], tcfg.active_params())
    assert got_mf == want_mf
    for chips, flops, nbytes, coll in ((1, 3.1e15, 7.7e11, 0.0), (256, 4.4e14, 2.9e10, 6.1e9)):
        got = troof.roofline_terms(flops, nbytes, coll, got_mf, chips, troof.HW_V5E)
        want = jroof.roofline_terms(flops, nbytes, coll, want_mf, chips, jroof.HW_V5E)
        assert got.as_dict() == want.as_dict()
        assert (got.t_step, got.dominant, got.mfu) == (want.t_step, want.dominant, want.mfu)


def test_h100_report_reads_its_own_peak():
    r = troof.roofline_terms(989.4e12 * 0.5, 3.35e12 * 0.25, 0.0, 4 * 989.4e12 * 0.5, 4,
                             troof.HW_H100)
    assert r.t_compute == pytest.approx(0.5) and r.t_memory == pytest.approx(0.25)
    assert r.dominant == "compute" and r.mfu == pytest.approx(1.0)
    j = jroof.roofline_terms(989.4e12 * 0.5, 3.35e12 * 0.25, 0.0, 4 * 989.4e12 * 0.5, 4,
                             jroof.Hardware("h100", 989.4e12, 3.35e12, 450e9, 80 * 2**30))
    assert j.t_compute == r.t_compute and j.mfu == pytest.approx(989.4 / 197)
    assert troof.roofline_terms(0.0, 0.0, 0.0, 1.0, 1).mfu == 0.0
