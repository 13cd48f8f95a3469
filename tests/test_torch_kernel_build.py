"""The kernels' build keys: a library is keyed by its source, every header
that source includes by a quoted path, and the flags, so an edit to a shared
header (``flash_attention/csrc/tensor_core.cuh``) rebuilds every library that
includes it and none that does not."""

import shutil

from repro_torch.kernels import _build

ATTENTION = ("flash_attention", "flash_attention_wgmma", "flash_attention_bwd",
             "flash_attention_bwd_wgmma", "flash_attention_wide", "flash_attention_wide_bwd")


def test_attention_sources_include_the_tensor_core_header():
    for name in ATTENTION:
        files = [p.name for p in _build.source_files(name)]
        assert files == [_build.SOURCES[name].rsplit("/", 1)[1], "tensor_core.cuh"], name
    for name in set(_build.SOURCES) - set(ATTENTION):
        assert len(_build.source_files(name)) == 1, name


def test_editing_an_included_header_changes_the_key(tmp_path, monkeypatch):
    kernels = tmp_path / "kernels"
    shutil.copytree(_build.KERNELS_DIR, kernels,
                    ignore=shutil.ignore_patterns(".build", "__pycache__", "*.py"))
    monkeypatch.setattr(_build, "KERNELS_DIR", kernels)
    before = {n: _build.library_path(n) for n in _build.SOURCES}
    header = kernels / "flash_attention" / "csrc" / "tensor_core.cuh"
    header.write_text(header.read_text() + "\n// an edit\n")
    after = {n: _build.library_path(n) for n in _build.SOURCES}
    for name in _build.SOURCES:
        assert (before[name] != after[name]) == (name in ATTENTION), name
    # the key is the content's: the edit taken back restores every key
    header.write_text(header.read_text().replace("\n// an edit\n", ""))
    assert {n: _build.library_path(n) for n in _build.SOURCES} == before


def test_a_header_included_twice_is_hashed_once(tmp_path, monkeypatch):
    kernels = tmp_path / "kernels"
    (kernels / "k" / "csrc").mkdir(parents=True)
    (kernels / "k" / "csrc" / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (kernels / "k" / "csrc" / "b.cuh").write_text('#pragma once\n#include "a.cuh"\n')
    (kernels / "k" / "csrc" / "k.cu").write_text('#include "a.cuh"\n#include "b.cuh"\n')
    monkeypatch.setattr(_build, "KERNELS_DIR", kernels)
    monkeypatch.setitem(_build.SOURCES, "k", "k/csrc/k.cu")
    assert [p.name for p in _build.source_files("k")] == ["k.cu", "a.cuh", "b.cuh"]
    _build.library_path("k")
