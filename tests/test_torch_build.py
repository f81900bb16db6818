"""The port's kernel build names each library by a digest of what it is
built from: the source, the shared headers and the flags.  Hashing needs
no nvcc, so this runs anywhere."""

import shutil

from kubeflow_tpu_torch.ops import _build


def _copy_csrc(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    return csrc


def test_every_source_includes_a_header_the_digest_covers():
    headers = {p.name for p in _build.CSRC.glob("*.cuh")}
    assert "hopper.cuh" in headers
    for name in ("flash_fwd", "flash_bwd"):
        assert '#include "hopper.cuh"' in (
            _build.CSRC / f"{name}.cu").read_text()


def test_editing_a_header_or_a_source_changes_the_target(tmp_path,
                                                         monkeypatch):
    csrc = _copy_csrc(tmp_path, monkeypatch)
    before = {n: _build._target(n) for n in ("flash_fwd", "flash_bwd")}
    assert before == {n: _build._target(n) for n in before}  # stable
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build._target(n) for n in before}
    for name in before:
        assert after[name] != before[name], name
        assert after[name].name.startswith(f"lib{name}-")
    src = csrc / "flash_bwd.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert _build._target("flash_bwd") != after["flash_bwd"]
    assert _build._target("flash_fwd") == after["flash_fwd"]


def test_a_new_header_changes_the_target(tmp_path, monkeypatch):
    csrc = _copy_csrc(tmp_path, monkeypatch)
    before = _build._target("flash_fwd")
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert _build._target("flash_fwd") != before
