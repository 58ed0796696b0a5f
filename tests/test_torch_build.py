"""kernels/build.py of the PyTorch port without a compiler: when a library
counts as stale, with the compiler call and the loader stubbed out."""

import os

import pytest

from ray_tracing_tpu_torch.kernels import build


@pytest.fixture
def tree(tmp_path, monkeypatch):
    """A csrc/ with two sources that share a header, an empty build/, and
    a compiler stub that writes the library and counts its calls."""
    csrc, out = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    for name in ("megakernel_fwd.cu", "megakernel_bwd.cu", "rt_device.cuh"):
        (csrc / name).write_text("// " + name)
    built, loaded = [], []

    def fake_build(name, verbose=False):
        out.mkdir(exist_ok=True)
        (out / f"lib{name}.so").write_text("library")
        built.append(name)

    monkeypatch.setattr(build, "CSRC_DIR", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", out)
    monkeypatch.setattr(build, "build_library", fake_build)
    monkeypatch.setattr(build, "_libraries", {})
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: loaded.append(path) or object())
    return csrc, out, built, loaded


def _age(path, seconds):
    st = path.stat()
    os.utime(path, (st.st_atime, st.st_mtime + seconds))


def test_library_is_built_once_then_reused(tree):
    csrc, out, built, loaded = tree
    assert build.is_stale("megakernel_fwd")
    lib = build.load_library("megakernel_fwd")
    assert built == ["megakernel_fwd"] and loaded == [str(out / "libmegakernel_fwd.so")]
    assert build.load_library("megakernel_fwd") is lib and built == ["megakernel_fwd"]
    # a fresh process finds the library on disk and newer than its inputs
    build._libraries.clear()
    _age(out / "libmegakernel_fwd.so", 10)
    assert not build.is_stale("megakernel_fwd")
    build.load_library("megakernel_fwd")
    assert built == ["megakernel_fwd"]


@pytest.mark.parametrize("touched", ["megakernel_bwd.cu", "rt_device.cuh"])
def test_a_newer_source_or_header_makes_the_library_stale(tree, touched):
    csrc, out, built, _ = tree
    for name in ("megakernel_fwd", "megakernel_bwd"):
        build.load_library(name)
        _age(out / f"lib{name}.so", 10)
    build._libraries.clear()
    assert built == ["megakernel_fwd", "megakernel_bwd"]
    _age(csrc / touched, 20)
    # the header is shared: both libraries are stale; a source only its own
    assert build.is_stale("megakernel_bwd")
    assert build.is_stale("megakernel_fwd") == touched.endswith(".cuh")
    build.load_library("megakernel_fwd")
    build.load_library("megakernel_bwd")
    want = ["megakernel_fwd", "megakernel_bwd"] if touched.endswith(".cuh") else ["megakernel_bwd"]
    assert built[2:] == want


def test_the_shipped_sources_include_the_shared_header():
    """The header lies beside the sources, where the quoted include finds
    it, and the package data of an installed copy lists it."""
    real = build.CSRC_DIR
    assert (real / "rt_device.cuh").is_file()
    assert (real / "rt_backward.cuh").is_file()
    for name in ("megakernel_fwd", "megakernel_bwd", "megakernel_bwd_retrace"):
        assert '#include "rt_device.cuh"' in (real / f"{name}.cu").read_text()
    for name in ("megakernel_bwd", "megakernel_bwd_retrace"):
        assert '#include "rt_backward.cuh"' in (real / f"{name}.cu").read_text()
    pyproject = real.parents[2] / "pyproject.toml"
    assert '"kernels/csrc/*.cuh"' in pyproject.read_text()
