"""The kernel build helper (sed_crnn_torch/ops/kernels/_build.py) with a
stand-in for ``nvcc``, so that it is tested where no CUDA toolkit is
installed: libraries are named by a hash of their source, built once, and a
failing compile raises only after every started compile has been waited
for."""

import stat
import sys
import textwrap

import pytest

from sed_crnn_torch.ops.kernels import _build


def _fake_nvcc(tmp_path, fail_on: str = ""):
    script = tmp_path / "nvcc"
    script.write_text(textwrap.dedent(f"""\
        #!{sys.executable}
        import sys, pathlib
        args = sys.argv[1:]
        src, out = args[-1], args[args.index("-o") + 1]
        if {fail_on!r} and src.endswith({fail_on!r}):
            print("error in", src)
            sys.exit(3)
        pathlib.Path(out).write_text("built from " + src)
        print("ptxas info    : Used 10 registers")
        """))
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    return str(script)


@pytest.fixture
def build_dir(tmp_path, monkeypatch):
    d = tmp_path / "build"
    monkeypatch.setattr(_build, "BUILD_DIR", d)
    return d


def test_build_all_builds_each_source_once(tmp_path, build_dir, monkeypatch):
    nvcc = _fake_nvcc(tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: nvcc)
    _build.build_all()
    libs = sorted(p.name for p in build_dir.iterdir())
    assert len(libs) == len(_build.KERNEL_SOURCES)
    for name in _build.KERNEL_SOURCES:
        assert _build._library_path(name)[1].name in libs
        assert "registers" in _build.ptxas_reports[name]
    # already built: no compiler is started again
    monkeypatch.setattr(_build, "_nvcc", lambda: pytest.fail("nvcc started again"))
    _build.build_all()


def test_failed_compile_raises_after_waiting_for_all(tmp_path, build_dir, monkeypatch):
    nvcc = _fake_nvcc(tmp_path, fail_on="gru_wide.cu")
    monkeypatch.setattr(_build, "_nvcc", lambda: nvcc)
    with pytest.raises(RuntimeError, match="nvcc failed for gru_wide.cu"):
        _build.build_all()
    names = sorted(p.name for p in build_dir.iterdir())
    others = sorted(_build._library_path(n)[1].name for n in _build.KERNEL_SOURCES
                    if n != "gru_wide")
    assert names == others  # no temp files left


def test_every_kernel_source_is_listed():
    """The seven sources under csrc/ (the three log-mel bodies, the four GRU
    bodies) are exactly the ones `build_all` compiles; the log-mel bodies
    share one header."""
    on_disk = sorted(p.stem for p in _build.CSRC_DIR.glob("*.cu"))
    assert on_disk == sorted(_build.KERNEL_SOURCES)
    assert on_disk == ["gru_cluster", "gru_grid", "gru_warp", "gru_wide", "logmel_cluster",
                       "logmel_fft", "logmel_mixed"]
    assert sorted(p.name for p in _build.CSRC_DIR.glob("*.cuh")) == ["logmel_stages.cuh"]
    for name in ("logmel_cluster", "logmel_fft", "logmel_mixed"):
        assert '#include "logmel_stages.cuh"' in (_build.CSRC_DIR / f"{name}.cu").read_text()


def test_a_header_edit_renames_every_library(tmp_path, monkeypatch):
    """A library's name carries the hash of its source and of the headers
    beside it: editing a shared header rebuilds every source, editing one
    source only that one."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a", "b"):
        (csrc / f"{name}.cu").write_text(f'#include "h.cuh"\n// {name}\n')
    (csrc / "h.cuh").write_text("// header\n")
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    names = lambda: [_build._library_path(n)[1].name for n in ("a", "b")]  # noqa: E731
    first = names()
    (csrc / "a.cu").write_text('#include "h.cuh"\n// a, edited\n')
    second = names()
    assert second[0] != first[0] and second[1] == first[1]
    (csrc / "h.cuh").write_text("// header, edited\n")
    third = names()
    assert third[0] != second[0] and third[1] != second[1]
