"""The kernel loader (``graphblas_tpu_torch/kernels/_cuda.py``) when
several threads of one process first call a kernel together, as the
threads of ``examples/context_demo`` do, each under its own Context.

No compiler or card is needed: ``_nvcc`` is a small script that sleeps
and then writes its ``-o`` file (logging each build), ``SOURCES`` and
``BUILD_DIR`` point into ``tmp_path``, and ``ctypes.CDLL`` loads a
stand-in.  Each library must be built once, every thread must get the
same loaded library, and no temporary file may be left."""

import os
import stat
import sys
import threading

import pytest

from graphblas_tpu_torch.kernels import _cuda

FAKE_NVCC = """#!/bin/sh
out=""
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; shift; fi
  src="$1"
  shift
done
echo "$src" >> "{log}"
sleep 0.3
printf built > "$out"
"""


class _FakeLib:
    """A loaded library's stand-in: any attribute can be bound."""

    def __init__(self, path):
        self.path = path

    def __getattr__(self, name):
        fn = type("Fn", (), {})()
        object.__setattr__(self, name, fn)
        return fn


@pytest.fixture
def fake_build(tmp_path, monkeypatch):
    log = tmp_path / "builds.log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(log=log))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    src = tmp_path / "src"
    src.mkdir()
    sources = {}
    for name in ("spmv", "sortreduce", "permute"):
        sources[name] = src / f"{name}.cu"
        sources[name].write_text(f"// {name}\n")
    build_dir = tmp_path / "build"
    monkeypatch.setattr(_cuda, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_cuda, "SOURCES", sources)
    monkeypatch.setattr(_cuda, "BUILD_DIR", build_dir)
    monkeypatch.setattr(_cuda, "_libs", {})
    monkeypatch.setattr(_cuda.ctypes, "CDLL", _FakeLib)
    return log, build_dir


def _together(fn, n=4):
    """Run ``fn(i)`` in n threads released at once, switching threads
    every microsecond; (results, errors)."""
    start = threading.Barrier(n)
    results, errors = [None] * n, []

    def run(i):
        start.wait()
        try:
            results[i] = fn(i)
        except Exception as exc:      # noqa: BLE001 - reported below
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    return results, errors


def _builds(log):
    return sorted(os.path.basename(line) for line in
                  log.read_text().split()) if log.exists() else []


@pytest.mark.parametrize("entry", ["lib", "build"])
def test_threads_build_each_library_once(fake_build, entry):
    log, build_dir = fake_build
    if entry == "lib":
        results, errors = _together(lambda i: _cuda.lib("spmv"))
        assert not errors, errors
        assert all(r is results[0] for r in results)
        assert isinstance(results[0], _FakeLib)
        assert _builds(log) == ["spmv.cu"]
    else:
        results, errors = _together(lambda i: _cuda.build())
        assert not errors, errors
        assert all(r == results[0] for r in results)
        assert _builds(log) == ["permute.cu", "sortreduce.cu", "spmv.cu"]
    assert not list(build_dir.glob("*.tmp"))
    for path in build_dir.glob("*.so"):
        assert path.read_text() == "built"


def test_threads_load_different_libraries(fake_build):
    """Threads asking for different libraries at once: each built and
    loaded once, and each thread gets its own."""
    log, build_dir = fake_build
    names = ["spmv", "sortreduce", "permute", "spmv"]
    results, errors = _together(lambda i: _cuda.lib(names[i]))
    assert not errors, errors
    assert results[0] is results[3]
    assert len({id(r) for r in results}) == 3
    assert _builds(log) == ["permute.cu", "sortreduce.cu", "spmv.cu"]
    assert not list(build_dir.glob("*.tmp"))


def test_failed_build_raises_and_leaves_no_temporary(fake_build,
                                                     monkeypatch, tmp_path):
    """A compiler that fails raises (there is no fallback), and the
    library is not loaded."""
    _, build_dir = fake_build
    bad = tmp_path / "bad_nvcc"
    bad.write_text("#!/bin/sh\necho 'error: no' ; exit 3\n")
    bad.chmod(bad.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(_cuda, "_nvcc", lambda: str(bad))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _cuda.lib("permute")
    assert "permute" not in _cuda._libs
    assert not list(build_dir.glob("*.tmp"))
