"""Port parity: the diagnostics and extension points of the object model,
``Matrix.iso_value``, ``Matrix.fprint``, ``Matrix.memory_usage``,
``config.timed`` with ``GLOBAL.timing`` and ``serialize.register_codec``,
against the JAX package's, on the same seed-made matrices (the models:
tests/test_core.py::test_memory_usage_and_check and
tests/test_config_context.py::test_timed_accumulates)."""

import io

import numpy as np
import pytest
import scipy.sparse as sps

import graphblas_tpu as gb
import graphblas_tpu_torch as gt
from graphblas_tpu.core import config as JCFG
from graphblas_tpu.core import errors as JE
from graphblas_tpu.ops import serialize as JS
from graphblas_tpu_torch.core import config as TCFG
from graphblas_tpu_torch.core import errors as TE
from graphblas_tpu_torch.ops import serialize as TS
from torch_parity import cpu_default, random_csr, to_port  # noqa: F401


def _matrix(fmt, seed=70):
    """(JAX, port) 12 x 9 matrix in ``fmt`` (full: every entry)."""
    rng = np.random.default_rng(seed)
    S = sps.csr_matrix(rng.standard_normal((12, 9)).astype(np.float32)) \
        if fmt == gb.FULL else random_csr(rng, 12, 9, 0.3)
    Aj = gb.Matrix.from_scipy(S).to_format(fmt)
    return Aj, to_port(Aj)


@pytest.mark.parametrize("fmt", [gb.SPARSE, gb.HYPER, gb.BITMAP, gb.FULL])
def test_memory_usage_matches_jax(fmt):
    Aj, At = _matrix(fmt)
    assert At.fmt == fmt
    assert At.memory_usage() == Aj.memory_usage() > 0
    At.check()


def test_iso_value_matches_jax():
    r, c = np.array([0, 1, 3]), np.array([2, 0, 1])
    Aj = gb.Matrix.from_coo(r, c, 2.5, (4, 4), dtype=gb.types.FP32, iso=True)
    At = to_port(Aj)
    assert At.iso and float(At.iso_value()) == float(Aj.iso_value()) == 2.5
    assert At.iso_value().dim() == 0
    Bj, Bt = _matrix(gb.SPARSE)
    with pytest.raises(JE.InvalidValue):
        Bj.iso_value()
    with pytest.raises(TE.InvalidValue):
        Bt.iso_value()


@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_fprint_matches_jax(level):
    """The same entries, in the same words; the header's repr names the
    port's device besides."""
    Aj, At = _matrix(gb.SPARSE)
    outs = []
    for A in (Aj, At):
        buf = io.StringIO()
        A.fprint(level, name="A", file=buf)
        outs.append(buf.getvalue().splitlines())
    oj, ot = outs
    assert len(oj) == len(ot) == (0 if level == 0 else 1 if level == 1
                                  else 10 if level == 2
                                  else 1 + At.nvals)
    assert ot[1:] == oj[1:]
    if level:
        assert ot[0] == oj[0][:-1] + " cpu)"


def test_timed_accumulates():
    for CFG in (JCFG, TCFG):
        CFG.GLOBAL.timing.clear()
        with CFG.timed("unit") as t:
            pass
        assert t.key == "unit"
        with CFG.timed("unit"):
            pass
        with CFG.timed("other"):
            pass
        assert sorted(CFG.GLOBAL.timing) == ["other", "unit"]
        assert all(v >= 0.0 for v in CFG.GLOBAL.timing.values())
        CFG.GLOBAL.timing.clear()


def test_register_codec_matches_jax(monkeypatch):
    """A codec plugged into both gives byte-equal blobs, and each side
    reads them back."""
    for mod in (JS, TS):
        monkeypatch.setattr(mod, "_CODECS", dict(mod._CODECS))
        mod.register_codec("reversed", lambda b, level: b[::-1],
                           lambda b: b[::-1])
    Aj, At = _matrix(gb.SPARSE)
    blob = TS.serialize(At, "reversed")
    assert blob == JS.serialize(Aj, "reversed")
    assert gt.deserialize(blob, device="cpu").isequal(At)
    assert JS.deserialize(blob).isequal(Aj)
