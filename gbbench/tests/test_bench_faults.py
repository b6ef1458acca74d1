"""A run with the timed path broken underneath comes out not correct:
the SpMV step returning its state unchanged, half the rows of each SpMV
left out, one answer altered where it is produced.  (One card: there is
no exchange between chips to leave out.)  The harness's look for a card
is skipped: the cells run on CPU tensors at a small scale."""

import time

import pytest
import torch

from gbbench import catalog, run

WORKLOADS = ["kron.sssp", "urand.pr", "kron.pr", "urand.sssp"]


def run_small(workload):
    return run.run_cell(catalog.cell(workload), 2**31 + 5, 0.2, False,
                        "cpu", time.perf_counter(), scale=10,
                        log=lambda s: None)


def unchanged(fn):
    def spmv(x, plan, **k):
        return x.clone()
    return spmv


def half_rows(fn):
    def spmv(x, plan, **k):
        y = fn(x, plan, **k).clone()
        y[y.numel() // 2:] = float("inf") if k.get("add") == "min" else 0.0
        return y
    return spmv


def altered_answer(fn):
    def entry(*a, **k):
        out = fn(*a, **k)
        r = out[0] if isinstance(out, tuple) else out
        v = int(torch.nonzero(torch.isfinite(r) & (r > 0))[-1])
        r[v] = r[v] * 1.001
        return out
    return entry


@pytest.mark.parametrize("workload", WORKLOADS)
def test_sound_run_is_correct(workload):
    assert run_small(workload)["correct"]


@pytest.mark.parametrize("fault", ["unchanged", "half_rows"])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_broken_spmv_is_not_correct(monkeypatch, workload, fault):
    from graphblas_tpu_torch.kernels import spmv_route
    make = {"unchanged": unchanged, "half_rows": half_rows}[fault]
    for name in ("spmv_route", "spmv_route_monoid"):
        monkeypatch.setattr(spmv_route, name,
                            make(getattr(spmv_route, name)))
    assert not run_small(workload)["correct"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_altered_answer_is_not_correct(monkeypatch, workload):
    import graphblas_tpu_torch.algorithms as algorithms
    fn = catalog.cell(workload).traffic["call"]    # named after its entry
    monkeypatch.setattr(algorithms, fn, altered_answer(getattr(algorithms,
                                                               fn)))
    assert not run_small(workload)["correct"]
