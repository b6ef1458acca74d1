"""No JAX in a run or in the references, and no card means no result."""

import subprocess
import sys
import textwrap

from gbbench import catalog

FOREIGN = ("jax", "jaxlib", "flax", "graphblas_tpu")


def in_fresh_process(code: str) -> str:
    prog = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(catalog.ROOT)!r})
    """) + textwrap.dedent(code)
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=600, check=True)
    return out.stdout.strip().splitlines()[-1]


def test_a_run_loads_no_jax():
    last = in_fresh_process("""
        import time
        from gbbench import catalog, run
        run.run_cell(catalog.cell("kron.sssp"), 3, 0.1, True, "cpu",
                     time.perf_counter(), scale=8, log=lambda s: None)
        print(run.foreign_modules(),
              "graphblas_tpu_torch" in sys.modules)
    """)
    assert last == "[] True"


def test_the_references_load_nothing_of_the_program():
    last = in_fresh_process("""
        import torch
        from gbbench import catalog, graph
        cfg = catalog.load_json(catalog.HERE / "configs" / "gap-urand.json")
        e = graph.generate(cfg, 1, "cpu", 8)
        p = {"damping": 0.85, "tol": 1e-4, "max_iter": 20}
        for name in ("sssp", "pagerank"):
            ref = catalog.module("reference", name)
            ref.solve(ref.prepare(e, cfg, p, torch.float64), 0, p,
                      torch.float64)
        print(sorted(m for m in sys.modules
                     if m.split(".")[0] in {FOREIGN!r} + ("graphblas_tpu_torch",)))
    """.replace("{FOREIGN!r}", repr(FOREIGN)))
    assert last == "[]"


def test_foreign_modules_compares_whole_top_level_names(monkeypatch):
    from gbbench import run
    monkeypatch.setitem(sys.modules, "graphblas_tpu_torch_x", sys)
    assert "graphblas_tpu_torch_x" not in run.foreign_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax.numpy" in run.foreign_modules()


def test_no_card_no_result(capsys):
    import torch

    from gbbench import run
    if torch.cuda.is_available():
        return      # the card's own run is covered by test_bench_cuda
    assert run.main(["--workload", "kron.sssp", "--seed", "1",
                     "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""
