"""Everything a cell needs is found by the name BENCHMARK.json gives it:
a configuration, a traffic mix or a metric dropped into a directory of
its own needs no change to the harness."""

import json

from gbbench import catalog


def test_files_dropped_in_are_found_by_name(tmp_path):
    for kind in ("configs", "traffic", "calls", "metrics", "graphs",
                 "reference"):
        (tmp_path / kind).mkdir()
    (tmp_path / "configs" / "toy-graph.json").write_text(json.dumps(
        {"name": "toy-graph", "generator": "ring"}))
    (tmp_path / "traffic" / "walk.json").write_text(json.dumps(
        {"call": "walk", "kwargs": {"hops": 3}, "reference": "walk",
         "sample": 1, "spmv_values": False, "limits": {}}))
    (tmp_path / "calls" / "walk.py").write_text(
        "def inputs(edges, cfg, seed):\n    return [seed], -seed\n"
        "def call(A, key, kwargs):\n    return A + key * kwargs['hops']\n")
    (tmp_path / "metrics" / "hops.py").write_text(
        "def install(run):\n    return lambda: 7.0\n")
    (tmp_path / "graphs" / "ring.py").write_text("KIND = 'ring'\n")
    bench = {
        "configs": [{"name": "toy-graph",
                     "file": "configs/toy-graph.json"}],
        "workloads": [{"name": "toy.walk", "config": "toy-graph",
                       "traffic": "walk", "chips": 1}],
        "end_to_end": [{"name": "trial_ms"}, {"name": "setup_s"},
                       {"name": "tail", "workloads": ["other"]}],
        "per_layer": [{"name": "hops", "moves": "trial_ms",
                       "workloads": ["toy.walk"]},
                      {"name": "elsewhere", "moves": "trial_ms",
                       "workloads": ["other"]}],
    }
    cell = catalog.cell("toy.walk", bench=bench, base=tmp_path,
                        root=tmp_path)
    assert cell.config["generator"] == "ring"
    assert cell.traffic["reference"] == "walk"
    assert [m["name"] for m in cell.end_to_end] == ["trial_ms", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["hops"]
    assert catalog.module("metrics", "hops", base=tmp_path).install(None)() \
        == 7.0
    assert catalog.module("graphs", "ring", base=tmp_path).KIND == "ring"
    walk = catalog.module("calls", cell.traffic["call"], base=tmp_path)
    assert walk.inputs(None, cell.config, 5) == ([5], -5)
    assert walk.call(1, 5, cell.traffic["kwargs"]) == 16


def test_benchmark_json_names_only_files_that_exist():
    bench = catalog.load_json(catalog.ROOT / "BENCHMARK.json")
    for c in bench["configs"]:
        assert (catalog.ROOT / c["file"]).is_file()
        cfg = catalog.load_json(catalog.ROOT / c["file"])
        assert (catalog.HERE / "graphs" / f"{cfg['generator']}.py").is_file()
        assert (catalog.HERE / "weights" / f"{cfg['weights']}.py").is_file()
        assert set(c["reduced"]) <= set(cfg["reduced"])
    for w in bench["workloads"]:
        cell = catalog.cell(w["name"], bench=bench)
        ref = cell.traffic["reference"]
        assert (catalog.HERE / "reference" / f"{ref}.py").is_file()
        assert (catalog.HERE / "calls" / f"{cell.traffic['call']}.py"
                ).is_file()
        assert isinstance(cell.traffic["spmv_values"], bool)
        for m in cell.per_layer:
            assert (catalog.HERE / "metrics" / f"{m['name']}.py").is_file()


def test_derived_seeds_differ_by_tag_and_seed():
    a = catalog.derive(2**40 + 3, "edges")
    assert a == catalog.derive(2**40 + 3, "edges")
    assert a != catalog.derive(2**40 + 3, "roots")
    assert a != catalog.derive(2**40 + 4, "edges")
    assert 0 <= a < 2**63
