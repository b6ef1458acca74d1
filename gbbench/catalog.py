"""Find a cell's configuration, traffic mix, reference and metrics by the
names ``BENCHMARK.json`` gives them, and derive the seeds of their draws."""

from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

_modules: dict = {}


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def module(kind: str, name: str, base: Path = HERE):
    """``<base>/<kind>/<name>.py`` as a module (loaded once)."""
    path = base / kind / f"{name}.py"
    key = str(path)
    if key not in _modules:
        if not path.is_file():
            raise FileNotFoundError(f"no {kind} named {name!r}: {path}")
        spec = importlib.util.spec_from_file_location(
            f"gbbench_{kind}_{name.replace('-', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _modules[key] = mod
    return _modules[key]


def derive(seed: int, tag: str) -> int:
    """A 63-bit seed for the draw ``tag`` of the run seeded ``seed``."""
    h = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def _reports(metric: dict, cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def cell(name: str, bench: dict | None = None, base: Path = HERE,
         root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``bench`` (default ``<root>/BENCHMARK.json``)."""
    bench = bench if bench is not None else load_json(root / "BENCHMARK.json")
    wl = {w["name"]: w for w in bench["workloads"]}
    if name not in wl:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {', '.join(sorted(wl))})")
    w = wl[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = load_json(root / cfg["file"])
    traffic = load_json(base / "traffic" / f"{w['traffic']}.json")
    e2e = [m for m in bench["end_to_end"] if _reports(m, name, ())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name, w, config, traffic, e2e, per_layer)
