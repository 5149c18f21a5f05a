"""The manifest and the harness's files: names, units, the import rule,
and every cell's files found by name."""
import ast
import json
import re

from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "imfnet_tpu", "chip_smoke", "bench", "conv_sweep",
             "loader_bench"}


def manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def imported_top_levels(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        found = imported_top_levels(path) & FORBIDDEN
        assert not found, f"{path.relative_to(ROOT)} imports {sorted(found)}"


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        found = {n for n in imported_top_levels(path) if n.startswith("imfnet_tpu")}
        assert not found, f"{path.relative_to(ROOT)} imports {sorted(found)}"


def test_whole_top_level_names_tell_the_port_from_the_jax_package():
    # the port's name begins with the JAX package's: compared whole it passes
    assert "imfnet_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "imfnet_tpu.models".split(".")[0] in FORBIDDEN


def test_names_and_units_keep_to_the_allowed_characters():
    b = manifest()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    for c in b["configs"]:
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
    for w in b["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 0 < len(w["why"]) <= 200
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    assert 1 <= b["run_seconds"] <= 51


def test_every_cell_finds_its_files_by_name():
    from benchlib import harness

    b = manifest()
    e2e = {m["name"] for m in b["end_to_end"]}
    for w in b["workloads"]:
        cell = harness.Cell.load(ROOT, w["name"])
        assert cell.driver_path.exists()
        assert set(cell.workload["end_to_end"]) == {m["name"] for m in cell.end_to_end}
        assert "setup_s" in cell.workload["end_to_end"]
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert (cell.metric_dir / f"{m['name']}.py").exists(), m["name"]
            assert m["moves"] in e2e and m["moves"] in cell.workload["end_to_end"]
        assert cell.workload["limits"]
    for c in b["configs"]:
        assert (ROOT / c["file"]).exists()
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]


def test_every_layer_name_is_one_line():
    for m in manifest()["per_layer"]:
        assert "\n" not in m["layer"] and 0 < len(m["layer"]) <= 200
