"""BENCHMARK.json against the benchmark's contract, and every cell resolved
to its configuration, traffic, limits and metric files by name."""
import json
import os
import re
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, ROOT]

from harness import launch, runs, spec  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
BENCHMARK = spec.benchmark()
CELLS = [w["name"] for w in BENCHMARK["workloads"]]


def line_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_size():
    assert set(BENCHMARK) == {"command", "paths", "run_seconds", "configs",
                              "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= BENCHMARK["run_seconds"] <= 51
    assert isinstance(BENCHMARK["run_seconds"], int)
    cmd = BENCHMARK["command"]
    assert 1 <= len(cmd) <= 32 and all(line_ok(w) for w in cmd)
    for p in BENCHMARK["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert os.path.isdir(os.path.join(ROOT, p))
    assert cmd[1].split("/")[0] in BENCHMARK["paths"]


def test_configs():
    files = set()
    for c in BENCHMARK["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line_ok(c["source"])
        assert line_ok(c["why"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith("benchmarks/") and c["file"] not in files
        files.add(c["file"])
        conf = spec.load_json(os.path.join(ROOT, c["file"]))
        assert conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in BENCHMARK["workloads"])


def test_metrics():
    names = set()
    e2e = {m["name"] for m in BENCHMARK["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCHMARK["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCHMARK["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and m["moves"] in e2e
        assert line_ok(m["layer"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    w = {x["name"]: x for x in BENCHMARK["workloads"]}[name]
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(name) and NAME.match(w["traffic"])
    assert w["chips"] in (1, 4) and line_ok(w["why"])
    cell = spec.cell(name)
    assert cell.traffic["kind"] in runs.KINDS
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    assert all(0 < v for v in cell.limits.values())
    for m in cell.per_layer:
        assert callable(spec.reader(m["name"]))
        assert any(e["name"] == m["moves"] for e in cell.end_to_end)
    for key in ("cell", "ffield", "rxmd_in"):
        assert os.path.exists(spec.data_path(cell.config["deck"][key]))


def test_one_pair_per_cell_and_four_chip_share():
    pairs = [(w["config"], w["traffic"]) for w in BENCHMARK["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in BENCHMARK["workloads"])
    assert four <= max(1, len(CELLS) // 4)


def test_files_under_paths_are_named_from_name_characters():
    for dirpath, _, files in os.walk(BENCH):
        if "__pycache__" in dirpath:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            assert re.fullmatch(r"[A-Za-z0-9_.\-/]+", rel), rel


def test_json_files_parse():
    for sub in ("configs", "traffic", "limits"):
        for f in os.listdir(os.path.join(BENCH, sub)):
            with open(os.path.join(BENCH, sub, f)) as fh:
                json.load(fh)


@pytest.mark.parametrize("name", [c["name"] for c in BENCHMARK["configs"]])
def test_config_runs_the_engine_it_declares(name):
    """A configuration names its pair engine, the port runs that one on
    the cell replicated (2, 2, 2), whose box the dense forms could take
    (every side over 2 x 10.4 A), and the harness refuses a mismatch."""
    from harness import deck, port
    conf = {c["name"]: c for c in BENCHMARK["configs"]}[name]
    config = spec.load_json(os.path.join(ROOT, conf["file"]))
    assert config["engine"] in ("sweep", "ell", "dense")
    config["deck"]["replicate"] = [2, 2, 2]
    traffic = next(spec.cell(w["name"]).traffic
                   for w in BENCHMARK["workloads"] if w["config"] == name)
    inputs = deck.make(config, traffic, 3)
    assert port.engine(config, traffic, inputs, "cpu").pair_engine \
        == config["engine"]
    config["engine"] = "dense" if config["engine"] != "dense" else "ell"
    with pytest.raises(RuntimeError, match="declares the pair engine"):
        port.engine(config, traffic, inputs, "cpu")


def test_every_mix_names_a_kind_of_the_harness():
    for f in os.listdir(os.path.join(BENCH, "traffic")):
        mix = spec.load_json(os.path.join(BENCH, "traffic", f))
        assert mix["kind"] in runs.KINDS, f


def test_the_sharded_mix_is_md_exls_settings_and_draws():
    """traffic/md_exl_sharded.json: md_exl's MD under the kind md_sharded,
    with the launcher's set-up allowance under the 360 s of a run."""
    load = lambda m: spec.load_json(os.path.join(BENCH, "traffic",
                                                 m + ".json"))
    exl, sh = load("md_exl"), load("md_exl_sharded")
    assert sh["kind"] == "md_sharded"
    for key in ("run_config", "draw", "warmup_steps", "chunk_steps",
                "trace_steps"):
        assert sh[key] == exl[key], key
    assert launch.SETUP_ALLOWANCE_S + BENCHMARK["run_seconds"] < 360


def test_the_sharded_engine_runs_the_pair_list():
    """port_sharded refuses a configuration that declares another pair
    engine than the sharded engine's pair list, before it builds one."""
    from harness import port_sharded
    config = spec.load_json(os.path.join(BENCH, "configs",
                                         "rdx_qeq_8k.json"))
    assert config["engine"] == "sweep"
    with pytest.raises(RuntimeError, match="runs the pair list"):
        port_sharded.engine(config, None, None, "cpu")
