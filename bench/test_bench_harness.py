"""The harness finds each cell's configuration, traffic, limits, reference
and metrics by name, and a new cell, mix or metric takes only new files
and entries; ``BENCHMARK.json`` keeps to the benchmark's contract."""
import json
import re
import shutil
from pathlib import Path

import pytest

from bench import harness
from bench.conftest import TINY, TINY_TRAFFIC

ROOT = Path(__file__).resolve().parents[1]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_is_found_by_name(cell):
    c = harness.load_cell(cell)
    w = next(w for w in SPEC["workloads"] if w["name"] == cell)
    assert c.config["model"]["name"] == w["config"]
    assert c.traffic["prefix_len"] > 0 and c.limits["route_mismatch"]
    assert callable(c.reference.logits)
    assert {m["name"] for m in c.end_to_end} == {"req_s", "ttft_p90_ms",
                                                  "setup_s"}
    for m in c.per_layer:
        assert callable(c.metric(m["name"]).read)


def test_configuration_files_describe_the_ports_models():
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ModelConfig
    for conf in SPEC["configs"]:
        model = json.loads((ROOT / conf["file"]).read_text())["model"]
        assert ModelConfig(**model) == get_config(conf["name"])


def test_mamba2_file_runs_the_published_widths_and_lists_its_departure():
    conf = next(c for c in SPEC["configs"] if c["name"] == "mamba2-370m")
    pub = json.loads((ROOT / conf["file"]).read_text())
    run = pub["model"]
    assert (run["d_model"], run["n_layers"]) == (pub["d_model"],
                                                 pub["n_layer"])
    assert run["ssm_state"] == pub["d_state"]
    assert run["ssm_headdim"] == pub["headdim"]
    assert run["ssm_expand"] == pub["expand"]
    assert run["ssm_conv"] == pub["d_conv"]
    assert run["ssm_chunk"] == pub["chunk_size"]
    # the one number the port runs otherwise is listed in ``reduced``
    assert run["vocab"] != pub["vocab_size"]
    assert conf["reduced"] == ["vocab_size"]


def test_benchmark_json_keeps_to_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "bench/run.py"]
    assert SPEC["paths"] == ["bench"]
    rs = SPEC["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits its 43,200 seconds
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
        assert (ROOT / "bench/metrics" / f"{m['name']}.py").exists()
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    for c in SPEC["configs"]:
        assert c["file"].startswith("bench/") and len(c["why"]) <= 200
    for w in SPEC["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
        per = [m for m in SPEC["per_layer"]
               if w["name"] in m.get("workloads", [w["name"]])]
        assert per
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_a_new_cell_mix_and_metric_take_only_new_files(tmp_path):
    """Copy the benchmark, add a mix, a cell's limits, a per-layer metric
    and their entries, and run the new cell at a CPU size: the new metric
    is read and the run is correct; no file that was there changed."""
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p: p.read_bytes() for p in (tmp_path / "bench").rglob("*")
              if p.is_file()}
    bench = tmp_path / "bench"
    mix = json.loads((bench / "traffic/docqa.json").read_text())
    mix["stream"]["p_new"] = 0.5
    (bench / "traffic/halfnew.json").write_text(json.dumps(mix))
    (bench / "limits/mamba2-370m.halfnew.json").write_text(
        (bench / "limits/mamba2-370m.docqa.json").read_text())
    (bench / "metrics/probes_per_request.py").write_text(
        "def read(run):\n"
        "    n = run.stats['requests']\n"
        "    return run.stats['probes'] / n if n else None\n")
    spec["workloads"].append({"name": "mamba2-370m.halfnew",
                              "config": "mamba2-370m", "traffic": "halfnew",
                              "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "probes_per_request", "unit": "1",
                              "better": "lower", "source": "program_counter",
                              "layer": "router: serving.prefix_cache",
                              "moves": "ttft_p90_ms",
                              "workloads": ["mamba2-370m.halfnew"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.load_cell("mamba2-370m.halfnew", root=tmp_path,
                             model_over=TINY["mamba2-370m"],
                             traffic_over=TINY_TRAFFIC)
    result, checks = harness.run_cell(cell, 2**31 + 3, 1.0, True,
                                      device="cpu", t_start=0.0)
    assert result["correct"], checks
    assert result["metrics"]["probes_per_request"]["value"] > 0
    for p, data in before.items():
        assert p.read_bytes() == data
