"""The harness is driven by data: a cell, a configuration or a metric is a
file found by its name, and a cell reports what its metrics move."""
import json
import os
import shutil
import subprocess
import sys

from ovbench import harness

ROOT = harness.ROOT


def test_new_workload_file_is_found(tmp_path):
    """A workload file added to a copy is a cell of that copy, with no code
    edited: the harness finds its file, its configuration, its traffic
    driver and the metrics BENCHMARK.json gives it."""
    shutil.copytree(os.path.join(ROOT, "ovbench"), tmp_path / "ovbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    spec = harness.workload("scannet_masked.detect")
    spec.pop("name")
    spec["traffic_params"] = dict(spec["traffic_params"], pool=4)
    (tmp_path / "ovbench" / "workloads" / "scannet_masked.detect_pool4.json").write_text(
        json.dumps(spec))
    bench["workloads"].append({"name": "scannet_masked.detect_pool4", "config": "scannet_masked",
                               "traffic": "detect", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "scannet_masked.detect" in m.get("workloads", []):
            m["workloads"].append("scannet_masked.detect_pool4")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import sys; sys.path.insert(0, '.'); from ovbench import harness\n"
            "s = harness.workload('scannet_masked.detect_pool4'); c = harness.config(s['config'])\n"
            "d = harness.traffic(s['traffic'])\n"
            "e, p = harness.cell_metrics(harness.benchmark('.'), s['name'])\n"
            "[harness.reader(m['name']) for m in p]\n"
            "print(s['traffic_params']['pool'], c['name'], d.__name__, len(e), len(p))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, check=True).stdout.split()
    assert out == ["4", "scannet_masked", "ovbench_traffic_detect", "4", "4"]
    # the copy's harness read the copy's files, not these
    assert not os.path.exists(os.path.join(ROOT, "ovbench", "workloads",
                                           "scannet_masked.detect_pool4.json"))


def test_every_cell_reports_what_its_metrics_move():
    bench = harness.benchmark()
    for cell in bench["workloads"]:
        e2e, per_layer = harness.cell_metrics(bench, cell["name"])
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2 and per_layer, cell["name"]
        for m in per_layer:
            assert m["moves"] in names, (cell["name"], m["name"], m["moves"])


def test_every_name_has_its_file():
    bench = harness.benchmark()
    for c in bench["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert harness.config(c["name"])["name"] == c["name"]
    for w in bench["workloads"]:
        spec = harness.workload(w["name"])
        assert (spec["config"], spec["traffic"], spec["chips"]) == (w["config"], w["traffic"],
                                                                    w["chips"])
        assert os.path.isfile(os.path.join(ROOT, "ovbench", "traffic", f"{w['traffic']}.py"))
    for m in bench["per_layer"]:
        assert os.path.isfile(os.path.join(ROOT, "ovbench", "metrics", f"{m['name']}.py"))
