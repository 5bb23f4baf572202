"""A configuration, a traffic mix and a per-layer metric added as new files
and new entries, with no existing file of the harness edited, are found
and run."""
import json

from perfbench import harness
from perfbench.tests import tiny


def test_new_config_mix_and_metric_from_files_alone(tmp_path):
    root = tiny.checkout(tmp_path)
    before = {p: p.read_bytes() for p in (root / "perfbench").rglob("*.py")}
    pb = root / "perfbench"
    cfg = json.loads((pb / "configs" / "resnet50.cloud.json").read_text())
    cfg.update(name="resnet50.cloud_ls")
    cfg["env"]["scenario"] = "LS"
    (pb / "configs" / "resnet50.cloud_ls.json").write_text(json.dumps(cfg))
    mix = json.loads((pb / "traffic" / "tiny_two_stage.json").read_text())
    mix.update(name="tiny_three_epochs", eps=3)
    (pb / "traffic" / "tiny_three_epochs.json").write_text(json.dumps(mix))
    (pb / "metrics" / "searches_in_window.py").write_text(
        "def read(run):\n    return float(run.searches)\n")

    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "resnet50.cloud_ls",
        "source": "https://arxiv.org/abs/2009.02010",
        "file": "perfbench/configs/resnet50.cloud_ls.json", "reduced": [],
        "why": "LS"})
    bench["workloads"].append({
        "name": "resnet50_ls.tiny", "config": "resnet50.cloud_ls",
        "traffic": "tiny_three_epochs", "chips": 1, "why": "LS"})
    bench["per_layer"].append({
        "name": "searches_in_window", "unit": "count", "better": "higher",
        "source": "host_clock", "layer": "API and two-stage driver",
        "moves": "search_s", "workloads": ["resnet50_ls.tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = harness.resolve(root, "resnet50_ls.tiny")
    assert cell.config["env"]["scenario"] == "LS"
    assert cell.traffic["eps"] == 3
    assert [m["name"] for m in cell.per_layer] == ["searches_in_window"]
    result, log = tiny.run(root, "resnet50_ls.tiny", traced=True)
    assert result["metrics"]["searches_in_window"]["value"] >= 1
    assert result["correct"], log
    after = {p: p.read_bytes() for p in before}
    assert after == before
