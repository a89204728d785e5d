"""Configurations, traffic mixes, limits and per-layer metrics are found
by name, and a cell added by files and entries alone is picked up."""

import json
import shutil

import pytest

from h100bench import run


def _bench(root):
    return json.loads((root / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", [w["name"] for w in json.loads(
    (run.HERE.parent / "BENCHMARK.json").read_text())["workloads"]])
def test_every_cell_resolves(root, cell):
    c = run.Cell(root, cell)
    assert c.cfg["name"] == c.entry["config"]
    assert c.mix["kind"] in ("codec", "train")
    assert set(c.limits) and all(v > 0 for v in c.limits.values())
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert callable(run.load_metric(m["name"], c.base))
        assert m["moves"] in names


def test_contract_shape(root):
    b = _bench(root)
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (root / c["file"]).exists()
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    per_layer = {m["name"] for m in b["per_layer"]}
    for m in b["per_layer"]:
        assert (run.HERE / "metrics" / f"{m['name']}.py").exists()
    assert len(per_layer) == len(b["per_layer"])


def test_added_files_are_picked_up(tmp_path, root):
    """A new mix, configuration, limits, metric and cell in a copy of the
    benchmark, with no edit to any file the benchmark has."""
    shutil.copytree(root / "h100bench", tmp_path / "h100bench")
    b = _bench(root)
    src = tmp_path / "h100bench"
    mix = json.loads((src / "traffic" / "vox10.json").read_text())
    mix["rho"] = 2.0
    (src / "traffic" / "vox10-rho2.json").write_text(json.dumps(mix))
    cfg = json.loads((src / "configs" / "pcgcv2-r4-bf16.json").read_text())
    cfg["name"] = "pcgcv2-r4-bf16-bs8"
    cfg["env"] = {"PCGC_BLOCK_SIZE": "8"}
    cfg["block_size"] = 8
    (src / "configs" / "pcgcv2-r4-bf16-bs8.json").write_text(
        json.dumps(cfg))
    (src / "limits" / "codec-new.json").write_text(
        (src / "limits" / "codec-vox10-bf16.json").read_text())
    (src / "metrics" / "codec.frames_seen.py").write_text(
        "def read(rec):\n    return float(len(rec.records))\n")
    b["configs"].append({"name": "pcgcv2-r4-bf16-bs8", "source": "x",
                         "file": "h100bench/configs/pcgcv2-r4-bf16-bs8.json",
                         "reduced": [], "why": "x"})
    b["workloads"].append({"name": "codec-new", "config":
                           "pcgcv2-r4-bf16-bs8", "traffic": "vox10-rho2",
                           "chips": 1, "why": "x"})
    b["per_layer"].append({"name": "codec.frames_seen", "unit": "frames",
                           "better": "higher", "source": "program_counter",
                           "layer": "codec driver", "moves": "frames_per_s",
                           "workloads": ["codec-new"]})
    for m in b["end_to_end"]:
        if m["name"] == "frames_per_s":
            m["workloads"].append("codec-new")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    c = run.Cell(tmp_path, "codec-new")
    assert c.mix["rho"] == 2.0 and c.cfg["env"]["PCGC_BLOCK_SIZE"] == "8"
    assert [m["name"] for m in c.per_layer] == ["codec.frames_seen"]
    read = run.load_metric("codec.frames_seen", c.base)
    assert read(type("R", (), {"records": [1, 2]})) == 2.0


def test_unknown_cell_refused(root):
    with pytest.raises(SystemExit):
        run.Cell(root, "no-such-cell")
