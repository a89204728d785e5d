"""A short run of each cell on the card, its result line as the contract
has it (skips without CUDA)."""

import json

import pytest

from h100bench import run


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in json.loads(
    (run.HERE.parent / "BENCHMARK.json").read_text())["workloads"]])
def test_cell_on_card(card, capsys, root, cell):
    assert run.run(["--workload", cell, "--seed", "2147483999",
                    "--seconds", "5", "--trace", "0"], root=root) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert list(res)[-1] == "checks"
    assert {"setup_s"} < set(res["metrics"])
