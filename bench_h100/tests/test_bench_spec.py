"""BENCHMARK.json keeps to the contract's names and units, and every file a
name points to is found by that name."""

import json
import re
from pathlib import Path

import pytest

from bench_h100 import harness

ROOT = Path(__file__).resolve().parents[1]
SPEC = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_names_and_units():
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [w["name"] for w in SPEC["workloads"]] + [c["name"] for c in SPEC["configs"]]
    names += [w["config"] for w in SPEC["workloads"]] + [w["traffic"] for w in SPEC["workloads"]]
    names += [k for c in SPEC["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    for section in ("end_to_end", "per_layer", "workloads", "configs"):
        own = [e["name"] for e in SPEC[section]]
        assert len(own) == len(set(own))
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in [w["why"] for w in SPEC["workloads"]] + [c["why"] for c in SPEC["configs"]] \
            + [m["layer"] for m in SPEC["per_layer"]] + SPEC["command"]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_every_file_is_found_by_name():
    for w in SPEC["workloads"]:
        f = harness.cell_files(w["name"], SPEC)
        assert f["config"]["name"] == w["config"]
        assert set(f["limits"]) and all(v > 0 for v in f["limits"].values())
        ref = f["reference"]
        assert all(callable(getattr(ref, k)) for k in
                   ("param_spec", "train_reference", "eval_reference"))
        assert f["config"]["control"] in ref.PRECISIONS
        assert callable(f["generator"].make_batches) and callable(f["generator"].to_device)
        assert callable(f["loop"].Loop.step) and callable(f["loop"].Loop.finish)
    for c in SPEC["configs"]:
        assert (ROOT.parent / c["file"]).exists()
    for section in ("end_to_end", "per_layer"):
        for m in SPEC[section]:
            assert callable(harness.metric_reader(section, m["name"]))


def test_every_per_layer_metric_lists_its_cells():
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        assert m["workloads"] and set(m["workloads"]) <= cells, m["name"]


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_reports_setup_another_and_a_layer(cell):
    e2e = {m["name"] for m in harness.cell_metrics(SPEC, cell, "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = harness.cell_metrics(SPEC, cell, "per_layer")
    assert layers and all(m["moves"] in e2e for m in layers)


def test_readers_read_nothing_without_a_capture():
    class Empty:
        capture, spans, steps, events, dispatch_ms, window_s, step_ms = None, {}, 0, 0, [], 0.0, []

        def kernel_s(self, ids):
            return 0.0

    for m in SPEC["per_layer"]:
        assert harness.metric_reader("per_layer", m["name"])(Empty()) is None
