"""A dry run of every cell at a tiny size on the CPU: set-up, window,
traced slice, the comparison and the result's line, with the port's
plain CPU paths in place of its kernels."""

import json
import time

import pytest
import torch

from portbench.harness import core
from portbench.harness.manifest import Manifest

CELLS = [w["name"] for w in Manifest().data["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_dry_run(small, cell, trace, capsys):
    result = core.run(small, cell, 2 ** 31 + 99, 0.2, bool(trace),
                      torch.device("cpu"), time.perf_counter())
    json.dumps(result)
    assert list(result)[-1] == "checks"
    assert result["attempted"] > 0 and result["failed"] == 0
    for name, c in result["checks"].items():
        assert c["value"] <= c["limit"], (name, c)
    # the CPU launches no kernel: every fault is a counter that did not
    # move where the route wants it to
    assert all("moved 0, the route wants" in f
               for f in result.get("route_faults", []))
    got = set(result["metrics"])
    if trace:
        host_side = {m["name"] for m in small.per_layer(cell)
                     if m["source"] == "host_clock"}
        assert host_side <= got
        assert result["device"]["window_s"] > 0.0
        assert "breakdown" in result
    else:
        assert got == {m["name"] for m in small.end_to_end(cell)}
        assert all(v["value"] > 0 for v in result["metrics"].values())
    err = capsys.readouterr().err.strip().splitlines()
    assert err[-len(result["checks"]):] == [
        f"check {n} {c['value']!r} limit {c['limit']!r}"
        for n, c in result["checks"].items()]


def test_every_cell_reports_what_the_contract_asks():
    m = Manifest()
    for w in m.data["workloads"]:
        e2e = {x["name"] for x in m.end_to_end(w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert m.per_layer(w["name"])
        rules = m.cell(w["name"])
        assert rules["route"] and rules["limits"]


def test_main_needs_the_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        core.main(["--workload", "f32.train-b1024", "--seed", "1",
                   "--seconds", "1"], time.perf_counter())
    assert exc.value.code == 2
    assert capsys.readouterr().out == ""
