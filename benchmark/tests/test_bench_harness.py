"""The harness finds each configuration, traffic mix, limit file and metric reader by the
names in ``BENCHMARK.json``; the file keeps to the benchmark's contract; a run of every
workload at a small size on the CPU (the look for a card skipped) comes out correct, and with
the timed path broken underneath comes out not correct.

The faults are planted in the program the drivers call: a roll-out whose every prediction is
the state it was handed, or whose answers are altered where they are produced; a train step
that hands back its parameters unchanged, or hands AdamW altered gradients. Half a batch and the
exchange between chips cannot be left out of these cells: batch 1 on one chip."""

import dataclasses
import json
import re

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.drivers import forecast, train
from benchmark.tests.small import SEED, SMALL, traffic_update

SP = run.spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
WORKLOADS = [w["name"] for w in SP["workloads"]]


def _forecast_unchanged(mp):
    real = forecast.rollout_scan

    def scan(model, ic, steps, host_offload=False):
        return [dataclasses.replace(p, surf_vars={k: v[:, -1:] for k, v in ic.surf_vars.items()},
                                    atmos_vars={k: v[:, -1:] for k, v in ic.atmos_vars.items()})
                for p in real(model, ic, steps, host_offload)]

    mp.setattr(forecast, "rollout_scan", scan)


def _forecast_altered(mp):
    real = forecast.rollout_scan

    def scan(model, ic, steps, host_offload=False):
        preds = real(model, ic, steps, host_offload)
        for p in preds:
            p.surf_vars["2t"] = p.surf_vars["2t"] + np.float32(2.0)  # 2 K
        return preds

    mp.setattr(forecast, "rollout_scan", scan)


def _train_unchanged(mp):
    real = train.make_train_step

    def make(model, optimizer, levels):
        step = real(model, optimizer, levels)

        def frozen(*args, **kwargs):
            kept = [p.detach().clone() for p in optimizer.params]
            loss = step(*args, **kwargs)
            with torch.no_grad():
                for p, k in zip(optimizer.params, kept):
                    p.copy_(k)
            return loss

        return frozen

    mp.setattr(train, "make_train_step", make)


def _train_altered(mp):
    real = train.make_train_step

    def make(model, optimizer, levels):
        step = real(model, optimizer, levels)
        apply = optimizer.step

        def scaled():  # the gradients altered where the backward produced them
            for p in optimizer.params:
                p.grad.mul_(1.1)
            apply()

        optimizer.step = scaled
        return step

    mp.setattr(train, "make_train_step", make)


FAULTS = {"forecast": {"unchanged": _forecast_unchanged, "altered": _forecast_altered},
          "train": {"unchanged": _train_unchanged, "altered": _train_altered}}


def test_the_file_keeps_to_the_contract():
    assert set(SP) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                       "per_layer"}
    assert 1 <= SP["run_seconds"] <= 51
    names = [c["name"] for c in SP["configs"]] + WORKLOADS + [
        m["name"] for m in SP["end_to_end"] + SP["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in SP["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for m in SP["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert run.applies(e2e[m["moves"]], w), (m["name"], w)
    for w in SP["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        reported = [m for m in SP["end_to_end"] if run.applies(m, w["name"])]
        assert "setup_s" in [m["name"] for m in reported] and len(reported) >= 2
        assert any(run.applies(m, w["name"]) for m in SP["per_layer"])
    used = {w["config"] for w in SP["workloads"]}
    assert used == {c["name"] for c in SP["configs"]}
    assert len(json.dumps(SP)) < 64 * 1024


@pytest.mark.parametrize("name", WORKLOADS)
def test_each_workload_finds_its_files_by_name(name):
    wl = run.workload(SP, name)
    cfg = run.config(SP, wl["config"])
    tf = run.traffic(wl["traffic"])
    assert run.driver(tf["kind"]) is not None
    assert run.limits(name)
    assert cfg["peak"] in run.load_json(run.HERE / "peaks.json")["NVIDIA H100 80GB HBM3"]
    for m in SP["per_layer"]:
        if run.applies(m, name):
            assert callable(run.reader(m["name"]))


def test_the_configurations_cut_nothing():
    for c in SP["configs"]:
        assert c["reduced"] == []
        cfg = run.load_json(run.ROOT / c["file"])
        assert (cfg["embed_dim"], cfg["encoder_depths"], cfg["decoder_depths"]) == (
            512, [6, 10, 8], [8, 10, 6])


@pytest.mark.parametrize("name", WORKLOADS)
def test_a_small_run_on_the_cpu_is_correct(name):
    out, lines = run.run(name, SEED, 0.0, False, torch.device("cpu"), cfg_update=SMALL,
                         traffic_update=traffic_update(name))
    assert out["correct"], lines
    assert list(out)[-1] == "checks" and out["attempted"] >= 1
    wanted = {m["name"] for m in SP["end_to_end"] if run.applies(m, name)}
    assert set(out["metrics"]) == wanted


@pytest.mark.parametrize("name,fault", [(w, f) for w in WORKLOADS for f in FAULTS[
    run.traffic(run.workload(SP, w)["traffic"])["kind"]]])
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    FAULTS[run.traffic(run.workload(SP, name)["traffic"])["kind"]][fault](monkeypatch)
    out, lines = run.run(name, SEED, 0.0, False, torch.device("cpu"), cfg_update=SMALL,
                         traffic_update=traffic_update(name))
    assert not out["correct"], lines


def test_the_entry_refuses_to_run_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", WORKLOADS[0], "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""
