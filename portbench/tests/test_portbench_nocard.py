"""Without a card the measurement path fails rather than falling back to
the CPU, and prints no result."""
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import run, spec


def test_no_card_exits_without_a_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "criteo-lr.l2-grid8", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc == 2
    out = capsys.readouterr()
    assert out.out == "" and "CUDA" in out.err


def test_too_few_cards_exits_without_a_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    rc = run.main(["--workload", "kdda-lr.l2-grid8", "--seed", "1",
                   "--seconds", "1", "--trace", "1"])
    assert rc == 2 and capsys.readouterr().out == ""


def test_benchmark_files_alone_do_not_run(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cmd = spec.load_benchmark()["command"]
    p = subprocess.run(
        [sys.executable] + cmd[1:] + ["--workload", "criteo-lr.l2-grid8",
                                      "--seed", "1", "--seconds", "1",
                                      "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert "{" not in p.stdout


def test_unknown_workload_raises():
    with pytest.raises(KeyError):
        run.main(["--workload", "nope", "--seed", "1", "--seconds", "1"])
