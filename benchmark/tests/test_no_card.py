"""The measurement path needs the card: without one it prints no result
and exits with another code than 0, also in a directory that holds only
``BENCHMARK.json`` and the benchmark."""

import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import cell, run

ARGS = ["--workload", "dat_to_cd.madi_block", "--seed", "2147483999",
        "--seconds", "1", "--trace", "0"]


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")


def test_main_refuses_without_a_card(no_card, capsys):
    assert run.main(ARGS) != 0
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("where", ["repo", "bare"])
def test_command_refuses_without_a_card(no_card, tmp_path, where):
    cwd = cell.REPO
    if where == "bare":  # the benchmark alone, without the program
        shutil.copy(cell.REPO / "BENCHMARK.json", tmp_path)
        shutil.copytree(cell.REPO / "benchmark", tmp_path / "benchmark",
                        ignore=shutil.ignore_patterns("__pycache__"))
        cwd = tmp_path
    proc = subprocess.run([sys.executable, "-m", "benchmark.run", *ARGS],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert proc.stdout == ""
