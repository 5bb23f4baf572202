"""The command as the benchmark's contract runs it."""
import os
import shutil
import subprocess
import sys

import pytest

from perfbench.tests.tiny import REPO


def _run(cwd, *args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "mobilenet_v2.two_stage", "--seed", "4294967311", "--seconds", "1",
         *args], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=600)


def test_without_a_card_it_fails_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = _run(REPO, "--trace", "0")
    assert p.returncode == 2
    assert p.stdout == ""


@pytest.mark.cuda
def test_with_nothing_but_the_benchmark_it_fails(tmp_path):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "perfbench", tmp_path / "perfbench")
    p = _run(tmp_path, "--trace", "0")
    assert p.returncode != 0
    assert p.stdout == ""
