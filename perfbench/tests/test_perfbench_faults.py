"""A whole run, past the look for a card, with the timed path broken
underneath (``perfbench.faults``): ``correct`` has to come out false for
each fault the cell can have, and true for the sound program.  On the CPU
at tiny sizes (the program's plain path, the same references)."""
import pytest
import torch

from perfbench import faults
from perfbench.tests import tiny

CELL = "tiny.two_stage"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.checkout(tmp_path_factory.mktemp("bench"))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_sound_program_is_correct(root):
    result, log = tiny.run(root, CELL)
    assert result["correct"], log
    assert result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert set(result["checks"]) == {"rescore_gap", "policy_gap",
                                     "stage2_errors", "ga_stall"}
    assert log.strip().splitlines()[-1] == "correct true"


@pytest.mark.parametrize("fault,number", [
    ("adam_unchanged", "policy_gap"),
    ("answer_value", "rescore_gap"),
    ("answer_assignment", "rescore_gap"),
    ("ga_skipped", "stage2_errors"),
    ("ga_short", "stage2_errors"),
    ("ga_frozen", "ga_stall")])
def test_a_fault_is_not_correct(root, fault, number):
    with faults.FAULTS[fault]():
        result, log = tiny.run(root, CELL)
    assert not result["correct"], log
    check = result["checks"][number]
    assert check["value"] > check["limit"], log


def test_faults_restore_the_program(root):
    with faults.FAULTS["ga_frozen"]():
        pass
    result, log = tiny.run(root, CELL)
    assert result["correct"], log
