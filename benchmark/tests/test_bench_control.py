"""The comparison fails what it has to fail: the control (the port's own
bf16 ``compute_dtype`` in the program's place) and each fault a cell can
have, planted in the timed path, make ``correct`` false. The rest of the
run is the benchmark's own, the look for a card skipped."""
import pytest

SERVE = ["style1_ric.serve", "style2_plain.serve"]


@pytest.mark.parametrize("cell", ["style1_ric.train"] + SERVE)
def test_control_is_not_correct(run_tiny, cell):
    r = run_tiny(cell, control=True)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("fault, failed", [
    ("unchanged_state", "change_gap"), ("half_batch", "grad_gap")])
def test_training_faults_are_not_correct(run_tiny, fault, failed):
    r = run_tiny("style1_ric.train", fault=fault)
    assert not r["correct"]
    c = r["checks"][failed]
    assert c["value"] > c["limit"], r["checks"]


def test_unchanged_state_reads_one(run_tiny):
    """A state left unchanged reads 1 by the norm gap: no leaf moved, and
    the optimizer holds no gradient."""
    r = run_tiny("style1_ric.train", fault="unchanged_state")
    assert r["checks"]["change_gap"]["value"] == pytest.approx(1.0)
    assert r["checks"]["grad_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", SERVE)
def test_altered_answer_is_not_correct(run_tiny, cell):
    r = run_tiny(cell, fault="altered_answer")
    assert not r["correct"]
    c = r["checks"]["rgb_max_lsb"]
    assert c["value"] > c["limit"], r["checks"]
