"""The control comes out not correct: the plain reference put in the
program's place in bfloat16, one precision below the configuration's
float32, read through the same comparisons at a size a test run holds
(the readings that set the limits are the card's, at the cells' own
sizes: ``portbench/control.py``)."""
import pytest

from portbench import control
from portbench.harness import check, spec

from .conftest import SMALL


@pytest.mark.parametrize("name", ["mm-rwm-n1e5", "methanation-rwm-n1000",
                                  "methanation-mala-n1000"])
def test_the_control_fails_and_the_program_does_not(name):
    limits = spec.cell(name)["traffic"]["check"]["limits"]
    got = control.readings(name, 24680135791, 1.0, "cpu", SMALL[name])
    prog, ctl = got["program"], got["control"]
    assert not check.verdict(ctl, limits)
    ll = "ll_gap_q" if "ll_gap_q" in limits else "ll_gap"
    assert prog[ll] < limits[ll]
    for k in (ll, "ess_gap", "logz_gap", "post_ll_ks", "grad_gap_q"):
        if k in limits:
            assert ctl[k] > 3 * prog[k], (k, prog, ctl)
