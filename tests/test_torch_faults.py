"""The port's fault-injection harness (``paddle_tpu_torch/testing/
faults.py``, a copy of the reference's) on the CPU: the reference's pure
harness tests (``test_faults.py``: spec parsing, arming, glob matching,
the environment spec), each run over the reference's module and over the
port's copy — the two cases of the ``faults`` fixture.  The injector is
process-global in each package, so both are reset around every test.
"""
import pytest

from paddle_tpu.testing import faults as ref_faults

from paddle_tpu_torch.testing import faults as port_faults
from paddle_tpu_torch.testing.threads import \
    one_intra_op_thread  # noqa: F401  (autouse)


@pytest.fixture(params=["reference", "port"])
def faults(request):
    for m in (ref_faults, port_faults):
        m.reset()
    yield ref_faults if request.param == "reference" else port_faults
    for m in (ref_faults, port_faults):
        m.reset()


def test_rule_parse_and_defaults(faults):
    FaultRule = faults.FaultRule
    r = FaultRule.parse("ioerror:ckpt.write:after=3:times=2")
    assert (r.mode, r.site, r.after, r.times) == \
        ("ioerror", "ckpt.write", 3, 2)
    assert FaultRule.parse("kill:io.*").times == 1     # kill fires once
    assert FaultRule.parse("delay:x:ms=250").ms == 250.0
    assert FaultRule.parse("hang:x").ms == 3.6e6       # default: forever
    assert FaultRule.parse("hang:x:ms=100").ms == 100.0  # explicit wins
    with pytest.raises(ValueError):
        FaultRule.parse("explode:everything")
    with pytest.raises(ValueError):
        FaultRule.parse("ioerror")                     # no site
    with pytest.raises(ValueError):
        FaultRule.parse("ioerror:x:frequency=2")       # unknown key


def test_after_and_times_counting(faults):
    inj = faults.FaultInjector("ioerror:site.a:after=2:times=1")
    inj.hit("site.a")                    # 1st hit: below 'after'
    with pytest.raises(faults.FaultError):
        inj.hit("site.a")                # 2nd: armed, fires
    inj.hit("site.a")                    # 3rd: 'times' exhausted
    assert inj.log == ["ioerror:site.a"]


def test_glob_matching_and_inert_by_default(faults):
    inj = faults.FaultInjector("ioerror:ckpt.*")
    inj.hit("io.save")                   # no match: silent
    with pytest.raises(faults.FaultError):
        inj.hit("ckpt.commit")
    # no spec installed anywhere: fault_point is a no-op
    faults.fault_point("ckpt.commit")


def test_env_spec_picked_up(faults, monkeypatch):
    monkeypatch.setenv(faults.ENV_VAR, "ioerror:env.site")
    faults.reset()
    with pytest.raises(faults.FaultError):
        faults.fault_point("env.site")
