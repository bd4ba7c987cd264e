"""The fused build's probes on the CPU (plain K3 and K4) at their smallest
sizes: pk_phase_probe's replays reproduce the build's rounds, fused_probe's
MSAs equal the host engine's."""
import pytest
import torch

from svscope_tpu_torch.tools.probe import fused_probe, pk_phase_probe

torch.set_num_threads(1)


def test_pk_phase_probe_replays_the_build():
    """The threaded replay equals every recorded round (checked inside
    run, which raises otherwise); each phase timed; the phase costs are
    the fastest gAB replay's spans (K6, K3, fusion) and its rest, each
    positive, summing to that replay."""
    res = pk_phase_probe.run(b=2, reads=3, reps=1, device="cpu",
                             log=lambda *_: None)
    assert res["rounds"] == 4 and res["ncap"] == 1025
    assert set(res["replay_ms"]) == set(pk_phase_probe.PHASES)
    assert all(v > 0 for v in res["replay_ms"].values())
    assert res["counts"]["rounds"] == 4
    costs = res["phase_ms"]
    assert all(costs[k] > 0 for k in ("glue", "K6", "K3", "fusion"))
    assert sum(costs.values()) == pytest.approx(res["replay_ms"]["gAB"])
    assert res["diff_ms"] == {"K3": None, "fusion": None}   # one turn


def test_pk_phase_differences_resolve_only_above_the_spread():
    assert pk_phase_probe.resolved([10.0, 11.0], [15.0, 15.5]) == 5.0
    assert pk_phase_probe.resolved([10.0, 14.0], [12.0, 13.0]) is None
    assert pk_phase_probe.resolved([10.0, 11.0], [9.0, 9.5]) is None
    assert pk_phase_probe.resolved([10.0], [20.0]) is None


def test_fused_probe_equals_host():
    res = fused_probe.run(windows=1, trials=1, device="cpu",
                          log=lambda *_: None)
    assert res["identical"] == 1
