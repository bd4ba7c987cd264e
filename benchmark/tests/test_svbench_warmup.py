"""The warm-up: set-up calls the program once on each batch of the pool,
in the pool's order, before the window's first call, so no batch is
first met inside the window."""
from benchmark.tests.svbench_common import TINY, tiny_run


def test_every_batch_warmed_before_the_window(monkeypatch):
    from svscope_tpu_torch.engine import localgraph
    seen = []
    orig = localgraph.process_window_batch

    def spy(wins, **kw):
        seen.append(tuple(w.record for w in wins))
        return orig(wins, **kw)
    monkeypatch.setattr(localgraph, "process_window_batch", spy)
    lines = []
    res, checks = tiny_run(log=lines.append)
    assert res["correct"], checks
    n = TINY["pool_calls"]
    window = [s for s in lines if s.startswith("call ")]
    assert window and len(seen) == n + len(window)
    warm, timed = seen[:n], seen[n:]
    assert len(set(warm)) == n               # each batch once
    assert timed == [warm[i % n] for i in range(len(timed))]  # same cycle
    assert any("warm-up calls (2)" in s for s in lines)
