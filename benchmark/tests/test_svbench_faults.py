"""A run whose timed path is broken underneath comes out not correct: the
harness is driven on the CPU (past its look for a card) with each fault a
cell can have planted in the program.  (There is no exchange between
chips: every cell takes one.)"""
from benchmark.tests.svbench_common import tiny_run


def run_with(target, make):
    """A tiny run with program attribute `target` ("module:attr")
    replaced by make(original) for its length."""
    import importlib
    mod_name, attr = target.split(":")
    mod = importlib.import_module(mod_name)
    orig = getattr(mod, attr)
    setattr(mod, attr, make(orig))
    try:
        return tiny_run()
    finally:
        setattr(mod, attr, orig)


def test_sound_run_is_correct():
    res, lines = tiny_run()
    assert res["correct"], lines


def test_half_of_the_batch_left_out():
    def make(orig):
        def half(wins, **kw):
            return orig(wins[:len(wins) // 2], **kw)
        return half
    res, _ = run_with(
        "svscope_tpu_torch.engine.localgraph:process_window_batch", make)
    assert not res["correct"]
    assert res["failed"] == res["attempted"] // 2


def test_an_answer_altered_where_produced():
    """One base of every consensus changed as the POA returns it."""
    flip = {"A": "C", "C": "G", "G": "T", "T": "A"}

    def make(orig):
        def altered(jobs, **kw):
            out = orig(jobs, **kw)
            return [((flip[c[0]] + c[1:]) if c else c, msa)
                    for c, msa in out]
        return altered
    res, _ = run_with("svscope_tpu_torch.engine.localgraph:poa_msa_batch",
                      make)
    assert not res["correct"]
    assert res["checks"]["rows_differing"]["value"] > 0


def test_a_step_that_returns_its_state_unchanged():
    """The POA's last round leaves each window's graph as it was: the last
    read is never aligned, and its MSA row comes back all gaps."""
    def make(orig):
        def stale(jobs, **kw):
            out = orig([s[:-1] for s in jobs], **kw)
            return [(c, msa + ["-" * len(msa[0])]) for c, msa in out]
        return stale
    res, _ = run_with("svscope_tpu_torch.engine.localgraph:poa_msa_batch",
                      make)
    assert not res["correct"]
    assert res["checks"]["bic_gap"]["value"] > 1e-4
