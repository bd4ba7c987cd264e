"""The run's host facts and its one setting of its own process: binding
its threads to the CPUs near its cards, which narrows the affinity it
was given and never widens it, and is skipped where too few CPUs would
be left."""
import os

import pytest

from benchmark import host


@pytest.mark.parametrize("given, local, threads, want", [
    (set(range(16)), set(range(8, 24)), 4, set(range(8, 16))),
    (set(range(16)), set(range(64)), 4, None),          # all near already
    (set(range(16)), set(range(12, 24)), 8, None),      # 4 left < 10
    (set(range(16)), set(range(6, 16)), 8, set(range(6, 16))),  # 10 left
    (set(range(8)), None, 8, None),                     # locality unknown
    (set(range(8)), set(), 8, None),
])
def test_binding_rule(given, local, threads, want):
    got, why = host.binding_rule(given, local, threads)
    assert got == want, why
    assert got is None or got <= given
    if local and got is None and not given <= local:
        assert f"threads + 2 = {threads + 2}" in why


def test_cpulist_round_trip():
    assert host.cpulist("0-3,8,10-11") == {0, 1, 2, 3, 8, 10, 11}
    assert host.fmt({0, 1, 2, 3, 8, 10, 11}) == "0-3,8,10-11"
    assert host.cpulist(None) is None and host.cpulist("") is None


def test_bind_narrows_every_thread(monkeypatch):
    """With the card near all but one of the run's CPUs, every thread of
    the process is bound to the rest; threads started later inherit it."""
    given = os.sched_getaffinity(0)
    if len(given) < 4:
        pytest.skip("needs 4 CPUs to leave one out")
    near = set(sorted(given)[1:])
    monkeypatch.setattr(host, "card_bus_id", lambda i: "0000:5d:00.0")
    monkeypatch.setattr(host, "card_locality", lambda bus: ("0", near))
    try:
        line = host.bind([0], threads=len(near) - 2)
        assert f"bound to the {len(near)} CPUs" in line
        assert all(os.sched_getaffinity(t) == near for t in host.task_ids())
        restore(given)
        line = host.bind([0], threads=len(near) - 1)
        assert "fewer than threads + 2" in line
        assert all(os.sched_getaffinity(t) == given for t in host.task_ids())
    finally:
        restore(given)


def restore(cpus):
    for t in host.task_ids():
        os.sched_setaffinity(t, cpus)


def test_facts_and_usage_lines():
    assert host.facts().startswith("affinity ")
    u = host.Usage()
    u.start()
    sum(i * i for i in range(10 ** 5))
    lines = u.lines()
    assert lines[0].startswith("host window: ")
    assert lines[1].startswith("host threads ")
