"""The host a run lands on, read from /proc and /sys without changing
anything, and the one setting a run makes of its own process: its
threads bound to the CPUs near its cards, as multi-socket GPU servers are
run.  The binding intersects the affinity the run was given and never
widens it; it is skipped where too few CPUs would be left for the
program's `threads` and its two Python threads (the caller and the
stage-A worker).  Every reading degrades to None where a file is not
there."""
from __future__ import annotations

import os
import resource
import statistics

TICK_S = 1.0 / (os.sysconf("SC_CLK_TCK") or 100)


def read(path: str) -> str | None:
    try:
        with open(path) as f:
            return f.read().strip()
    except OSError:
        return None


def cpulist(text: str | None) -> set[int] | None:
    """The CPUs of a kernel cpulist ("0-3,8,10-11"); None where unread."""
    if not text:
        return None
    cpus: set[int] = set()
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        cpus.update(range(int(lo), int(hi or lo) + 1))
    return cpus


def fmt(cpus) -> str:
    """A cpulist of `cpus` ("-" where None)."""
    if cpus is None:
        return "-"
    out, run = [], []
    for c in sorted(cpus):
        if run and c == run[-1] + 1:
            run.append(c)
            continue
        if run:
            out.append(f"{run[0]}-{run[-1]}" if len(run) > 1 else str(run[0]))
        run = [c]
    if run:
        out.append(f"{run[0]}-{run[-1]}" if len(run) > 1 else str(run[0]))
    return ",".join(out)


def card_bus_id(index: int) -> str | None:
    """The PCI address of CUDA device `index` as sysfs names it."""
    import torch
    p = torch.cuda.get_device_properties(index)
    try:
        return (f"{p.pci_domain_id:04x}:{p.pci_bus_id:02x}:"
                f"{p.pci_device_id:02x}.0")
    except AttributeError:
        return None


def card_locality(bus_id: str | None) -> tuple[str | None, set | None]:
    """(NUMA node, local CPUs) of a PCI device, from sysfs."""
    if bus_id is None:
        return None, None
    base = f"/sys/bus/pci/devices/{bus_id}/"
    return read(base + "numa_node"), cpulist(read(base + "local_cpulist"))


def binding_rule(given: set, local: set | None, threads: int):
    """(cpus, why): the CPUs to bind the run to, None to leave it as it
    is, and why.  `cpus` is always a subset of `given`."""
    if not local:
        return None, "the cards' local CPUs are unknown"
    want = given & local
    if want == given:
        return None, f"all {len(given)} CPUs of the run lie near its cards"
    if len(want) < threads + 2:
        return None, (f"only {len(want)} of the run's {len(given)} CPUs lie "
                      f"near its cards, fewer than threads + 2 = "
                      f"{threads + 2}")
    return want, (f"bound to the {len(want)} CPUs near its cards, of the "
                  f"{len(given)} given")


def task_ids() -> list[int]:
    try:
        return sorted(int(t) for t in os.listdir("/proc/self/task"))
    except OSError:
        return []


def bind(cards: list[int], threads: int) -> str:
    """Bind every thread of this process to the CPUs near `cards` by the
    rule above (threads started later inherit it); returns what was
    done, with the facts it rests on."""
    given = os.sched_getaffinity(0)
    facts, local = [], set()
    for i in cards:
        bus = card_bus_id(i)
        node, cpus = card_locality(bus)
        facts.append(f"card {i} {bus or '-'} numa {node} local {fmt(cpus)}")
        local = None if cpus is None or local is None else local | cpus
    want, why = binding_rule(given, local, threads)
    if want is not None:
        for tid in task_ids():
            try:
                os.sched_setaffinity(tid, want)
            except OSError:        # a thread that ended meanwhile
                pass
    return "; ".join(facts) + f"; binding: {why}"


def facts() -> str:
    """One line: affinity, online CPUs, load, MHz of the affinity's CPUs,
    the process's threads."""
    aff = os.sched_getaffinity(0)
    mhz = []
    cpu = None
    for line in (read("/proc/cpuinfo") or "").splitlines():
        key, _, val = line.partition(":")
        key = key.strip()
        if key == "processor":
            cpu = int(val)
        elif key == "cpu MHz" and cpu in aff:
            mhz.append(float(val))
    mhz_s = (f"{min(mhz):.1f}/{statistics.median(mhz):.1f}/{max(mhz):.1f}"
             if mhz else "-")
    return (f"affinity {fmt(aff)} ({len(aff)} CPUs), online "
            f"{read('/sys/devices/system/cpu/online') or '-'}, load "
            f"{' '.join((read('/proc/loadavg') or '-').split()[:3])}, MHz "
            f"min/median/max {mhz_s}, threads {len(task_ids())}")


class Usage:
    """The process's threads and the host's CPUs over an interval:
    `start()`, then `lines()` with each thread's CPU time, runqueue wait
    and the CPU it last ran on, and the steal and idle time of the CPUs
    in the run's affinity."""

    def start(self) -> None:
        self.t0 = self._threads()
        self.cpu0 = self._cpus()
        self.ru0 = resource.getrusage(resource.RUSAGE_SELF)

    @staticmethod
    def _threads() -> dict:
        out = {}
        for tid in task_ids():
            base = f"/proc/self/task/{tid}/"
            stat, sched = read(base + "stat"), read(base + "schedstat")
            if stat is None:
                continue
            comm = stat[stat.find("(") + 1:stat.rfind(")")]
            rest = stat[stat.rfind(")") + 2:].split()
            try:
                cpu_s = (int(rest[11]) + int(rest[12])) * TICK_S
                last = int(rest[36]) if len(rest) > 36 else -1
                run_ns, wait_ns = (int(x) for x in sched.split()[:2]) \
                    if sched else (0, 0)
            except (IndexError, ValueError):
                continue
            out[tid] = (comm, cpu_s, run_ns / 1e9, wait_ns / 1e9, last)
        return out

    @staticmethod
    def _cpus() -> dict:
        out = {}
        for line in (read("/proc/stat") or "").splitlines():
            f = line.split()
            if f and f[0].startswith("cpu") and f[0] != "cpu":
                ticks = [int(x) for x in f[1:]]
                out[int(f[0][3:])] = (ticks[3] + ticks[4],
                                      ticks[7] if len(ticks) > 7 else 0,
                                      sum(ticks[:8]))
        return out

    def lines(self, top: int = 12) -> list[str]:
        t1, cpu1 = self._threads(), self._cpus()
        ru1 = resource.getrusage(resource.RUSAGE_SELF)
        rows = []
        for tid, (comm, cpu_s, run_s, wait_s, last) in t1.items():
            _c, c0, r0, w0, _l = self.t0.get(tid, (comm, 0.0, 0.0, 0.0, 0))
            rows.append((cpu_s - c0, wait_s - w0, run_s - r0, tid, comm,
                         last))
        rows.sort(reverse=True)
        aff = os.sched_getaffinity(0)
        idle = steal = tot = 0
        for c in aff:
            if c in cpu1 and c in self.cpu0:
                idle += cpu1[c][0] - self.cpu0[c][0]
                steal += cpu1[c][1] - self.cpu0[c][1]
                tot += cpu1[c][2] - self.cpu0[c][2]
        share = lambda x: 100.0 * x / tot if tot else 0.0
        out = [f"host window: {len(t1)} threads, run "
               f"{sum(r[2] for r in rows):.2f} s, runqueue wait "
               f"{sum(r[1] for r in rows):.2f} s; affinity CPUs idle "
               f"{share(idle):.1f} %, steal {share(steal):.2f} % of "
               f"{tot * TICK_S:.1f} CPU-s; switches voluntary "
               f"{ru1.ru_nvcsw - self.ru0.ru_nvcsw}, involuntary "
               f"{ru1.ru_nivcsw - self.ru0.ru_nivcsw}; "
               f"last CPUs {fmt({r[5] for r in rows})}"]
        out.append("host threads (tid comm cpu_s wait_s last_cpu): "
                   + ", ".join(f"{tid} {comm} {c:.2f} {w:.2f} {last}"
                               for c, w, _r, tid, comm, last in rows[:top]))
        return out
