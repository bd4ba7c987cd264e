"""One run of one cell: set-up (the program's libraries, the batch pool
from the seed, one warm-up call on each batch of the pool), the measured
window of whole process_window_batch calls back to back, then the checks
and the metrics.

The window is a closed loop with one caller, as the CLI's localGraph
stage is: each call is a batch of prepared windows, the next always
another batch of the pool, until `seconds` have passed; the call that
crosses the mark is finished and counted.  With `trace` the window runs
under torch.profiler and the per-layer metrics' spans are recorded."""
from __future__ import annotations

import gc
import os
import sys
import time

from . import check, generator, host, manifest
from .spans import EmCapture, Recorder

FORBIDDEN = ("jax", "jaxlib", "flax", "svscope_tpu")
PROGRAM = "svscope_tpu_torch"
CACHE = os.path.join(manifest.ROOT, ".bench_cache")


def forbidden_modules() -> list[str]:
    """Top-level names in sys.modules that a run must not load, compared
    whole: svscope_tpu_torch is not svscope_tpu."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def program_windows(pool):
    from svscope_tpu_torch.engine.datamaker import WindowData
    import numpy as np
    return [[WindowData(list(w.sequences), np.array(w.read_ids), w.flank_5,
                        w.flank_3, w.record, w.flag) for w in batch]
            for batch in pool]


class Run:
    """What a reader sees: the window's calls, spans, captures, trace.
    `trace_ok` is False where the trace holds another number of the
    program's kernels than its launch counters (records dropped)."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.calls: list = []          # (batch, t0_ns, t1_ns, rows)
        self.rec = Recorder()
        self.trace = None              # devtrace.Reduced
        self.trace_ok = False
        self.counts: dict = {}
        self.first = 0                 # the traced window's first call

    @property
    def windows(self) -> int:
        return sum(len(r) for _b, _a, _z, r in self.calls[self.first:])

    @property
    def call_s(self) -> float:
        return sum(t1 - t0 for _b, t0, t1, _r in self.calls[self.first:]) / 1e9


def _counts():
    from svscope_tpu_torch.ops import poa_batch, poa_fused
    return {"poa_batch": dict(poa_batch.COUNTS),
            "poa_fused": dict(poa_fused.COUNTS)}


def _reset_counts():
    from svscope_tpu_torch.ops import poa_batch, poa_fused
    poa_batch.reset_counts()
    poa_fused.reset_counts()


def read_counter(ref: str) -> int:
    """A launch counter of the program, "module:ATTR" or
    "module:ATTR.key" (a dict's entry)."""
    import importlib
    mod_name, attr = ref.split(":")
    attr, _, key = attr.partition(".")
    val = getattr(importlib.import_module(mod_name), attr)
    return int(val[key] if key else val)


def launches(cfg) -> list[int]:
    """The configuration's launch counters, summed per group of its
    `trace_counts`."""
    return [sum(read_counter(c) for c in g["counters"])
            for g in cfg.get("trace_counts", ())]


def check_trace(run, before: list[int], log) -> bool:
    """Each group's kernels in the trace against the launches its
    counters took over the window; logs both."""
    ok = True
    for g, b, a in zip(run.cfg.get("trace_counts", ()), before,
                       launches(run.cfg)):
        seen = run.trace.count_of(g["trace"])
        log(f"trace count {'/'.join(g['trace'])}: {seen} in the trace, "
            f"{a - b} launched")
        ok &= seen == a - b
    return ok


def cuda_tracer(cards=(0,)):
    """torch.profiler's tracer of the cards."""
    from .devtrace import DeviceTrace
    return DeviceTrace(os.path.join(CACHE, "trace", "trace.json"), cards)


def mesh_of(cfg, dev):
    """The configuration's data mesh (`data_parallel` cards; CUDA's first
    ones, or `dev` repeated off the card), or None where it asks for one
    card: the port's own device tuple, as run_local_graph builds it."""
    n = int(cfg.get("data_parallel", 1))
    if n <= 1:
        return None
    from svscope_tpu_torch.parallel.dataparallel import make_dp_mesh
    mesh = (make_dp_mesh(n_devices=n) if dev.type == "cuda"
            else make_dp_mesh(devices=(dev,) * n))
    if len(mesh) != n:
        raise RuntimeError(f"data_parallel {n} asks for {n} cards, "
                           f"{len(mesh)} found")
    return mesh

class GcClock:
    """Collections of the cyclic garbage collector and their seconds,
    while installed."""

    def __init__(self):
        self.n = [0, 0, 0]
        self.s = 0.0
        self._t = None

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.s += time.perf_counter() - self._t
            self.n[info["generation"]] += 1
            self._t = None


def rss_mb() -> float:
    """The process's resident set, MB (0 where /proc is not there)."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 1e6
    except (OSError, ValueError):
        return 0.0


def cpu_clock() -> tuple:
    """The process's (user, system) CPU seconds so far."""
    t = os.times()
    return t.user, t.system


def keep_rows(recs) -> list:
    """What the judge reads of a call's records: each row as a tuple of
    its fields as text (untracked by the garbage collector)."""
    return [tuple(map(str, x)) if isinstance(x, (list, tuple)) else x
            for x in recs]


def run(cell_name: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", t_start: float | None = None,
        man: dict | None = None, params: dict | None = None,
        limits: dict | None = None, log=print, modes=("ref",),
        tracer=None):
    """The run's result object and its check lines.  `params` and
    `limits` replace the cell's traffic and limits files (tests);
    `modes` adds the control's readings (control.py) under "controls";
    `tracer` makes a traced window's tracer (start(), stop() -> a
    devtrace.Reduced; by default torch.profiler's on the card)."""
    t_start = time.perf_counter() if t_start is None else t_start
    man = man or manifest.load_manifest()
    cell, cfg = manifest.cell_config(man, cell_name)
    params = params or manifest.traffic(cell["traffic"])
    limits = limits or manifest.limits(cell_name)
    import torch
    from svscope_tpu_torch.engine import localgraph
    from svscope_tpu_torch.parallel.dataparallel import data_mesh_installed
    dev = torch.device(device)
    # one card installs no mesh: data_mesh_installed(None) keeps it clear
    mesh = mesh_of(cfg, dev)
    if mesh is not None:
        dev = mesh[0]
    cards = (sorted({d.index or 0 for d in mesh or (dev,)})
             if dev.type == "cuda" else [])
    log("host: " + host.facts() + f", torch threads {torch.get_num_threads()}")
    if dev.type == "cuda":
        log("host: " + host.bind(cards, cfg["threads"]))
    log(f"host: native pool of up to {cfg['threads']} threads a job (the "
        f"caller and {cfg['threads'] - 1} helpers)")
    t_import = time.perf_counter()
    r = Run(cfg)
    pool = generator.make_pool(params, seed)
    prog_pool = program_windows(pool)
    t_pool = time.perf_counter()
    em = EmCapture()
    em.install()
    metrics = manifest.per_layer_for(man, cell_name) if trace else []
    readers = {m["name"]: manifest.metric_module(m["name"]) for m in metrics}
    for mod in readers.values():
        for name, target, keep_io in getattr(mod, "SPANS", ()):
            r.rec.wrap(name, target, keep_io)
    r.rec.on = False

    def call(batch):
        return localgraph.process_window_batch(
            batch, t_label=cfg["t_label"], readcutoff=cfg["readcutoff"],
            hcutoff=cfg["hcutoff"], scutoff=cfg["scutoff"],
            em_dtype=cfg["em_dtype"], device_poa=cfg["device_poa"],
            device=dev, threads=cfg["threads"])

    def window():
        """Whole calls back to back until `seconds` have passed; the call
        that crosses the mark is finished and counted."""
        r.rec.on = True
        w0 = time.perf_counter_ns()
        while True:
            b = len(r.calls) % len(prog_pool)
            em.call = len(r.calls)
            t0 = time.perf_counter_ns()
            recs = call(prog_pool[b])
            t1 = time.perf_counter_ns()
            r.calls.append((b, t0, t1, keep_rows(recs)))
            del recs
            if trace:
                r.rec.spans["process_window_batch"].append((t0, t1, 0))
            if t1 - w0 >= seconds * 1e9:
                break
        r.rec.on = False

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    gclock = GcClock()
    try:
        with data_mesh_installed(mesh):
            # warm-up, part of set-up: every batch the window will send, so
            # the program's buffers and caches have met each batch's shapes
            for batch in prog_pool:
                call(batch)
            sync()
            t_warm = time.perf_counter()
            _reset_counts()
            em.results.clear()
            for c in cards:
                torch.cuda.reset_peak_memory_stats(c)
            if tracer is None and trace and dev.type == "cuda":
                tracer = lambda: cuda_tracer(cards)
            tr = tracer() if trace and tracer is not None else None
            if tr is not None:
                tr.start()
            launched = launches(cfg)
            gc.callbacks.append(gclock)
            rss0, cpu0 = rss_mb(), cpu_clock()
            usage = host.Usage()
            usage.start()
            setup_s = time.perf_counter() - t_start
            window()
            gc.callbacks.remove(gclock)
            rss1, cpu1 = rss_mb(), cpu_clock()
            usage_lines = usage.lines()
            if tr is not None:
                r.trace = tr.stop()
                if not r.trace.complete:
                    # the profiler lost the window's device side: trace a
                    # second window, which alone feeds the per-layer metrics
                    log(f"trace incomplete {r.trace.raw}: tracing a second "
                        f"window of {seconds} s")
                    r.rec.clear()
                    r.first = len(r.calls)
                    _reset_counts()
                    tr = tracer()
                    tr.start()
                    launched = launches(cfg)
                    window()
                    r.trace = tr.stop()
                r.trace_ok = check_trace(r, launched, log)
            r.counts = _counts()
    finally:
        if gclock in gc.callbacks:
            gc.callbacks.remove(gclock)
        r.rec.restore()
        em.restore()
    found = forbidden_modules()
    if found:
        raise ForbiddenImport(found)
    peaks = [torch.cuda.max_memory_allocated(c) for c in cards]
    log(f"setup {setup_s:.3f} s: imports and the host's facts "
        f"{t_import - t_start:.3f}, pool "
        f"{t_pool - t_import:.3f}, warm-up calls ({len(prog_pool)}) "
        f"{t_warm - t_pool:.3f}")
    for i, (b, t0, t1, recs) in enumerate(r.calls):
        log(f"call {i} batch {b} {(t1 - t0) / 1e9:.4f} s {len(recs)} rows")
    h = len(r.calls) // 2
    if h:
        rate = lambda cs: (sum(len(x[3]) for x in cs)
                           / (sum(x[2] - x[1] for x in cs) / 1e9))
        log(f"halves: first {h} calls {rate(r.calls[:h]):.4f} windows/s, "
            f"last {len(r.calls) - h} {rate(r.calls[h:]):.4f}")
    log(f"gc in the window: {gclock.n} collections by generation, "
        f"{gclock.s:.4f} s; rss {rss0:.1f} -> {rss1:.1f} MB")
    du = [b - a for a, b in zip(cpu0, cpu1)]
    log(f"cpu in the window: user {du[0]:.2f} s, system {du[1]:.2f} s")
    for line in usage_lines:
        log(line)
    log("host: " + host.facts())
    log(f"counts {r.counts}")
    if mesh is not None:
        log(f"mesh {[str(d) for d in mesh]}: memory peaks {peaks}"
            + (f", busy s {r.trace.busy_by_card()}" if r.trace else ""))
    if r.trace is not None:
        log(f"trace: raw {r.trace.raw}")
        log(f"trace: opening marker {r.trace.start_lag_us} us after the "
            f"host's mark; {len(r.trace.ops)} device ops")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    verdict = check.judge(r.calls, pool, prog_pool, em.results, cfg, limits,
                          seed, dev, modes=modes)
    log(f"judged in {time.perf_counter() - t_judge:.3f} s")
    em.results.clear()
    result = {"correct": verdict["correct"],
              "attempted": sum(len(pool[b]) for b, *_x in r.calls),
              "failed": verdict["numbers"]["records_missing"]}
    if trace:
        values = {}
        for m in metrics:
            v = readers[m["name"]].read(r)
            if v is not None:
                values[m["name"]] = {"value": v, "unit": m["unit"]}
        result["metrics"] = values
    else:
        result["metrics"] = {
            "windows_per_s": {"value": r.windows / r.call_s,
                              "unit": "windows/s"},
            "setup_s": {"value": setup_s, "unit": "s"}}
    result["device"] = device_info(dev, peaks, r.trace)
    if r.trace is not None:
        result["breakdown"] = {
            "device_ops": r.trace.top_ops(),
            "idle_gaps": r.trace.idle_by_span(r.rec.spans)}
    if verdict["controls"]:
        result["controls"] = verdict["controls"]
    result["checks"] = {k: {"value": verdict["numbers"][k],
                            "limit": verdict["limits"][k]}
                        for k in verdict["limits"]}
    lines = [f"sampled {verdict['sampled']} windows of {result['attempted']},"
             f" {verdict['em_compared']} through the EM"]
    lines += [f"{k} {v['value']} limit {v['limit']}"
              for k, v in result["checks"].items()]
    return result, lines


class ForbiddenImport(RuntimeError):
    def __init__(self, names):
        super().__init__("loaded in the run's process: " + ", ".join(names))
        self.names = names


def device_info(dev, peaks: list, trace) -> dict:
    """The run's cards: their number, the fullest card's memory peak and,
    over several, each card's peak."""
    import torch
    if dev.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": len(peaks), "memory_peak_bytes": int(max(peaks))}
        if len(peaks) > 1:
            info["memory_peak_bytes_per_card"] = [int(p) for p in peaks]
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    if trace is not None:
        info["busy_s"] = trace.busy_s()
        info["window_s"] = trace.window_s
    return info
