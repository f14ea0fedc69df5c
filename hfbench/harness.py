"""The harness: a cell's files found by name, its set-up, the measured
window, the traced sub-window, the check and the result line.

A run is one process (``hfbench/run.py``). It loads the program's library,
makes the cell's pool of inputs from the seed on the card, warms up the
cell's one shape, then runs a closed loop of one caller for ``seconds``:
each call ends in a synchronise and its output stays on the card. With
``trace`` a steady sub-window of the loop runs under ``torch.profiler``.
After the window the program's last output of every pool entry that a
sample drawn from the seed falls in is compared with the plain reference.
"""

import dataclasses
import importlib
import json
import random
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from . import guard, timeline

ROOT = Path(__file__).resolve().parent.parent
BENCH = Path(__file__).resolve().parent
WARMUP_CALLS = 3
TRACE_SECONDS = 1.5        # about this long, by the warm-up's call time
TRACE_CALLS = (30, 1500)   # and within these many calls
TRACE_SKIP = 10            # calls that the profiler's start-up lands in
PEAKS = BENCH / "peaks.json"
SAMPLE_SALT = 0x5EED


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files read: the
    configuration ``cfg``, the traffic mix ``traffic``, the entry module,
    and the metrics it reports ([{name, unit, ...}])."""
    name: str
    chips: int
    cfg: dict
    traffic: dict
    entry: object
    end_to_end: list
    per_layer: list


def _json(path):
    return json.loads(Path(path).read_text())


def load_cell(workload, root=ROOT):
    """The :class:`Cell` named ``workload`` in ``root/BENCHMARK.json``."""
    man = _json(Path(root) / "BENCHMARK.json")
    ws = [w for w in man["workloads"] if w["name"] == workload]
    if len(ws) != 1:
        raise SystemExit(f"hfbench: no workload {workload!r} in "
                         "BENCHMARK.json")
    w = ws[0]
    conf = next(c for c in man["configs"] if c["name"] == w["config"])
    cfg = _json(Path(root) / conf["file"])
    traffic = _json(BENCH / "traffic" / f"{w['traffic']}.json")
    e2e = [m for m in man["end_to_end"]
           if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in man["per_layer"]
                 if workload in m.get("workloads", [workload])
                 and m["moves"] in names]
    return Cell(workload, w["chips"], cfg, traffic,
                importlib.import_module(f"hfbench.entries.{cfg['entry']}"),
                e2e, per_layer)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def card_state():
    """``nvidia-smi``'s name, power limit, clocks, draw and temperature of
    the card, one line (or why it could not be read)."""
    q = ("name,power.limit,clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu")
    try:
        r = subprocess.run(["nvidia-smi", f"--query-gpu={q}",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"
    return (r.stdout.strip().splitlines() or [r.stderr.strip()])[0]


class _Tracer:
    """``torch.profiler`` over the window's first ``skip + n`` calls.

    The profiler starts before the window (its start-up takes seconds on
    the card); the first ``skip`` traced calls are left out of the
    summary (``timeline.read_chrome``), and it stops after the rest."""

    def __init__(self, device, n):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.device = device
        self.left = n + TRACE_SKIP
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()

    def wrap(self, i, fn):
        if not self.left:
            out = fn()
            _sync(self.device)
            return out
        with torch.profiler.record_function(f"{timeline.CALL_SPAN}#{i}"):
            out = fn()
            _sync(self.device)
        self.left -= 1
        if self.left == 0:
            self.prof.stop()
        return out

    def summary(self):
        """The traced calls' summary (``timeline``)."""
        if self.left:
            self.prof.stop()
            self.left = 0
        tmp = Path(tempfile.mkdtemp(prefix="hfbench-"))
        try:
            path = tmp / "trace.json"
            self.prof.export_chrome_trace(str(path))
            return timeline.read_chrome(path, skip=TRACE_SKIP)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)


def closed_loop(call, order, seconds, sync, wrap=None,
                clock=time.perf_counter):
    """One caller: call ``order[k % len(order)]`` one after another until
    ``seconds`` have passed; each call is timed from its start to the end
    of its synchronise (``wrap(i, fn)``, if given, runs both). Returns
    ([(start, end, entry)], {entry: its last output})."""
    spans, last = [], {}
    start = clock()
    k = 0
    while True:
        i = order[k % len(order)]
        t0 = clock()
        if wrap is None:
            out = call(i)
            sync()
        else:
            out = wrap(i, lambda: call(i))
        t1 = clock()
        last[i] = out
        spans.append((t0, t1, i))
        k += 1
        if t1 - start >= seconds:
            return spans, last


def calls_per_s(spans):
    """Completed calls over the whole window, first start to last end."""
    return len(spans) / (spans[-1][1] - spans[0][0])


def latency_ms(spans, q):
    """The ``q`` quantile (0–1) of the calls' times, ms."""
    d = sorted((t - s) * 1e3 for s, t, _ in spans)
    return d[min(len(d) - 1, int(q * len(d)))]


def sample_rows(seed, entries, B, n, device):
    """{entry: LongTensor of rows}: ``n`` (entry, row) pairs drawn from
    ``seed`` among ``entries`` (those the window called), no repeats."""
    cand = [(i, r) for i in sorted(entries) for r in range(B)]
    pick = random.Random(seed ^ SAMPLE_SALT).sample(cand, min(n, len(cand)))
    rows = {}
    for i, r in sorted(pick):
        rows.setdefault(i, []).append(r)
    return {i: torch.tensor(r, device=device) for i, r in rows.items()}


def _log(msg):
    print(f"hfbench: {msg}", file=sys.stderr, flush=True)


def run(cell, seed, seconds, trace, device, t0, fault=None):
    """One run of ``cell``; returns the result line's object.

    ``t0`` is the process's start on ``time.perf_counter``'s clock.
    ``fault(i, out)``, for the harness's own tests, replaces each output
    as the call produces it.
    """
    cfg, traffic, entry = cell.cfg, cell.traffic, cell.entry
    if traffic["loop"] != "closed" or traffic["callers"] != 1:
        raise ValueError("the harness runs one closed-loop caller")
    nvcc_s = entry.setup(cfg, device)
    pool = entry.make_pool(cfg, traffic, seed, device)
    order = list(range(traffic["pool_calls"]))
    random.Random(seed).shuffle(order)

    def call(i):
        out = entry.call(cfg, pool, i)
        return out if fault is None else fault(i, out)

    warm = []
    for k in range(WARMUP_CALLS):
        a = time.perf_counter()
        call(order[k % len(order)])
        _sync(device)
        warm.append(time.perf_counter() - a)
    est = statistics.median(warm[1:])
    cuda = device.type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    before = entry.counters()
    setup_s = time.perf_counter() - t0
    tracer = None
    if trace:
        tracer = _Tracer(device, int(min(max(TRACE_SECONDS / est,
                                             TRACE_CALLS[0]), TRACE_CALLS[1])))
    spans, last = closed_loop(call, order, seconds, lambda: _sync(device),
                              None if tracer is None else tracer.wrap)
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    after = entry.counters()
    guard.check("after the window")

    _log(f"card: {card_state() if cuda else 'cpu'}")
    _log(f"nvcc {nvcc_s:.3f} s; warm-up calls {[round(w, 6) for w in warm]}"
         f" s; setup {setup_s:.3f} s")
    _log("counters in the window: " + json.dumps(
        {k: {n: after[k][n] - before[k][n] for n in after[k]
             if after[k][n] != before[k][n]} for k in after}))
    _log(f"calls {len(spans)}; call ms p50 {latency_ms(spans, 0.5):.4f}, "
         f"p95 {latency_ms(spans, 0.95):.4f} (host clock, each call alone)")

    e2e = {"calls_per_s": calls_per_s(spans),
           "peak_mem_gib": window_peak / 2 ** 30,
           "setup_s": setup_s}
    dev_info = {"platform": "gpu" if cuda else device.type,
                "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                "count": cell.chips,
                "memory_peak_bytes": max(setup_peak, window_peak)}
    result = {"attempted": len(spans), "failed": 0}
    if trace:
        summary = tracer.summary()
        tracer = None
        _log(f"trace: {len(summary['calls'])} calls, "
             f"{len(summary['device'])} device and {len(summary['host'])} "
             "host events")
        itemsize = torch.empty((), dtype=getattr(torch, cfg["dtype"])
                               ).element_size()
        peaks = _json(PEAKS)
        summary.update(
            work={i: entry.work(cfg, pool, i, itemsize)
                  for i in {c[2] for c in summary["calls"]}},
            program_kernels=entry.PROGRAM_KERNELS,
            peak_ops_per_s=peaks["ops_per_s"][cfg["dtype"]],
            peak_bytes_per_s=peaks["bytes_per_s"])
        metrics = {}
        for m in cell.per_layer:
            v = importlib.import_module(f"hfbench.metrics.{m['name']}").read(
                summary)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if summary["window"] and summary["device"]:
            lo, hi = summary["window"]
            dev_info["busy_s"] = timeline.busy_us(summary) * 1e-6
            dev_info["window_s"] = (hi - lo) * 1e-6
            result["breakdown"] = {"device_ops": timeline.device_ops(summary),
                                   "idle_gaps": timeline.idle_gaps(summary)}
            _log("device ops " + json.dumps(result["breakdown"]["device_ops"]))
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}

    rows = sample_rows(seed, last, traffic["profiles_per_call"],
                       traffic["check_rows"], device)
    keep = {i: last[i] for i in rows}
    del last
    checks, parted = entry.compare(cfg, pool, keep, rows)
    _log(f"compared {sum(len(r) for r in rows.values())} rows; pairs "
         f"escaped on one side only: {parted}")
    correct = all(v <= lim for v, lim in checks.values())
    result.update(correct=correct, metrics=metrics, device=dev_info)
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        _log(f"check {k}: {v!r} (limit {lim!r})")
    return {k: result[k] for k in ("correct", "attempted", "failed",
                                   "metrics", "device", "breakdown", "checks")
            if k in result}
