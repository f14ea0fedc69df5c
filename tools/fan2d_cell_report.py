"""Where the time of one ``fan2d_cart.link1500`` call goes, on the card.

    python3 tools/fan2d_cell_report.py --seed 5 [--calls 6]

Makes the cell's pool from the seed, then prints one JSON line per part:

* ``call``: the whole entry call, f64, host clock around a synchronised
  call (median of ``--calls``);
* ``split``: the device time a traced call of the operations launched in
  each of the program's spans (``pyrayhf.fan_fields``, ``fan_pack``,
  ``fan_launch``, ``homing``), the device-busy time, and the host reads;
* ``reference_s``: the plain reference's seconds for 2 slices (a run's
  check) and for the whole pool (a traced run's work);
* ``kernel``: ``launch_fan`` alone on the pool entry's tables, f64 and
  f32, CUDA events (``profiling.time_launch``), with the kernel's
  ``steps_taken`` (max, mean) beside the reference's.

It needs a CUDA card.
"""

import argparse
import json
import shutil
import statistics
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from hfbench import harness, oblique_spans, timeline  # noqa: E402


def _split(entry, cfg, pool, n):
    """Device ms a call launched in each span, from a profiled run of
    ``n`` calls (the first left out)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for k in range(n + 1):
            with torch.profiler.record_function(f"{timeline.CALL_SPAN}#{k}"):
                entry.call(cfg, pool, k % len(pool.calls))
                torch.cuda.synchronize()
    tmp = Path(tempfile.mkdtemp(prefix="fan2d-report-"))
    try:
        path = tmp / "trace.json"
        prof.export_chrome_trace(str(path))
        s = timeline.read_chrome(path, skip=1)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out = {name: oblique_spans.device_ms(s, name)
           for name in ("fan_fields", "fan_pack", "fan_launch", "homing")}
    out["busy_ms"] = timeline.busy_us(s) / len(s["calls"]) * 1e-3
    out["host_reads"] = oblique_spans.mean_count_inside(s, "host_read")
    out["device_ops"] = timeline.device_ops(s, top=12)
    return out


def _kernel(entry, cfg, pool, i, dtype):
    """``launch_fan`` alone on pool entry ``i``'s tables in ``dtype``."""
    from pyrayhf_tpu_torch import absorption, oblique, profiling
    from pyrayhf_tpu_torch import pallas_ray as pr
    dev = torch.device("cuda")
    kw = dict(dtype=dtype, device=dev)
    den, bmag, bpsi = (a.to(dtype) for a in pool.ref_calls[i])
    nu = absorption.collision_frequency(pool.z_km, device="cpu").to(**kw)
    flds = oblique._fan_fields(torch.as_tensor(pool.f0s_hz, **kw), den,
                               bmag, bpsi, nu, cfg["mode"])
    geo = pr.fan_geometry(pool.z_km, pool.x_km, cfg["geometry"])
    tab = pr.pack_tables(geo, *flds)
    e = cfg["elev_deg"]
    elevs = oblique._linspace(torch.tensor(e["first"], **kw),
                              torch.tensor(e["last"], **kw), e["count"])
    ds = torch.tensor(cfg["step_km"], **kw)
    n = entry.n_steps(cfg)
    ms, runs = profiling.time_launch(
        lambda: pr.launch_fan(geo, tab, elevs, ds, n_steps=n), iters=10)
    steps = pr.launch_fan(geo, tab, elevs, ds, n_steps=n)["steps_taken"]
    return {"dtype": str(dtype), "path": pr.fan_path(geo, dtype),
            "median_ms": ms, "ms": runs,
            "steps_max": float(steps.max()), "steps_mean": float(
                steps.double().mean())}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--calls", type=int, default=6)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("fan2d_cell_report: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    cell = harness.load_cell("fan2d_cart.link1500")
    cfg, entry = cell.cfg, cell.entry
    entry.setup(cfg, dev)
    print(json.dumps({"card": harness.card_state()}), flush=True)
    pool = entry.make_pool(cfg, cell.traffic, a.seed, dev)
    entry.call(cfg, pool, 0)
    torch.cuda.synchronize()
    wall = []
    for k in range(a.calls):
        t = time.perf_counter()
        entry.call(cfg, pool, k % len(pool.calls))
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t) * 1e3)
    print(json.dumps({"call": {"median_ms": statistics.median(wall),
                               "ms": wall,
                               "peak_gib": torch.cuda.max_memory_allocated()
                               / 2 ** 30}}), flush=True)
    print(json.dumps({"split": _split(entry, cfg, pool, a.calls)}),
          flush=True)
    ref_s = {}
    for n in (2, len(pool.calls)):
        pool.ref_out.clear()
        t = time.perf_counter()
        entry.reference(cfg, pool, range(n))
        torch.cuda.synchronize()
        ref_s[n] = time.perf_counter() - t
    print(json.dumps({"reference_s": ref_s}), flush=True)
    rs = pool.ref_out[0]["steps_taken"].double()
    for dtype in (torch.float64, torch.float32):
        k = _kernel(entry, cfg, pool, 0, dtype)
        k.update(ref_steps_max=float(rs.max()), ref_steps_mean=float(
            rs.mean()))
        print(json.dumps({"kernel": k}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
