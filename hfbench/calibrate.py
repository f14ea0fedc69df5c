"""Readings that the limits of ``correct`` are set from, on the card.

    python3 hfbench/calibrate.py --config vh_o200 --traffic global \
        --seeds 11,12,13 --control-seeds 21,22,23 [--engines auto,parity]

For each seed it makes the cell's pool as a run does, calls the program on
every pool entry that the run's sample of rows falls in, and compares
those rows with the plain reference as a run does, printing one JSON line
per (seed, precision, engine): the numbers compared, and where NaN masks
part, how (which side is NaN, the reference's vh there above the grid's
first altitude, the frequencies). ``--control-seeds`` repeats this with
the program in float32, the control that has to fail. ``--engines``
drives other engines of the batch operator beside the configuration's,
as second witnesses. One process, so the library loads once.
"""

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))

import torch  # noqa: E402

from hfbench import guard, harness  # noqa: E402
from hfbench.reference import vertical_forward as ref  # noqa: E402


def readings(entry, cfg, traffic, seed, dtype, device):
    """One seed's numbers compared, as a run compares them, with the
    program in ``dtype``; where NaN masks part, how they part."""
    pool = entry.make_pool(cfg, traffic, seed, device, dtype=dtype)
    rows = harness.sample_rows(seed, range(traffic["pool_calls"]),
                               traffic["profiles_per_call"],
                               traffic["check_rows"], device)
    t = time.perf_counter()
    outs = {i: entry.call(cfg, pool, i) for i in rows}
    harness._sync(device)
    call_s = time.perf_counter() - t
    t = time.perf_counter()
    checks, parted = entry.compare(cfg, pool, outs, rows)
    ref_s = time.perf_counter() - t
    # how the NaN masks part, if they do
    parts = {"prog_nan_ref_finite": 0, "ref_nan_prog_finite": 0,
             "ref_vh_above_base_km_max": None, "freq_mhz": []}
    mm = 1.0 if cfg["mode"] == "O" else -1.0
    for i, r in rows.items() if parted else ():
        den, bmag, bpsi = pool.ref_calls[i]
        want = ref.vertical_forward(pool.freq64, den, bmag, bpsi,
                                    pool.alt64, mm, cfg["n_points"], rows=r)
        got = outs[i][r].to(torch.float64)
        a = torch.isnan(got) & ~torch.isnan(want)
        b = ~torch.isnan(got) & torch.isnan(want)
        parts["prog_nan_ref_finite"] += int(a.sum())
        parts["ref_nan_prog_finite"] += int(b.sum())
        if a.any():
            up = float((want[a] - pool.alt64.min()).abs().max())
            old = parts["ref_vh_above_base_km_max"]
            parts["ref_vh_above_base_km_max"] = up if old is None else max(
                old, up)
        fi = torch.nonzero(a | b, as_tuple=True)[1].unique()
        parts["freq_mhz"] = sorted(set(parts["freq_mhz"]) | {
            round(float(pool.freq64[k]), 4) for k in fi})
    return {"checks": {k: v for k, (v, _) in checks.items()},
            "rows": sum(len(r) for r in rows.values()),
            "call_s": call_s, "ref_s": ref_s, "nan_parts": parts}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", required=True)
    p.add_argument("--traffic", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--engines", default="")
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    cfg = json.loads((HERE / "configs" / f"{a.config}.json").read_text())
    traffic = json.loads((HERE / "traffic" / f"{a.traffic}.json")
                         .read_text())
    entry = importlib.import_module(f"hfbench.entries.{cfg['entry']}")
    entry.setup(cfg, dev)
    engines = [cfg["engine"]] + [e for e in a.engines.split(",") if e]
    runs = [(s, cfg["dtype"]) for s in a.seeds.split(",") if s]
    runs += [(s, "float32") for s in a.control_seeds.split(",") if s]
    print(f"calibrate: {harness.card_state()}", flush=True)
    for seed, dtype in runs:
        for eng in engines:
            c = dict(cfg, engine=eng)
            r = readings(entry, c, traffic, int(seed), dtype, dev)
            print(json.dumps({"config": a.config, "traffic": a.traffic,
                              "seed": int(seed), "dtype": dtype,
                              "engine": eng, **r}), flush=True)
    guard.check("at the end")
    return 0


if __name__ == "__main__":
    sys.exit(main())
