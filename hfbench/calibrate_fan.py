"""Readings that the limits of the oblique cells' ``correct`` are set
from, on the card.

    python3 hfbench/calibrate_fan.py --config fan2d_cart --traffic link1500 \
        --seeds 11,12,13 --control-seeds 21,22,23

For each seed it makes the cell's pool as a run does, calls the program on
every pool entry that the run's sample of rows falls in, and compares
them with the plain reference as a run does, printing one JSON line per
(seed, precision): the numbers compared, the rays landed on one side
only, and where each widest gap lies (frequency, elevation, both sides'
values). ``--control-seeds`` repeats this with the program in float32,
the control that has to fail. One process, so the library loads once.
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


def _widest(got, want, gap):
    """Where ``gap`` [S, A, B] is widest: its index and both values."""
    k = int(torch.argmax(torch.nan_to_num(gap, nan=-1.0)))
    idx = list(torch.unravel_index(torch.tensor(k), gap.shape))
    return {"at": [int(i) for i in idx],
            "program": float(got.reshape(-1)[k]),
            "reference": float(want.reshape(-1)[k])}


def readings(entry, cfg, traffic, seed, dtype, device):
    """One seed's numbers compared, as a run compares them, with the
    program in ``dtype``, and where the widest gaps lie."""
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
    harness._sync(device)
    ref_s = time.perf_counter() - t
    idx = sorted(rows)
    want = entry.reference(cfg, pool, idx)
    rg = torch.stack([outs[i]["fan_range_km"] for i in idx]).double()
    rw = torch.stack([want[i]["ground_range_km"] for i in idx])
    dg = torch.stack([torch.stack([outs[i]["delay_low_sec"],
                                   outs[i]["delay_high_sec"]])
                      for i in idx]).double()
    dw = torch.stack([torch.stack([want[i]["delay_low_sec"],
                                   want[i]["delay_high_sec"]])
                      for i in idx])
    steps = torch.stack([want[i]["steps_taken"] for i in idx]).double()
    return {"checks": {k: v for k, (v, _) in checks.items()},
            "parted": parted, "entries": idx,
            "landed": int(torch.isfinite(rw).sum()),
            "homed": int(torch.isfinite(dw).sum()),
            "homed_program": int(torch.isfinite(dg).sum()),
            "widest_range": _widest(rg, rw, entry._gap(rg, rw)),
            "widest_delay": _widest(dg, dw, entry._gap(dg, dw)),
            "ref_steps_max": int(steps.max()),
            "ref_steps_mean": float(steps.mean()),
            "call_s": call_s, "ref_s": ref_s}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", required=True)
    p.add_argument("--traffic", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate_fan: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    cfg = json.loads((HERE / "configs" / f"{a.config}.json").read_text())
    traffic = json.loads((HERE / "traffic" / f"{a.traffic}.json")
                         .read_text())
    entry = importlib.import_module(f"hfbench.entries.{cfg['entry']}")
    entry.setup(cfg, dev)
    runs = [(s, cfg["dtype"]) for s in a.seeds.split(",") if s]
    runs += [(s, "float32") for s in a.control_seeds.split(",") if s]
    print(f"calibrate_fan: {harness.card_state()}", flush=True)
    for seed, dtype in runs:
        r = readings(entry, cfg, traffic, int(seed), dtype, dev)
        print(json.dumps({"config": a.config, "traffic": a.traffic,
                          "seed": int(seed), "dtype": dtype, **r}),
              flush=True)
    guard.check("at the end")
    return 0


if __name__ == "__main__":
    sys.exit(main())
