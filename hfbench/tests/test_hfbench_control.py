"""The control of ``correct``: the program in float32, the nearest
precision below the configuration's float64, has to fail the cell's
limits, and the program in float64 has to pass them.

At a size a CPU test run holds, through the kernel's plain PyTorch
version (``engine="pallas_gather"`` runs it on CPU tensors), with the
comparison a run makes. On the card ``hfbench/calibrate.py`` reads the
same at the cells' own sizes.
"""

import importlib
import json
from pathlib import Path

import pytest
import torch

from hfbench import calibrate

BENCH = Path(__file__).resolve().parents[1]
MAN = json.loads((BENCH.parent / "BENCHMARK.json").read_text())


def _cell(config):
    cfg = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    t = json.loads((BENCH / "traffic" / "single.json").read_text())
    t.update(pool_calls=12, check_rows=12)
    return dict(cfg, engine="pallas_gather"), t


@pytest.mark.parametrize("seed", [2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13])
@pytest.mark.parametrize("config", [c["name"] for c in MAN["configs"]])
def test_float32_fails_and_float64_passes(config, seed):
    cfg, t = _cell(config)
    entry = importlib.import_module(f"hfbench.entries.{cfg['entry']}")
    lim = cfg["limits"]
    r64 = calibrate.readings(entry, cfg, t, seed, "float64",
                             torch.device("cpu"))["checks"]
    r32 = calibrate.readings(entry, cfg, t, seed, "float32",
                             torch.device("cpu"))["checks"]
    assert all(r64[k] <= lim[k] for k in lim), r64
    assert any(r32[k] > lim[k] for k in lim), r32
