"""The import guard: no JAX and no JAX package in a benchmark process."""

import subprocess
import sys
import types
from pathlib import Path

import pytest

from hfbench import guard

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("names,found", [
    (["pyrayhf_tpu_torch", "pyrayhf_tpu_torch.forward", "torch"], []),
    (["jaxtyping", "pyrayhf_tpu_torchvision", "flaxen"], []),
    (["pyrayhf_tpu.forward", "torch"], ["pyrayhf_tpu"]),
    (["jax.numpy", "jaxlib.xla_client", "flax.linen"],
     ["flax", "jax", "jaxlib"]),
])
def test_forbidden_by_whole_top_level_name(names, found):
    assert guard.forbidden_loaded(dict.fromkeys(names)) == found


def _fresh(code):
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)


def test_benchmark_modules_load_neither_jax_nor_the_jax_package():
    """Every module of the harness, with the program's entry called on
    the CPU, in a fresh process."""
    r = _fresh(
        "import json, sys, torch\n"
        "from hfbench import harness, calibrate, timeline, inputs\n"
        "from hfbench.entries import vertical_forward as e\n"
        "from hfbench.metrics import (host_ms_per_call, prep_device_ms,\n"
        "    prep_kernels_per_call, operator_roofline, device_idle_pct)\n"
        "cfg = json.load(open('hfbench/configs/vh_o200.json'))\n"
        "t = dict(json.load(open('hfbench/traffic/single.json')),\n"
        "         pool_calls=2)\n"
        "pool = e.make_pool(cfg, t, 1, torch.device('cpu'))\n"
        "e.call(cfg, pool, 0)\n"
        "from hfbench import guard\n"
        "print(guard.forbidden_loaded(),\n"
        "      'pyrayhf_tpu_torch' in sys.modules)\n")
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["[]", "True"]


def test_reference_imports_nothing_of_the_program():
    r = _fresh("import sys\n"
               "from hfbench.reference import vertical_forward\n"
               "print(sorted({m.split('.')[0] for m in sys.modules}\n"
               "      & {'jax', 'jaxlib', 'pyrayhf_tpu',\n"
               "         'pyrayhf_tpu_torch'}))\n")
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


# A run whose harness loads JAX after the window, as a per-layer metric's
# reader or the comparison could: the card is faked present and the
# harness's run returns a finished result.
_LOADED_AFTER_THE_WINDOW = (
    "import torch, types\n"
    "from hfbench import harness\n"
    "torch.cuda.is_available = lambda: True\n"
    "torch.cuda.device_count = lambda: 1\n"
    "def run(*a, **k):\n"
    "    sys.modules['jax'] = types.ModuleType('jax')\n"
    "    return {'correct': True}\n"
    "harness.run = run\n")


@pytest.mark.parametrize("when,setup", [
    ("at the start", "sys.modules['jax'] = types.ModuleType('jax')\n"),
    ("before the result", _LOADED_AFTER_THE_WINDOW),
], ids=["at_the_start", "after_the_window"])
def test_run_exits_without_a_result_when_jax_is_loaded(when, setup):
    r = _fresh("import runpy, sys, types\n"
               "sys.path.insert(0, '.')\n"
               + setup +
               "sys.argv = ['run.py', '--workload', 'vh_o200.single',\n"
               "            '--seed', '1', '--seconds', '1']\n"
               "runpy.run_path('hfbench/run.py', run_name='__main__')\n")
    assert r.returncode == 3
    assert r.stdout == ""
    assert f"forbidden modules loaded {when}: jax" in r.stderr


def test_guard_check_names_what_it_found(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "pyrayhf_tpu",
                        types.ModuleType("pyrayhf_tpu"))
    with pytest.raises(SystemExit) as e:
        guard.check("in a test")
    assert e.value.code == 3
    assert "pyrayhf_tpu" in capsys.readouterr().err
