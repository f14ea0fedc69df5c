"""PyTorch port: state carry-across, IO, config, import isolation, timer."""

import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import pyrayhf_tpu.config as JC
import pyrayhf_tpu.io as JIO
import pyrayhf_tpu_torch.config as TC
import pyrayhf_tpu_torch.io as TIO
from pyrayhf_tpu_torch import profiling

from _torch_threads import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent


def _profile_dict():
    rng = np.random.default_rng(4)
    alt = np.linspace(80.0, 699.0, 620)
    return {"den": rng.uniform(0.0, 3e12, 620),
            "bmag": np.full(620, 3.1e-5), "bpsi": np.full(620, 62.0),
            "alt": alt, "lat": 42.6, "label": "synthetic"}


def test_profiles_to_torch_round_trips_arrays_and_config():
    inp = _profile_dict()
    cfg = JC.OperatorConfig(mode="X", n_points=20000, sharpness=9.0)
    out = TIO.profiles_to_torch(inp, device="cpu", dtype=torch.float64,
                                config=cfg)
    for k in TIO.PROFILE_KEYS:
        assert out[k].dtype == torch.float64
        assert np.array_equal(out[k].numpy(), inp[k])
    assert out["lat"] == inp["lat"] and out["label"] == inp["label"]
    assert isinstance(out["config"], TC.OperatorConfig)
    assert dataclasses.asdict(out["config"]) == dataclasses.asdict(cfg)
    f32 = TIO.profiles_to_torch(inp, device="cpu", dtype=torch.float32)
    assert f32["den"].dtype == torch.float32 and "config" not in f32
    assert np.array_equal(f32["alt"].numpy(), inp["alt"].astype(np.float32))
    with pytest.raises(KeyError, match="bpsi"):
        TIO.profiles_to_torch({k: v for k, v in inp.items() if k != "bpsi"})


def test_pickle_files_interchange_with_jax_package(tmp_path):
    inp = _profile_dict()
    TIO.save_to_file(inp, tmp_path / "a.p")
    JIO.save_to_file(inp, tmp_path / "b.p")
    assert (tmp_path / "a.p").read_bytes() == (tmp_path / "b.p").read_bytes()
    back = JIO.load_input(tmp_path / "a.p")
    assert np.array_equal(back["den"], inp["den"])
    assert TIO.load_input(tmp_path / "b.p")["label"] == "synthetic"


def test_operator_config_copy_matches_jax():
    jf = {(f.name, f.default) for f in dataclasses.fields(JC.OperatorConfig)}
    tf = {(f.name, f.default) for f in dataclasses.fields(TC.OperatorConfig)}
    assert jf == tf
    cfg = TC.OperatorConfig(mode="X")
    assert TC.resolve(cfg, "mode", None, "O") == "X"
    assert TC.resolve(cfg, "mode", "O", "O") == "O"
    assert TC.resolve(None, "n_points", None, 200) == 200
    assert TC.resolve(cfg, "p_chunk", None, TC.UNSET) is None


def test_import_does_not_pull_in_jax():
    """The port imports torch and numpy, never jax nor pyrayhf_tpu."""
    code = ("import sys, pyrayhf_tpu_torch, pyrayhf_tpu_torch.cuda_ext, "
            "pyrayhf_tpu_torch.profiling, pyrayhf_tpu_torch.fields, "
            "pyrayhf_tpu_torch.absorption, pyrayhf_tpu_torch.ground, "
            "pyrayhf_tpu_torch.gradient, pyrayhf_tpu_torch.pallas_ray, "
            "pyrayhf_tpu_torch.oblique\n"
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'pyrayhf_tpu.'))"
            " or m == 'pyrayhf_tpu']\n"
            "assert not bad, bad\nprint('clean')")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "clean" in r.stdout


def test_time_launch_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        profiling.time_launch(lambda: None)
    assert profiling.vh_evals_per_s(1024, 175, 1.0) == pytest.approx(
        1024 * 175 * 1e3)
