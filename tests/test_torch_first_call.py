"""PyTorch port: a CPU result is a function of its inputs, whatever ran
before it in the process.

Earlier runs saw the first call of the port's plain X gather made right
after the JAX package's interpret-mode gather, in a fresh process, part
from the later calls (9e-9 km, once 1e-6 km). This test recreates that
state in a child process: the JAX interpret-mode X gather on
``tests/test_torch_pallas_vh.py``'s ``_workload(B=16)`` (the
reproduction's inputs), then, as the process's first torch work, every
plain version the tests hold against JAX (the O, X and host-solve
gathers, the sweep, the mxu plain version, the plain fan), twice at 4
threads, then at 1 and 3. A second child that never imports JAX computes
the same. Every output must be equal bit for bit across calls, thread
counts and the two processes, and the JAX computation must leave the SSE
control word (rounding mode, flush-to-zero, denormals-are-zero) as it
found it.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[1]

CHILD = r'''
import ctypes, json, sys
import numpy as np
sys.path.insert(0, sys.argv[1])
out_path, with_jax = sys.argv[2], sys.argv[3] == "1"


def mxcsr():
    env = (ctypes.c_uint32 * 8)()
    ctypes.CDLL("libm.so.6").fegetenv(ctypes.byref(env))
    return int(env[7]) & 0xFFC0          # control bits, not the sticky flags


def workload(B=16, n_alt=180):
    alt = np.linspace(90.0, 550.0, n_alt)
    rng = np.random.default_rng(3)
    hms = rng.uniform(250.0, 330.0, B)
    peaks = rng.uniform(1e12, 3e12, B)
    den = peaks[:, None] * np.exp(-(alt[None, :] - hms[:, None]) ** 2
                                  / (2 * 55.0 ** 2))
    return (np.arange(1.0, 16.0, 0.5), den, np.full((B, n_alt), 3.2e-5),
            np.full((B, n_alt), 65.0), alt)


args = workload()
report = {"mxcsr_before": mxcsr()}
if with_jax:
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import pyrayhf_tpu.pallas_vh as JV
    np.asarray(JV.ionogram_pallas_gather(
        *[jnp.asarray(a) for a in args], mode_mult=-1.0, n_points=200,
        interpret=True))
report["mxcsr_after"] = mxcsr()

import torch
import pyrayhf_tpu_torch.pallas_ray as TR
import pyrayhf_tpu_torch.pallas_vh as TV

z, x = np.linspace(0.0, 400.0, 41), np.linspace(0.0, 1000.0, 11)
mu = 0.95 - 0.5 * np.exp(-(z[:, None] - 250.0) ** 2 / 2e3) * (1.0 + 0.1
                                                              * x / 1e3)
fan_in = [torch.from_numpy(np.stack([mu, mu ** 0.5]))]
fan_in += [1.0 / fan_in[0], torch.zeros_like(fan_in[0]) + 1e-4]


def run():
    t = [torch.from_numpy(np.asarray(a)) for a in args]
    kw = dict(n_points=200)
    fan = TR.fan_2d_pallas(z, x, *fan_in, torch.linspace(5.0, 60.0, 8,
                           dtype=torch.float64), 10.0, n_steps=80)
    return {
        "gather_X": TV.ionogram_pallas_gather(*t, mode_mult=-1.0, **kw),
        "gather_O": TV.ionogram_pallas_gather(*t, mode_mult=1.0, **kw),
        "gather_host_X": TV.ionogram_pallas_gather(
            *t, mode_mult=-1.0, x_in_kernel_solve=False, **kw),
        "sweep_X": TV.ionogram_fast_xla(*t, mode_mult=-1.0, **kw),
        "sweep_O": TV.ionogram_fast_xla(*t, mode_mult=1.0, **kw),
        "mxu_O": TV.ionogram_pallas_mxu(*t, mode_mult=1.0, **kw),
        "fan": torch.stack([fan[k] for k in TR.OUTPUTS]),
    }


calls = {"first": run(), "second": run()}
default = torch.get_num_threads()
for n in (1, 3):
    torch.set_num_threads(n)
    calls[f"threads_{n}"] = run()
torch.set_num_threads(default)
np.savez(out_path, **{f"{c}/{k}": v.numpy() for c, r in calls.items()
                      for k, v in r.items()})
report["threads"] = default
print(json.dumps(report))
'''


def _child(tmp_path, with_jax):
    out = tmp_path / f"jax{int(with_jax)}.npz"
    # four intra-op threads: several at once, without oversubscribing a
    # machine the other test workers share
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="4")
    proc = subprocess.Popen(
        [sys.executable, "-c", CHILD, str(REPO), str(out),
         str(int(with_jax))], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env)
    return proc, out


def test_first_call_after_a_jax_computation_is_a_function_of_its_inputs(
        tmp_path):
    runs = [_child(tmp_path, w) for w in (True, False)]
    reports = []
    for proc, _ in runs:
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0, stderr[-3000:]
        reports.append(json.loads(stdout.strip().splitlines()[-1]))
    assert reports[0]["mxcsr_after"] == reports[0]["mxcsr_before"]
    results = [dict(np.load(out)) for _, out in runs]
    names = sorted({k.split("/", 1)[1] for k in results[0]})
    assert len(names) == 7
    for name in names:
        ref = results[1][f"first/{name}"]
        assert np.isfinite(ref).any(), name
        for r in results:
            for call in ("first", "second", "threads_1", "threads_3"):
                got = r[f"{call}/{name}"]
                assert got.dtype == ref.dtype and got.shape == ref.shape
                assert np.array_equal(got, ref, equal_nan=True), (name, call)
