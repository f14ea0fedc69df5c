"""Launch plans and the direct run of the kernel engines, on CPU tensors.

``pallas_vh.PlanStore`` keeps :func:`pallas_vh.route`'s launch config per
pair of grid tensors (``alt``, ``freq``): held here against every way a
kept plan could go stale (an in-place write through the tensor, through a
view of it, another tensor with equal values, a tensor collected) and
against its bound. ``pallas_vh.run_engine`` runs the kernel without the
autograd Function where no derivative can be asked for: counted in
``PLANS["direct"]`` for a plain call, never under a ``torch.func``
transform, ``forward_ad`` or an input that requires grad, and with the
values of the Function's path bit for bit. Route keeps plans for CUDA
grids only; those are held on the card by ``test_torch_gpu_kernels.py``.
"""

import gc
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

import pyrayhf_tpu_torch.pallas_vh as TV

from _torch_threads import one_torch_thread  # noqa: F401

KEY = ("auto", 1.0, 200, True, False, torch.float64, torch.device("cpu"))


def _grid():
    return (torch.linspace(80.0, 699.0, 620, dtype=torch.float64),
            torch.arange(1, 175, dtype=torch.float64) / 10)


def test_a_repeat_lookup_hits():
    store = TV.PlanStore()
    alt, freq = _grid()
    assert store.get(alt, freq, KEY) is None
    plan = object()
    assert store.put(alt, freq, KEY, plan)
    assert store.get(alt, freq, KEY) is plan
    assert store.get(alt, freq, KEY) is plan
    assert len(store) == 1


@pytest.mark.parametrize("edit", ["alt", "alt_view", "freq", "freq_view"])
def test_an_in_place_edit_misses(edit):
    store = TV.PlanStore()
    alt, freq = _grid()
    store.put(alt, freq, KEY, "plan")
    t = alt if edit.startswith("alt") else freq
    if edit.endswith("view"):
        t[2:5].mul_(1.0)
    else:
        t.add_(0.0)
    assert store.get(alt, freq, KEY) is None
    store.put(alt, freq, KEY, "new")
    assert store.get(alt, freq, KEY) == "new"
    assert len(store) == 1


def test_equal_values_in_another_tensor_miss():
    store = TV.PlanStore()
    alt, freq = _grid()
    store.put(alt, freq, KEY, "plan")
    assert store.get(alt.clone(), freq, KEY) is None
    assert store.get(alt, freq.clone(), KEY) is None
    assert store.get(alt, freq, KEY) == "plan"


@pytest.mark.parametrize("dropped", ["alt", "freq"])
def test_a_collected_tensor_takes_its_plans_with_it(dropped):
    store = TV.PlanStore()
    alt, freq = _grid()
    store.put(alt, freq, KEY, "plan")
    store.put(alt, freq, KEY[:2] + (50,) + KEY[3:], "plan50")
    assert len(store) == 2
    if dropped == "alt":
        del alt
        alt = torch.linspace(80.0, 699.0, 620, dtype=torch.float64)
    else:
        del freq
        freq = torch.arange(1, 175, dtype=torch.float64) / 10
    gc.collect()
    assert len(store) == 0
    assert store.get(alt, freq, KEY) is None


def test_each_key_has_its_own_plan():
    store = TV.PlanStore()
    alt, freq = _grid()
    keys = [KEY,
            KEY[:1] + (-1.0,) + KEY[2:],                  # mode
            KEY[:2] + (2000,) + KEY[3:],                  # n_points
            ("pallas_mxu",) + KEY[1:],                    # engine
            KEY[:3] + (False,) + KEY[4:],                 # x_in_kernel_solve
            KEY[:5] + (torch.float32,) + KEY[6:]]         # dtype
    for i, k in enumerate(keys):
        assert store.put(alt, freq, k, i)
    assert [store.get(alt, freq, k) for k in keys] == list(range(len(keys)))
    assert len(store) == len(keys)


def test_inference_and_transformed_tensors_are_never_kept():
    store = TV.PlanStore()
    alt, freq = _grid()
    with torch.inference_mode():
        alt_inf = alt.clone()
    assert not store.put(alt_inf, freq, KEY, "plan")
    assert not store.put(alt, alt_inf, KEY, "plan")
    kept = []

    def f(a):
        kept.append(store.put(a, freq, KEY, "plan"))
        return a * 2.0

    torch.func.vmap(f)(torch.stack([alt, alt]))
    torch.func.jvp(f, (alt,), (torch.ones_like(alt),))
    assert kept == [False, False]
    assert len(store) == 0


def test_the_store_keeps_its_bound():
    store = TV.PlanStore(size=4)
    grids = [_grid() for _ in range(6)]
    for i, (alt, freq) in enumerate(grids):
        store.put(alt, freq, KEY, i)
        assert len(store) == min(i + 1, 4)
    assert [store.get(a, f, KEY) for a, f in grids] == [None, None, 2, 3,
                                                         4, 5]
    # a hit makes a plan the newest: the next put drops the oldest other
    store.get(*grids[2], KEY)
    extra = _grid()
    store.put(*extra, KEY, "extra")
    assert store.get(*grids[3], KEY) is None
    assert store.get(*grids[2], KEY) == 2
    assert len(store) == 4


def test_threads_share_one_store():
    """More threads than cores put, look up, write and drop grids on one
    small store, switching every microsecond, for a bounded time: every
    lookup gives its own plan or None, none raises, the bound holds."""
    store = TV.PlanStore(size=4)
    errors, hits = [], []
    stop = time.monotonic() + 2.0

    def work(w):
        try:
            while time.monotonic() < stop:
                alt, freq = _grid()
                for i in range(3):
                    store.put(alt, freq, KEY, (w, i))
                    got = store.get(alt, freq, KEY)
                    if got not in (None, (w, i)):
                        errors.append(got)
                    hits.append(got is not None)
                    alt.add_(0.0)
                    assert store.get(alt, freq, KEY) is None
                del alt, freq
        except Exception as e:        # noqa: BLE001 - reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(w,))
                   for w in range(2 * len(os.sched_getaffinity(0)) + 2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert errors == [] and any(hits)
    gc.collect()
    assert len(store) == 0


def _workload(B=2, n_alt=60):
    alt = np.linspace(90.0, 550.0, n_alt)
    rng = np.random.default_rng(5)
    den = rng.uniform(1e12, 3e12, (B, 1)) * np.exp(
        -(alt - rng.uniform(250.0, 330.0, (B, 1))) ** 2 / (2 * 55.0 ** 2))
    bmag = np.full_like(den, 3.2e-5)
    bpsi = np.full_like(den, 65.0)
    freqs = np.arange(1.0, 15.0, 1.5)
    return [torch.as_tensor(a, dtype=torch.float64)
            for a in (freqs, den, bmag, bpsi, alt)]


def _gather(freq, den, bmag, bpsi, alt, mode_mult=1.0):
    return TV.ionogram_pallas_gather(freq, den, bmag, bpsi, alt,
                                     mode_mult=mode_mult, n_points=50,
                                     device="cpu")


def _same(a, b):
    return torch.equal(torch.nan_to_num(a, nan=-1.0),
                       torch.nan_to_num(b, nan=-1.0))


@pytest.mark.parametrize("mode_mult", [1.0, -1.0])
def test_a_plain_call_runs_directly(mode_mult, monkeypatch):
    """No transform, no tangent, nothing requiring grad: the kernel's plain
    version without the Function; CPU grids keep no plan and are read on
    every call."""
    reads = []
    real = TV.uniform_inv_dalt
    monkeypatch.setattr(TV, "uniform_inv_dalt",
                        lambda alt: reads.append(1) or real(alt))
    f, den, bmag, bpsi, alt = _workload()
    kind = "gather_osolve" if mode_mult > 0 else "gather_xsolve"
    stored = len(TV._PLAN_STORE)
    TV.reset_counters()
    vh = _gather(f, den, bmag, bpsi, alt, mode_mult)
    again = _gather(f, den, bmag, bpsi, alt, mode_mult)
    fresh = _gather(f.clone(), den, bmag, bpsi, alt.clone(), mode_mult)
    assert TV.PLANS == {"hit": 0, "miss": 0, "direct": 3}
    assert TV.PLAIN_CALLS[kind] == 3 and sum(TV.LAUNCHES.values()) == 0
    assert len(reads) == 3 and len(TV._PLAN_STORE) == stored
    assert vh.grad_fn is None and not vh.requires_grad
    assert _same(vh, again) and _same(vh, fresh)
    with torch.no_grad():
        den_g = den.clone().requires_grad_()
        assert _same(_gather(f, den_g, bmag, bpsi, alt, mode_mult), vh)
    assert TV.PLANS["direct"] == 4


def _scaled(f, den, bmag, bpsi, alt):
    return lambda s: _gather(f, den * s, bmag, bpsi, alt)


@pytest.mark.parametrize("how", ["requires_grad", "grad", "jacrev",
                                 "jacfwd", "jvp", "forward_ad", "vmap",
                                 "jacfwd_jacfwd", "jvp_jvp"])
def test_a_derivative_keeps_the_function(how):
    """Under every way of asking for a derivative the call goes through
    ``_PallasAD`` (or, under two forward transforms, ``_KernelGap``): no
    direct run, and its primal the direct call's bit for bit."""
    xs = _workload()
    plain = _gather(*xs)
    g = _scaled(*xs)
    one = torch.ones((), dtype=torch.float64)
    TV.reset_counters()
    if how == "requires_grad":
        s = one.clone().requires_grad_()
        out = g(s)
        out.nan_to_num().sum().backward()
        assert s.grad is not None and out.grad_fn is not None
    elif how == "grad":
        torch.func.grad(lambda s: g(s).nan_to_num().sum())(one)
        out = plain
    elif how == "jacrev":
        torch.func.jacrev(g)(one)
        out = plain
    elif how == "jacfwd":
        torch.func.jacfwd(g)(one)
        out = plain
    elif how == "jvp":
        out, _ = torch.func.jvp(g, (one,), (one,))
    elif how == "forward_ad":
        with fwAD.dual_level():
            out, tan = fwAD.unpack_dual(g(fwAD.make_dual(one, one)))
            assert tan is not None
    elif how == "vmap":
        f, den, bmag, bpsi, alt = xs
        out = torch.func.vmap(
            lambda d: _gather(f, d, bmag, bpsi, alt))(den[None])[0]
    elif how == "jacfwd_jacfwd":
        torch.func.jacfwd(torch.func.jacfwd(g))(one)
        out = plain
    else:
        out = torch.func.jvp(lambda s: torch.func.jvp(g, (s,), (one,))[0],
                             (one,), (one,))[0]
    assert TV.PLANS["direct"] == 0
    assert TV.PLAIN_CALLS["gather_osolve"] >= 1
    assert _same(out.detach(), plain)


def test_forward_ad_without_a_tangent_runs_directly():
    """An open dual level alone asks for nothing: inputs without a tangent
    run directly."""
    xs = _workload()
    plain = _gather(*xs)
    TV.reset_counters()
    with fwAD.dual_level():
        out = _gather(*xs)
    assert TV.PLANS["direct"] == 1 and _same(out, plain)
