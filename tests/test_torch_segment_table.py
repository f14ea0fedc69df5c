"""Kernels 1 and 2's segment table off the card.

CPU tensors take the plain version (:func:`plain_segment_table`, the
PyTorch composition), counted nowhere; CUDA tensors take
``csrc/segment_table.cu`` (held to the plain version bit for bit in
``tests/test_torch_gpu_kernels.py``). Here the kernel's node arithmetic
(the source node of each channel, the difference's two nodes, the running
maximum's step), written out in numpy as the kernel computes it, is held
to the plain version on the profiles where it could part from it: the
peak at the first or last node, tied maxima, NaN, signed zeros, N = 2.
"""

import numpy as np
import pytest
import torch

import pyrayhf_tpu_torch.pallas_vh as TV

from _torch_threads import one_torch_thread  # noqa: F401


def _profiles(case, dtype):
    rng = np.random.default_rng(5)
    B, N = (3, 2) if case == "n2" else (4, 40)
    alt = np.linspace(90.0, 480.0, N)
    den = rng.uniform(1e11, 3e12, (B, N))
    bmag = rng.uniform(2e-5, 6e-5, (B, N))
    bpsi = rng.uniform(0.0, 90.0, (B, N))
    if case == "peak_first":
        den[:, 0] = 9e12
    elif case == "peak_last":
        den[:, -1] = 9e12
    elif case == "ties":
        den[0, [7, 21]] = 9e12
        den[1] = 5e11
        den[2, [0, N - 1]] = 9e12
    elif case == "nan":
        den[0, 11] = den[1, 0] = den[2, N - 1] = np.nan
        den[3, [5, 9]] = np.nan
        bmag[0, 3] = np.nan
    elif case == "signed_zeros":
        den = np.where(rng.uniform(size=(B, N)) < 0.5, -0.0, 0.0)
        den[:, -1] = 1.0
        bmag = np.where(rng.uniform(size=(B, N)) < 0.5, -0.0, 0.0)
        alt[5] = alt[4]                        # a zero step: 1/Δalt is 0
    return [torch.as_tensor(a, dtype=dtype) for a in (den, bmag, bpsi, alt)]


def _kernel_arithmetic(kind, den, bmag, bpsi, alt):
    """What ``csrc/segment_table.cu`` writes, node by node, in numpy."""
    den, bmag, bpsi, alt = (x.numpy() for x in (den, bmag, bpsi, alt))
    B, N = den.shape
    C = 9 if kind == "gather_osolve" else 8
    ld = TV.padded_rows(N, den.itemsize)
    tab = np.zeros((B, C, ld), den.dtype)
    one, zero = den.dtype.type(1), den.dtype.type(0)
    for b in range(B):
        nan = np.isnan(den[b])
        m = int(np.argmax(nan)) if nan.any() else int(np.argmax(den[b]))
        last = max(m - 1, 0)
        acc = den[b, 0]
        for j in range(N):
            lo = min(j, N - 2)
            k, k0, k1 = (i if i < m else last for i in (j, lo, lo + 1))
            dalt = alt[k1] - alt[k0]
            tab[b, :8, j] = (alt[k] - alt[0],
                             one / dalt if dalt > zero else zero,
                             den[b, k], den[b, k1] - den[b, k0],
                             bmag[b, k], bmag[b, k1] - bmag[b, k0],
                             bpsi[b, k], bpsi[b, k1] - bpsi[b, k0])
            x = den[b, k]
            if np.isnan(x) or (not np.isnan(acc) and x >= acc):
                acc = x
            if C == 9:
                tab[b, 8, j] = acc
    return torch.from_numpy(tab)


def _same_bits(a, b):
    ints = torch.int32 if a.dtype == torch.float32 else torch.int64
    return (a.shape == b.shape and torch.equal(torch.isnan(a), torch.isnan(b))
            and torch.equal(torch.where(torch.isnan(a), 0, a.view(ints)),
                            torch.where(torch.isnan(b), 0, b.view(ints))))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["gather_osolve", "gather_xsolve"])
def test_cpu_tensors_take_the_plain_table_uncounted(kind, dtype):
    """On CPU tensors the prep builds the table with the plain version,
    launches nothing and counts nothing under ``segment_table``; the
    plain kernel version is counted once, as before."""
    den, bmag, bpsi, alt = _profiles("random", dtype)
    freq = torch.arange(1.0, 12.0, 0.5, dtype=dtype)
    mm = 1.0 if kind == "gather_osolve" else -1.0
    TV.reset_counters()
    a = TV.prepare_kernel_args(kind, freq, den, bmag, bpsi, alt, mm, 200,
                               TV.uniform_inv_dalt(alt))
    assert _same_bits(a.tab, TV.plain_segment_table(kind, den, bmag, bpsi,
                                                    alt))
    assert "segment_table" in TV.KERNELS
    assert TV.LAUNCHES == dict.fromkeys(TV.KERNELS, 0)
    assert TV.PLAIN_CALLS == dict.fromkeys(TV.KERNELS, 0)
    TV.plain_ionogram(a)
    assert TV.PLAIN_CALLS == dict(dict.fromkeys(TV.KERNELS, 0), **{kind: 1})
    assert sum(TV.LAUNCHES.values()) == 0
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        TV.launch_segment_table(kind, den, bmag, bpsi, alt)


@pytest.mark.parametrize("case", ["random", "peak_first", "peak_last",
                                  "ties", "nan", "signed_zeros", "n2"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["gather_osolve", "gather_xsolve"])
def test_kernel_node_arithmetic_is_the_plain_table(kind, dtype, case):
    prof = _profiles(case, dtype)
    assert _same_bits(_kernel_arithmetic(kind, *prof),
                      TV.plain_segment_table(kind, *prof))
