"""PyTorch port vs the JAX package: the one-hot (mxu) ionogram kernel.

The port's plain version of ``csrc/ionogram_mxu.cu`` does the factorised
one-hot products with ``torch.matmul``; it is held against the JAX
package's ``ionogram_pallas_mxu`` in interpret mode on seeded numpy inputs
in f64, with identical NaN masks and ≤ 1e-9 km (the JAX package's own
MXU-vs-sweep bound, ``tests/test_pallas.py:247``). Against the port's own
host-solve gather the resample rows are equal, so the results are
bit-identical.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import pyrayhf_tpu.pallas_vh as JV
import pyrayhf_tpu_torch.forward as TF
import pyrayhf_tpu_torch.pallas_vh as TV

from _torch_threads import one_torch_thread  # noqa: F401

TOL_KM = 1e-9


def _case(n_alt=180):
    """A plain Gaussian and an E-peak over a valley (the shadow gate),
    with a sub-gyro first frequency and above-MUF rows."""
    alt = np.linspace(90.0, 550.0, n_alt)
    f2 = 2.5e12 * np.exp(-(alt - 300.0) ** 2 / (2 * 55.0 ** 2))
    e_layer = 9e11 * np.exp(-(alt - 110.0) ** 2 / (2 * 10.0 ** 2))
    den = np.stack([f2, f2 + e_layer])
    bmag = np.full_like(den, 3.2e-5)
    bpsi = np.full_like(den, 65.0)
    freqs = np.concatenate([[0.3], np.arange(1.0, 16.0, 0.5), [25.0]])
    return freqs, den, bmag, bpsi, alt


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float64))


def _assert_vh(port, ref, tol=TOL_KM):
    port = port.detach().numpy()
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    assert np.array_equal(np.isnan(port), np.isnan(ref))
    m = np.isfinite(ref)
    assert m.any()
    assert np.abs(port[m] - ref[m]).max() <= tol


@pytest.mark.parametrize("mode_mult,n_points,p_chunk",
                         [(1.0, 200, 512), (-1.0, 200, 512),
                          (1.0, 512, 128)])
def test_mxu_plain_matches_jax_interpret(mode_mult, n_points, p_chunk):
    """O and X at 200 points, and 512 points over four TPU point chunks
    (the JAX chunking case, tests/test_pallas.py:291-304)."""
    args = _case()
    ref = JV.ionogram_pallas_mxu(*map(jnp.asarray, args),
                                 mode_mult=mode_mult, n_points=n_points,
                                 p_chunk=p_chunk, interpret=True)
    TV.reset_counters()
    port = TV.ionogram_pallas_mxu(*map(_t, args), mode_mult=mode_mult,
                                  n_points=n_points)
    assert TV.PLAIN_CALLS["mxu"] == 1 and sum(TV.LAUNCHES.values()) == 0
    _assert_vh(port, ref)


@pytest.mark.parametrize("mode_mult", [1.0, -1.0])
@pytest.mark.parametrize("n_alt", [180, 620])
def test_mxu_plain_equals_host_solve_gather(mode_mult, n_alt):
    """The one-hot products pick each point's segment row exactly, so the
    mxu plain version equals the host-solve gather's bit for bit."""
    args = [_t(a) for a in _case(n_alt)]
    inv = TV.uniform_inv_dalt(args[4])
    outs = [TV.plain_ionogram(TV.prepare_kernel_args(
        kind, *args, mode_mult, 300, inv)) for kind in ("mxu", "gather")]
    assert torch.equal(torch.nan_to_num(outs[0], nan=-1.0),
                       torch.nan_to_num(outs[1], nan=-1.0))


def test_mxu_table_layout_matches_jax():
    """T[b, q, a] = seg[b, a·16 + q//8, q%8], zero rows past N (the TPU
    kernel's [K2·8, K1] operand, pallas_vh.py:1187-1191)."""
    rng = np.random.default_rng(5)
    seg = rng.normal(size=(3, 37, 8))
    K2, K1 = 16, 3
    ref = np.concatenate([seg, np.zeros((3, K1 * K2 - 37, 8))], axis=1)
    ref = ref.reshape(3, K1, K2 * 8).transpose(0, 2, 1)
    got = TV._mxu_table(_t(seg))
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), ref)
    assert TV.mxu_smem_bytes(39, 4) == 4 * (3 * 128 * 44 + 8 * 192)
    assert TV.mxu_smem_bytes(39, 8) == 8 * (128 * 44 + 8 * 192)


def test_mxu_requires_uniform_grid():
    freqs, den, bmag, bpsi, alt = _case()
    alt_nu = alt.copy()
    alt_nu[1:] += np.linspace(0.0, 5.0, alt.size - 1) ** 2 * 0.01
    with pytest.raises(ValueError, match="uniform"):
        TV.ionogram_pallas_mxu(*map(_t, (freqs, den, bmag, bpsi, alt_nu)),
                               mode_mult=1.0)
    with pytest.raises(ValueError, match="uniform"):
        TF.vertical_forward_operator_batch(
            *map(_t, (freqs, den, bmag, bpsi, alt_nu)), engine="pallas_mxu")


@pytest.mark.parametrize("mode", ["O", "X"])
def test_engine_pallas_mxu_routes_to_the_mxu_plain_version(mode):
    """``engine="pallas_mxu"`` on CPU tensors runs the mxu plain version
    (never a kernel) and agrees with the JAX xla engine (≤ 1e-9 km, the
    JAX package's own MXU-vs-sweep bound)."""
    args = _case()
    ref = jax.jit(lambda *a: JV.ionogram_fast_xla(
        *a, mode_mult=1.0 if mode == "O" else -1.0, n_points=200))(
        *map(jnp.asarray, args))
    TV.reset_counters()
    port = TF.vertical_forward_operator_batch(*map(_t, args), mode=mode,
                                              engine="pallas_mxu")
    assert TV.PLAIN_CALLS == dict(dict.fromkeys(TV.KERNELS, 0), mxu=1)
    assert sum(TV.LAUNCHES.values()) == 0
    m = np.isfinite(np.asarray(ref))
    m[:, 0] = False                        # sub-gyro row: NaN pattern only
    out, ref = port.numpy(), np.asarray(ref)
    assert np.array_equal(np.isnan(out), np.isnan(ref))
    assert np.abs(out[m] - ref[m]).max() <= TOL_KM


def test_mxu_autograd_is_the_sweeps_gradient():
    """Autograd through ionogram_pallas_mxu is the plain sweep's VJP
    (rtol 1e-10, tests/test_pallas.py:320-346), and equals jax.grad of the
    JAX sweep (rtol 1e-7, atol 1e-9·max: another summation order)."""
    freqs, den, bmag, bpsi, alt = _case()
    fixed = [_t(a) for a in (bmag, bpsi, alt)]

    def loss(vh):
        return torch.where(torch.isfinite(vh), vh, 0.0).sum()

    grads = []
    for fn in (TV.ionogram_pallas_mxu, TV.ionogram_fast_xla):
        d = _t(den).requires_grad_(True)
        vh = fn(_t(freqs), d, *fixed, mode_mult=1.0, n_points=200)
        grads.append(torch.autograd.grad(loss(vh), d)[0].numpy())
    assert np.isfinite(grads[0]).all() and np.abs(grads[0]).max() > 0
    np.testing.assert_allclose(grads[0], grads[1], rtol=1e-10, atol=0)

    def loss_j(d):
        vh = JV.ionogram_fast_xla(jnp.asarray(freqs), d, jnp.asarray(bmag),
                                  jnp.asarray(bpsi), jnp.asarray(alt),
                                  mode_mult=1.0, n_points=200)
        return jnp.sum(jnp.where(jnp.isfinite(vh), vh, 0.0))

    g_j = np.asarray(jax.grad(loss_j)(jnp.asarray(den)))
    np.testing.assert_allclose(grads[0], g_j, rtol=1e-7,
                               atol=1e-9 * np.abs(g_j).max())
