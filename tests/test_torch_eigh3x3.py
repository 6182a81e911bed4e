"""deplex_tpu_torch 3x3 eigensolve vs deplex_tpu.ops.eigh3x3_min.

The cases of tests/test_eigh3x3.py. Both run the same Cardano formulation in
float32, but atan2, cos and sin may differ by an ulp between the libraries
and XLA contracts and reassociates the jitted arithmetic. Cardano's roots
amplify that where two eigenvalues nearly coincide (4e-4 of the largest one
measured on these cases), so eigenvalues are held to 1e-3 of each matrix's
spectral radius (tests/test_eigh3x3.py allows 2e-3 against LAPACK).
"""

import jax
import numpy as np
import pytest
import torch

from deplex_tpu.ops.eigh3x3 import eigh3x3_min as jax_eigh3x3_min
from deplex_tpu_torch.ops.eigh3x3 import eigh3x3_min, f64_rounded


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def random_spd_batch(n, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 8, 3)).astype(np.float64) * scale
    return np.einsum("npi,npj->nij", X, X).astype(np.float32)


def _both(A):
    w_j, v_j = jax.jit(jax_eigh3x3_min)(A)
    w_t, v_t = eigh3x3_min(torch.from_numpy(A))
    return np.asarray(w_j), np.asarray(v_j), w_t.numpy(), v_t.numpy()


@pytest.mark.parametrize("scale", [1.0, 1e4, 1e-4])
def test_matches_jax_random_spd(scale):
    A = random_spd_batch(256, seed=0, scale=scale)
    w_j, v_j, w_t, v_t = _both(A)
    top = np.abs(w_j).max(-1, keepdims=True)
    assert (np.abs(w_t - w_j) <= 1e-3 * top).all()
    # The same cross-product candidate is picked, so the sign agrees too.
    np.testing.assert_allclose(np.sum(v_t * v_j, -1), 1.0, atol=1e-4)


def test_near_degenerate_plane():
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(100, 3))
    pts[:, 2] *= 1e-4
    A = ((pts - pts.mean(0)).T @ (pts - pts.mean(0)))[None].astype(np.float32)
    w_j, v_j, w_t, v_t = _both(A)
    assert abs(v_t[0, 2]) > 0.999
    np.testing.assert_allclose(v_t, v_j, atol=1e-4)
    assert (np.abs(w_t - w_j) <= 1e-3 * np.abs(w_j).max()).all()


def test_zero_and_isotropic_matrices():
    A = np.stack([np.zeros((3, 3)), np.eye(3) * 5.0]).astype(np.float32)
    w_j, v_j, w_t, v_t = _both(A)
    assert np.isfinite(w_t).all() and np.isfinite(v_t).all()
    np.testing.assert_array_equal(v_t, v_j)
    np.testing.assert_allclose(w_t, w_j, rtol=1e-6, atol=1e-6)


def test_batch_shape_preserved():
    A = random_spd_batch(24, seed=5).reshape(2, 3, 4, 3, 3)
    w, v = eigh3x3_min(torch.from_numpy(A))
    assert w.shape == (2, 3, 4, 3) and v.shape == (2, 3, 4, 3)
    assert bool((w[..., 0] <= w[..., 1]).all()) and bool((w[..., 1] <= w[..., 2]).all())


@pytest.mark.parametrize("fn", ["sqrt", "atan2", "cos", "sin", "acos"])
def test_transcendentals_are_float64_rounded(fn):
    """The plain stages take these in float64 rounded to float32, the bits
    the card gives too: numpy's float64 result, rounded."""
    rng = np.random.default_rng(1)
    x, y = rng.uniform(-1, 1, (2, 20001)).astype(np.float32)
    ref_fn, args = {"sqrt": (np.sqrt, (np.abs(x),)), "atan2": (np.arctan2, (y, x)),
                    "cos": (np.cos, (4 * x,)), "sin": (np.sin, (4 * x,)),
                    "acos": (np.arccos, (x,))}[fn]
    got = f64_rounded(getattr(torch, fn), *(torch.from_numpy(a) for a in args))
    assert got.dtype == torch.float32
    ref = ref_fn(*(a.astype(np.float64) for a in args)).astype(np.float32)
    np.testing.assert_array_equal(got.numpy(), ref)
