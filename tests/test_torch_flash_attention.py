"""Flash-attention forward of the PyTorch/CUDA port against the JAX
package.

The plain PyTorch version (``_fa_forward_plain``) is held against the
real Pallas kernel run in interpret mode on the CPU, and against the
chunked and dense JAX paths on the shapes the Pallas gate never takes.
The CUDA kernel itself is compared with the plain version on the card
in ``test_torch_kernels_cuda.py``.
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops import flash_attention as jfa
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import flash_attention as tfa


def _qkv(seed, b, h, tq, tk, d):
    rng = np.random.RandomState(seed)
    return (rng.normal(size=(b, h, tq, d)).astype(np.float32),
            rng.normal(size=(b, h, tk, d)).astype(np.float32),
            rng.normal(size=(b, h, tk, d)).astype(np.float32))


def _plain(q, k, v, causal, scale):
    o, lse = tfa._fa_forward_plain(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal, scale)
    return o.numpy(), lse.numpy()


def _dense_lse(q, k, causal, scale):
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64),
                  k.astype(np.float64)) * scale
    if causal:
        tq, tk = s.shape[-2:]
        s = np.where(np.tril(np.ones((tq, tk), bool), k=tk - tq), s,
                     -np.inf)
    m = s.max(-1)
    with np.errstate(invalid="ignore", divide="ignore"):
        return m + np.log(np.exp(s - np.where(np.isfinite(m), m,
                                              0)[..., None]).sum(-1))


# O and lse: both sides are f32 online softmax over the same scores and
# differ only in block order, so 1e-5 absolute holds.
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(1, 2, 256, 64), (2, 4, 128, 16)])
def test_plain_matches_interpret_pallas_kernel(causal, shape):
    b, h, t, d = shape
    q, k, v = _qkv(0, b, h, t, t, d)
    scale = 1.0 / math.sqrt(d)
    o_ref, lse_ref = jfa._fa_forward_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, scale,
        with_lse=True, interpret=True)
    o, lse = _plain(q, k, v, causal, scale)
    assert o.dtype == np.float32 and o.shape == shape
    assert lse.shape == (b, h, t)
    assert np.abs(o - np.asarray(o_ref)).max() <= 1e-5
    lse_ref = np.asarray(lse_ref)
    assert np.isfinite(lse_ref).all()
    assert np.abs(lse - lse_ref).max() <= 1e-5


@pytest.mark.parametrize("causal,tq,tk", [
    (False, 200, 200),   # ragged T, no 128 multiple
    (True, 200, 200),
    (True, 4, 6),        # Tq < Tk: bottom-right causal alignment
    (True, 6, 4),        # Tq > Tk: rows 0 and 1 see no key
])
def test_plain_matches_reference_on_unaligned_shapes(causal, tq, tk):
    q, k, v = _qkv(1, 2, 3, tq, tk, 32)
    scale = 0.2
    o, lse = _plain(q, k, v, causal, scale)
    chunked = np.asarray(jfa._fa_forward_chunked(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, scale,
        block=64))
    assert np.abs(o - chunked).max() <= 1e-5
    dense = np.asarray(jfa._sdpa_ref(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal, scale))
    lse_ref = _dense_lse(q, k, causal, scale)
    seen = np.isfinite(lse_ref)
    assert np.abs(o - dense)[seen].max() <= 1e-5
    assert np.abs(lse[seen] - lse_ref[seen]).max() <= 1e-5
    # rows that see no key: O = 0, lse = -inf (the dense softmax gives NaN)
    assert (o[~seen] == 0).all()
    assert np.isneginf(lse[~seen]).all()
    assert seen.all() == (tq <= tk or not causal)


def test_bottom_right_alignment_differs_from_top_left():
    """Tq=4, Tk=6: query i sees keys j <= i + 2.  torch's is_causal is
    top-left (j <= i); the port must not take it."""
    q, k, v = _qkv(2, 1, 2, 4, 6, 16)
    o, _ = _plain(q, k, v, True, 0.25)
    top_left = torch.nn.functional.scaled_dot_product_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), is_causal=True,
        scale=0.25).numpy()
    assert np.abs(o - top_left).max() > 0.1
    ref = np.asarray(jfa._sdpa_ref(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), True, 0.25))
    assert np.abs(o - ref).max() <= 1e-5


@pytest.mark.parametrize("causal", [False, True])
def test_sdpa_ref_matches_reference(causal):
    q, k, v = _qkv(3, 2, 2, 32, 32, 16)
    ref = np.asarray(jfa._sdpa_ref(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal, 0.25))
    got = tfa._sdpa_ref(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), causal, 0.25).numpy()
    assert np.abs(got - ref).max() <= 1e-5


def test_wrapper_takes_plain_version_on_cpu_only():
    q, k, v = (torch.from_numpy(a) for a in _qkv(4, 1, 2, 64, 64, 32))
    before = tfa.flash_attention_fwd.launches
    out = tfa.flash_attention_raw(q, k, v, True)
    o, _ = tfa._fa_forward_plain(q, k, v, True, 1.0 / math.sqrt(32))
    assert torch.equal(out, o)
    assert tfa.flash_attention_fwd.launches == before == 0


def test_wrapper_refuses_gradients():
    q, k, v = (torch.from_numpy(a) for a in _qkv(5, 1, 1, 8, 8, 16))
    q.requires_grad_(True)
    with pytest.raises(MXNetError, match="training slice"):
        tfa.flash_attention_raw(q, k, v, True)
    with torch.no_grad():
        tfa.flash_attention_raw(q, k, v, True)
