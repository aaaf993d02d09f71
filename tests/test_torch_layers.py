"""The port's primitives (gyre_tpu_torch.models.layers) against the JAX
package's (gyre_tpu.models.layers), in f32 on the CPU, on the same inputs
made from a seed with numpy.

Tolerance: max abs error <= 1e-4 of max |JAX|. Both sides compute in f32;
they differ only in the order of sums (matmul and conv blocking, the two
frameworks' reductions), a few f32 ulps (~1e-7) per term, far inside 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gyre_tpu.models import layers as JL
from gyre_tpu_torch.models import layers as TL

TOL = 1e-4


def _rng(seed=0):
    return np.random.default_rng(seed)


def _close(port, ref, tol=TOL):
    port = port.detach().numpy() if torch.is_tensor(port) else port
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    err = np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-12)
    assert err <= tol, err


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("bias", [True, False])
def test_linear(bias):
    r = _rng(1)
    x = r.standard_normal((2, 5, 24)).astype(np.float32)
    w = r.standard_normal((24, 40)).astype(np.float32)      # JAX (in, out)
    jp = {"w": w}
    tp = {"w": _t(w.T)}                                      # port (out, in)
    if bias:
        b = r.standard_normal((40,)).astype(np.float32)
        jp["b"], tp["b"] = b, _t(b)
    _close(TL.linear(tp, _t(x)), JL.linear(jp, jnp.asarray(x)))


@pytest.mark.parametrize("k,stride,pad", [(3, 1, "SAME"), (1, 1, "SAME"),
                                          (3, 2, [(1, 1), (1, 1)])])
def test_conv2d(k, stride, pad):
    r = _rng(2)
    x = r.standard_normal((2, 8, 8, 16)).astype(np.float32)
    w = (0.1 * r.standard_normal((k, k, 16, 24))).astype(np.float32)  # HWIO
    b = r.standard_normal((24,)).astype(np.float32)
    ref = JL.conv2d({"w": w, "b": b}, jnp.asarray(x), stride=stride,
                    padding=pad)
    port = TL.conv2d({"w": _t(w.transpose(3, 2, 0, 1)), "b": _t(b)}, _t(x),
                     stride=stride, padding=None if pad == "SAME" else 1)
    _close(port, ref)


@pytest.mark.parametrize("groups,eps", [(8, 1e-5), (4, 1e-6)])
def test_group_norm(groups, eps):
    r = _rng(3)
    x = (3.0 + r.standard_normal((2, 6, 6, 32))).astype(np.float32)
    p = {"scale": (1 + 0.1 * r.standard_normal(32)).astype(np.float32),
         "bias": (0.1 * r.standard_normal(32)).astype(np.float32)}
    ref = JL.group_norm(p, jnp.asarray(x), groups, eps=eps)
    port = TL.group_norm({k: _t(v) for k, v in p.items()}, _t(x), groups,
                         eps=eps)
    _close(port, ref)


def test_layer_norm():
    r = _rng(4)
    x = r.standard_normal((2, 7, 48)).astype(np.float32)
    p = {"scale": (1 + 0.1 * r.standard_normal(48)).astype(np.float32),
         "bias": (0.1 * r.standard_normal(48)).astype(np.float32)}
    _close(TL.layer_norm({k: _t(v) for k, v in p.items()}, _t(x)),
           JL.layer_norm(p, jnp.asarray(x)))


@pytest.mark.parametrize("name", ["silu", "gelu", "quick_gelu"])
def test_activations(name):
    x = (3 * _rng(5).standard_normal((4, 33))).astype(np.float32)
    _close(getattr(TL, name)(_t(x)), getattr(JL, name)(jnp.asarray(x)))


def test_geglu():
    r = _rng(6)
    x = r.standard_normal((2, 9, 16)).astype(np.float32)
    w = (0.2 * r.standard_normal((16, 64))).astype(np.float32)
    b = r.standard_normal((64,)).astype(np.float32)
    _close(TL.geglu({"w": _t(w.T), "b": _t(b)}, _t(x)),
           JL.geglu({"w": w, "b": b}, jnp.asarray(x)))


@pytest.mark.parametrize("dim", [32, 33, 320])
def test_timestep_embedding(dim):
    t = np.array([0.0, 1.5, 999.0, 421.25], np.float32)
    _close(TL.timestep_embedding(_t(t), dim),
           JL.timestep_embedding(jnp.asarray(t), dim))


def test_upsample_nearest_2x():
    x = _rng(7).standard_normal((2, 3, 5, 4)).astype(np.float32)
    _close(TL.upsample_nearest_2x(_t(x)),
           JL.upsample_nearest_2x(jnp.asarray(x)), tol=0.0)


@pytest.mark.parametrize("masked", [False, True])
def test_attention(masked):
    """[B,T,H,D] attention; unmasked goes through the flash wrapper, which
    takes the plain version for CPU tensors."""
    r = _rng(8)
    q, k, v = (r.standard_normal((2, 12, 3, 16)).astype(np.float32)
               for _ in range(3))
    mask = np.tril(np.ones((12, 12), bool))[None, None] if masked else None
    ref = JL.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       mask=None if mask is None else jnp.asarray(mask))
    port = TL.attention(_t(q), _t(k), _t(v),
                        mask=None if mask is None else _t(mask))
    _close(port, ref)
