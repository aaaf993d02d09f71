"""The port's models (CLIP text tower, UNet, VAE decoder) against the JAX
package's on the SD_TEST preset, with the JAX random weights carried over by
the bridge gyre_tpu_torch.models.modelset.from_jax_params.

Tolerance: max abs error <= 1e-3 of max |JAX|, f32 on both sides: sums in
another order through deep nets (the UNet is ~60 layers deep), far above
f32 rounding (~1e-6 observed) and far below any wiring fault.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gyre_tpu.models import clip as jclip
from gyre_tpu.models import configs
from gyre_tpu.models import modelset as jms
from gyre_tpu.models import unet as junet
from gyre_tpu.models import vae as jvae
from gyre_tpu_torch.models import clip as tclip
from gyre_tpu_torch.models import modelset as tms
from gyre_tpu_torch.models import unet as tunet
from gyre_tpu_torch.models import vae as tvae

TOL = 1e-3
CFG = configs.SD_TEST


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def pair():
    ms = jms.random_modelset(CFG, seed=0, dtype=jnp.float32)
    jp = (_np_tree(ms.unet_params), _np_tree(ms.vae_params),
          [_np_tree(t) for t in ms.text_params])
    return jp, tms.from_jax_params(*jp, CFG, device="cpu")


def _err(port, ref):
    ref = np.asarray(ref)
    return np.abs(port.numpy() - ref).max() / np.abs(ref).max()


def test_unet(pair):
    (up, _, _), port = pair
    r = np.random.default_rng(0)
    x = r.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.array([10.5, 700.0], np.float32)
    ctx = r.standard_normal((2, 77, 64)).astype(np.float32)
    ref = jax.jit(lambda *a: junet.apply(a[0], CFG.unet, *a[1:]))(
        up, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    with torch.inference_mode():
        out = tunet.apply(port.unet_params, CFG.unet, torch.from_numpy(x),
                          torch.from_numpy(t), torch.from_numpy(ctx))
    assert _err(out, ref) <= TOL


def test_vae_decode(pair):
    (_, vp, _), port = pair
    z = np.random.default_rng(1).standard_normal((2, 8, 8, 4)).astype(
        np.float32)
    ref = jax.jit(lambda p, z: jvae.decode(p, CFG.vae, z))(vp,
                                                           jnp.asarray(z))
    with torch.inference_mode():
        out = tvae.decode(port.vae_params, CFG.vae, torch.from_numpy(z))
    assert out.shape == (2, 64, 64, 3)
    assert _err(out, ref) <= TOL


@pytest.mark.parametrize("clip_layer", [-1, -2])
def test_clip(pair, clip_layer):
    (_, _, tp), port = pair
    te = CFG.text_encoders[0]
    ids = np.random.default_rng(2).integers(1000, 49000, (2, 77))
    ids[0, 5] = ids[1, 40] = te.eos_token_id
    jout = jax.jit(lambda p, i: jclip.apply(p, te, i))(tp[0],
                                                       jnp.asarray(ids))
    with torch.inference_mode():
        tout = tclip.apply(port.text_params[0], te, torch.from_numpy(ids))
        hid = tclip.hidden_for_layer(port.text_params[0], te, tout,
                                     clip_layer)
    assert _err(hid, jclip.hidden_for_layer(tp[0], te, jout,
                                            clip_layer)) <= TOL
    assert _err(tout["pooled"], jout["pooled"]) <= TOL


def test_bridge_rejects_unconsumed_and_missing_leaves(pair):
    (up, vp, tp), _ = pair
    extra = copy.deepcopy(up)
    extra["down"][0]["resnets"][0]["stray"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="does not consume"):
        tms.from_jax_params(extra, vp, tp, CFG, device="cpu")
    missing = copy.deepcopy(up)
    del missing["mid"]["res1"]["conv2"]["b"]
    with pytest.raises(ValueError, match="no leaf"):
        tms.from_jax_params(missing, vp, tp, CFG, device="cpu")
    bad = copy.deepcopy(vp)
    bad["decoder"]["conv_in"]["w"] = bad["decoder"]["conv_in"]["w"][:, :, :2]
    with pytest.raises(ValueError, match="shape"):
        tms.from_jax_params(up, bad, tp, CFG, device="cpu")


def test_bridge_layouts(pair):
    """Linear (in, out) -> (out, in); conv HWIO -> OIHW; the fused convs
    keep HWIO (the layout their kernel reads)."""
    (up, _, _), port = pair
    res = port.unet_params["down"][0]["resnets"][0]
    jres = up["down"][0]["resnets"][0]
    np.testing.assert_array_equal(res["time_emb"]["w"].numpy(),
                                  jres["time_emb"]["w"].T)
    np.testing.assert_array_equal(res["conv1"]["w"].numpy(),
                                  jres["conv1"]["w"])
    np.testing.assert_array_equal(port.unet_params["conv_in"]["w"].numpy(),
                                  up["conv_in"]["w"].transpose(3, 2, 0, 1))


def test_random_modelset_matches_bridged_structure(pair):
    _, bridged = pair
    ms = tms.random_modelset(CFG, seed=3, dtype=torch.float32,
                             device="cpu")
    again = tms.random_modelset(CFG, seed=3, dtype=torch.float32,
                                device="cpu")

    def shapes(tree):
        return jax.tree.map(lambda t: tuple(t.shape), tree)

    for part in ("unet_params", "vae_params", "text_params"):
        assert shapes(getattr(ms, part)) == shapes(getattr(bridged, part))
        for a, b in zip(jax.tree.leaves(getattr(ms, part)),
                        jax.tree.leaves(getattr(again, part))):
            assert torch.equal(a, b)
    norm = ms.unet_params["mid"]["res1"]["norm1"]
    assert bool((norm["scale"] == 1).all()) and bool((norm["bias"] == 0).all())
    w = ms.unet_params["conv_in"]["w"]          # OIHW, fan_in = 4*3*3
    assert float(w.abs().max()) <= 36 ** -0.5


def _spec_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _spec_leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _spec_leaves(v, path + (i,))
    else:
        yield path, tree


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("source", ["random_preset", "from_jax_params"])
def test_fused_conv_params_f32(pair, source):
    """The GroupNorm scale and bias in front of every fused conv, and that
    conv's bias, are f32 leaves made once with a bf16 ModelSet, each the
    exact f32 value of the bf16 leaf (so the kernels' wrappers cast nothing
    and the images do not change); every other leaf stays bf16."""
    (up, vp, tp), _ = pair
    if source == "random_preset":
        ms = tms.random_preset("test", device="cpu")
    else:
        ms = tms.from_jax_params(up, vp, tp, CFG, dtype=torch.bfloat16,
                                 device="cpu")
    trees = {"unet_params": (tunet.param_specs(CFG.unet), up),
             "vae_params": (tvae.param_specs(CFG.vae), vp)}
    n_f32 = 0
    for part, (specs, jax_tree) in trees.items():
        for path, spec in _spec_leaves(specs):
            leaf = _at(getattr(ms, part), path)
            fused = (path[-2] in ("norm1", "norm2") or
                     (path[-2] in ("conv1", "conv2") and path[-1] == "b"))
            assert spec.f32 == fused, path
            if not fused:
                assert leaf.dtype == torch.bfloat16, path
                continue
            n_f32 += 1
            assert leaf.dtype == torch.float32, path
            bf16 = (leaf.to(torch.bfloat16) if source == "random_preset"
                    else torch.tensor(np.asarray(_at(jax_tree, path),
                                                 np.float32),
                                      dtype=torch.bfloat16))
            assert torch.equal(leaf, bf16.float()), path
    resnets = sum(1 for part in ("unet_params", "vae_params")
                  for path, _ in _spec_leaves(trees[part][0])
                  if path[-2:] == ("norm1", "scale"))
    assert resnets > 0 and n_f32 == 6 * resnets
