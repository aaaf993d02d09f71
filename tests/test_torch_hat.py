"""The port's HAT (gyre_tpu_torch/models/hat.py) against the JAX
package's, in f32 on the CPU on the same weights (the JAX params from a
seed through the strict bridge): the overlapping-window index and the
overlapping K/V windows (torch's unfold against
conv_general_dilated_patches, channel-slowest) exactly, the additive -100
shift mask, the model within 1e-3 of max |JAX| at HAT_TEST on an image
that is not a window multiple; the published-layout export read back by
the JAX loader (the same tree and derived config) and by the port's
strict loader."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gyre_tpu.models import hat as jh
from gyre_tpu_torch.models import hat as th
from gyre_tpu_torch.models import modelset as tms
from gyre_tpu_torch.models import swinir as ts
from test_torch_modes import one_torch_thread  # noqa: F401

TOL = 1e-3
W_TOL = 1e-6

IMG = np.random.default_rng(0).random((2, 13, 10, 3)).astype(np.float32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _err(ref, got):
    ref = np.asarray(ref)
    return float(np.abs(ref - got.detach().numpy()).max()) / \
        float(np.abs(ref).max())


def _port_cfg(cfg):
    return th.HATConfig(**{f.name: getattr(cfg, f.name)
                           for f in dataclasses.fields(cfg)})


def _run(model):
    with torch.no_grad():
        return model(torch.from_numpy(IMG))


@pytest.fixture(scope="module")
def hat_case():
    cfg = jh.HAT_TEST
    params = _np(jh.init(jax.random.PRNGKey(2), cfg))
    ref = np.asarray(jh.apply(params, jnp.asarray(IMG), cfg))
    return cfg, params, ref


@pytest.mark.parametrize("ws,wse", [(4, 6), (16, 24), (8, 12)])
def test_overlap_windows_and_index_match_jax(ws, wse):
    assert np.array_equal(th.rpi_oca(ws, wse), jh._rpi_oca(ws, wse))
    x = np.random.default_rng(ws).standard_normal((2, 2 * ws, 3 * ws, 5)) \
        .astype(np.float32)
    got = th.overlap_windows(torch.from_numpy(x), ws, wse).numpy()
    ref = np.asarray(jh._overlap_kv_windows(jnp.asarray(x), ws, wse))
    assert got.shape == ref.shape == (2 * 6, wse * wse, 5)
    assert np.array_equal(got, ref)


def test_shift_mask_is_the_additive_jax_mask():
    mask = np.asarray(jh._shift_mask(8, 12, 4, 2))
    cross = ts.cross_region(8, 12, 4, 2, "cpu").numpy()
    assert np.array_equal(np.where(cross, -100.0, 0.0), mask)


def test_bridge_matches_jax(hat_case):
    cfg, params, ref = hat_case
    got = _run(tms.hat_from_jax(params, _port_cfg(cfg), device="cpu"))
    assert tuple(got.shape) == ref.shape == (2, 52, 40, 3)
    assert _err(ref, got) <= TOL
    assert float(got.std()) > 1e-3


def test_export_reads_back_in_both_loaders(hat_case):
    cfg, params, ref = hat_case
    model = tms.hat_from_jax(params, _port_cfg(cfg), device="cpu")
    state = th.state_dict_hat(model)
    assert "layers.1.residual_group.overlap_attn.qkv.weight" in state
    assert "layers.0.residual_group.blocks.1.conv_block.cab.3." \
        "attention.3.weight" in state
    jp, jcfg = jh.load_hat(state)
    assert jcfg == cfg
    assert jax.tree.structure(jp) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(params)):
        assert np.abs(np.asarray(a) - b).max() <= W_TOL
    again, tcfg = th.load_hat(
        {k: torch.from_numpy(np.asarray(v)) for k, v in state.items()},
        device="cpu")
    assert tcfg == _port_cfg(cfg)
    assert _err(ref, _run(again)) <= TOL


def test_loader_and_bridge_are_strict(hat_case):
    cfg, params, _ = hat_case
    state = th.state_dict_hat(th.random_hat(_port_cfg(cfg), 4, device="cpu"))
    with pytest.raises(KeyError, match="mystery"):
        th.load_hat(dict(state, mystery=np.zeros(3, np.float32)),
                    device="cpu")
    key = "layers.1.residual_group.overlap_attn.proj.bias"
    with pytest.raises(ValueError, match=key):
        th.load_hat({k: v for k, v in state.items() if k != key},
                    device="cpu")
    with pytest.raises(ValueError, match="mystery"):
        tms.hat_from_jax(dict(params, mystery={"w": np.zeros(2)}),
                         _port_cfg(cfg), device="cpu")
    wrong = jax.tree.map(np.copy, params)
    wrong["groups"][1]["ocab"]["rpb"] = np.zeros((4, 2), np.float32)
    with pytest.raises(ValueError, match="shape"):
        tms.hat_from_jax(wrong, _port_cfg(cfg), device="cpu")
    short = jax.tree.map(np.copy, params)
    del short["groups"][0]["blocks"][0]["cab"]["sq2"]
    with pytest.raises(ValueError, match="sq2"):
        tms.hat_from_jax(short, _port_cfg(cfg), device="cpu")


@pytest.mark.parametrize("name", ["HAT_M", "HAT_L", "HAT_TEST"])
def test_presets_and_widths_match_jax(name):
    """The presets are the JAX package's, and the port's model holds as
    many parameters as the JAX init (HAT-M x4: 20.8 M)."""
    cfg = getattr(jh, name)
    assert _port_cfg(cfg) == getattr(th, name)
    shapes = jax.eval_shape(lambda: jh.init(jax.random.PRNGKey(0), cfg))
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    with torch.device("meta"):
        model = th.HAT(getattr(th, name))
    assert sum(p.numel() for p in model.parameters()) == n_jax
