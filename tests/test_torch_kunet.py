"""The sd-x2 latent upscaler's k-UNet (gyre_tpu_torch.models.kunet)
against the JAX package's gyre_tpu/models/kunet.py on the CPU in f32:
``apply`` at X2_TEST (the JAX random tree bridged) and at the torch
oracle's config (tests/torch_oracles.py's KUnet, published KBlock key
names, read by both loaders), 1e-3 as for the other models; the blur
resampling at even and odd sizes (1e-5: exactly H // 2 and 2H); the strict
loader (an unknown, a missing or a misshapen key raises); the export,
read back by both loaders; the strict bridge; and a ModelSet holding a
k-UNet saved as a diffusers directory and loaded back.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gyre_tpu.models import kunet as jk
from gyre_tpu_torch.models import configs as tconfigs
from gyre_tpu_torch.models import kunet as tk
from gyre_tpu_torch.models import load as tload
from gyre_tpu_torch.models import modelset as tms
from test_torch_modes import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def oracle_state():
    from torch_oracles import KUnet

    torch.manual_seed(0)
    net = KUnet(boc=(64, 128), layers=2, cross_dim=96, head_dim=64,
                group_size=32).eval()
    return {k: v.detach().clone() for k, v in net.state_dict().items()}


def _inputs(cfg, seed=0, size=16):
    rs = np.random.RandomState(seed)
    x = rs.rand(2, size, size, cfg.in_channels).astype(np.float32) * 2 - 1
    ctx = rs.rand(2, 7, cfg.cross_attention_dim).astype(np.float32)
    cn = np.asarray([0.25, -0.5], np.float32)     # 0.25 * ln(sigma)
    return x, cn, ctx


def _jax_apply(params, cfg, x, cn, ctx):
    run = jax.jit(lambda p, *a: jk.apply(p, cfg, *a))
    return np.asarray(run(params, jnp.asarray(x), jnp.asarray(cn),
                          jnp.asarray(ctx)))


def _port_apply(params, cfg, x, cn, ctx):
    with torch.no_grad():
        return tk.apply(params, cfg, torch.from_numpy(x),
                        torch.from_numpy(cn), torch.from_numpy(ctx)).numpy()


def _bridge(jparams, cfg):
    return tms._from_jax(tk.param_specs(cfg),
                         jax.tree.map(np.asarray, jparams), "unet",
                         torch.float32, torch.device("cpu"))


def test_apply_at_x2_test_matches_jax():
    jcfg = jk.X2_TEST
    jparams = jk.init(jax.random.PRNGKey(0), jcfg)
    tcfg = tk.X2_TEST
    # the configs field for field (the upscaler presets hold them, and
    # tests/test_torch_vendored.py compares the presets by asdict)
    for tc, jc in ((tcfg, jcfg), (tk.X2_DEFAULT, jk.X2_DEFAULT)):
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    args = _inputs(tcfg)
    want = _jax_apply(jparams, jcfg, *args)
    got = _port_apply(_bridge(jparams, tcfg), tcfg, *args)
    assert got.shape == want.shape == (2, 16, 16, 4)
    assert np.abs(got - want).max() <= 1e-3


def test_apply_at_the_oracle_config_matches_jax(oracle_state):
    np_state = {k: v.numpy() for k, v in oracle_state.items()}
    jparams, jcfg = jk.load_kunet(np_state)
    params, cfg = tk.load_kunet(oracle_state, torch.float32, "cpu")
    assert (cfg.block_out_channels, cfg.attn_levels, cfg.self_attn_levels,
            cfg.cross_attention_dim, cfg.head_dim, cfg.group_size) == (
        jcfg.block_out_channels, jcfg.attn_levels, jcfg.self_attn_levels,
        jcfg.cross_attention_dim, jcfg.head_dim, jcfg.group_size)
    args = _inputs(cfg, seed=1)
    want = _jax_apply(jparams, jcfg, *args)
    got = _port_apply(params, cfg, *args)
    assert np.abs(got - want).max() <= 1e-3
    assert np.abs(got).max() > 0.1


@pytest.mark.parametrize("h,w", [(8, 8), (7, 9), (6, 5), (2, 3)])
@pytest.mark.parametrize("fn", ["_blur_down", "_blur_up"])
def test_blur_resampling_matches_jax(fn, h, w):
    x = np.random.default_rng(h * 10 + w).random((2, h, w, 8)).astype(
        np.float32)
    want = np.asarray(getattr(jk, fn)(jnp.asarray(x)))
    got = getattr(tk, fn)(torch.from_numpy(x)).numpy()
    size = (h // 2, w // 2) if fn == "_blur_down" else (2 * h, 2 * w)
    assert got.shape == want.shape == (2, *size, 8)
    assert np.abs(got - want).max() <= 1e-5
    # a constant field stays constant
    ones = getattr(tk, fn)(torch.ones(1, h, w, 3))
    assert torch.allclose(ones, torch.ones_like(ones), atol=1e-6)


def test_strict_loader(oracle_state):
    with pytest.raises(KeyError, match="mystery"):
        tk.load_kunet(dict(oracle_state, **{"mystery.weight":
                                            torch.zeros(1)}),
                      torch.float32, "cpu")
    missing = dict(oracle_state)
    del missing["up_blocks.0.resnets.0.conv1.weight"]
    with pytest.raises(KeyError):
        tk.load_kunet(missing, torch.float32, "cpu")
    bad = dict(oracle_state)
    bad["down_blocks.1.attentions.0.attn2.to_v.weight"] = torch.zeros(3, 3)
    with pytest.raises(ValueError, match="attn2/v/w"):
        tk.load_kunet(bad, torch.float32, "cpu")


def test_export_reads_back_in_both_loaders(oracle_state):
    params, cfg = tk.load_kunet(oracle_state, torch.float32, "cpu")
    state = tk.state_dict_kunet(params, cfg)
    assert set(state) == set(oracle_state)
    for k, v in state.items():
        assert torch.equal(v, oracle_state[k]), k
    jparams, jcfg = jk.load_kunet({k: v.numpy() for k, v in state.items()})
    args = _inputs(cfg, seed=2, size=8)
    assert np.abs(_port_apply(params, cfg, *args) -
                  _jax_apply(jparams, jcfg, *args)).max() <= 1e-3


def test_bridge_is_strict():
    jparams = jax.tree.map(np.asarray, jk.init(jax.random.PRNGKey(1),
                                               jk.X2_TEST))
    specs = tk.param_specs(tk.X2_TEST)
    extra = dict(jparams, stray={"w": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="stray"):
        tms._from_jax(specs, extra, "unet", torch.float32,
                      torch.device("cpu"))
    missing = dict(jparams)
    del missing["time_emb2"]
    with pytest.raises(ValueError, match="time_emb2"):
        tms._from_jax(specs, missing, "unet", torch.float32,
                      torch.device("cpu"))
    bad = dict(jparams, time_proj=np.zeros(5, np.float32))
    with pytest.raises(ValueError, match="time_proj"):
        tms._from_jax(specs, bad, "unet", torch.float32,
                      torch.device("cpu"))


def test_modelset_saves_and_loads_a_kunet(tmp_path):
    """A k-UNet ModelSet (the upscaler-x2-test preset) written as a
    diffusers directory loads back through load_modelset: the k-upscaler
    config.json recognised, the UNet's dimensions from its shapes, its
    Fourier frequencies f32 and exact under a bf16 load."""
    from gyre_tpu_torch.pipeline import diffusion_upscaler as tdu

    ms = tms.random_modelset(tdu.X2_TEST_CONFIG, seed=4, dtype=torch.float32,
                             device="cpu")
    tload.save_modelset(ms, str(tmp_path / "x2"))
    back = tload.load_modelset(str(tmp_path / "x2"), tconfigs.SD15,
                               dtype=torch.float32, device="cpu")
    cfg = back.config.unet
    assert isinstance(cfg, tk.KUNetConfig)
    assert cfg.block_out_channels == tdu.X2_TEST_CONFIG.unet.block_out_channels
    assert back.config.vae == tdu.X2_TEST_CONFIG.vae
    for a, b in zip(tms._leaves(back.unet_params),
                    tms._leaves(ms.unet_params)):
        assert torch.equal(a, b)
    half = tload.load_modelset(str(tmp_path / "x2"), tconfigs.SD15,
                               dtype=torch.bfloat16, device="cpu")
    assert half.unet_params["time_proj"].dtype == torch.float32
    assert torch.equal(half.unet_params["time_proj"],
                       ms.unet_params["time_proj"])
    assert half.unet_params["conv_in"]["w"].dtype == torch.bfloat16
