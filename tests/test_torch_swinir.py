"""The port's SwinIR (gyre_tpu_torch/models/swinir.py) against the JAX
package's, in f32 on the CPU on the same weights (the JAX params from a
seed through the strict bridge): the window helpers and the NHWC pixel
shuffle exactly, the model within 1e-3 of max |JAX| for each of its four
upsamplers and the 3conv residual at SWINIR_TEST, on an image that is not
a window multiple; the BasicSR-layout export read back by the JAX loader
(the same tree and derived config) and by the port's strict loader."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gyre_tpu.models import swinir as js
from gyre_tpu_torch.models import modelset as tms
from gyre_tpu_torch.models import swinir as ts
from test_torch_modes import one_torch_thread  # noqa: F401

TOL = 1e-3          # a model's output against the JAX package's
W_TOL = 1e-6        # a loaded weight against the other loader's

IMG = np.random.default_rng(0).random((2, 13, 10, 3)).astype(np.float32)

CASES = {                      # (upsampler, resi, scale)
    "nearest+conv": ("nearest+conv", "1conv", 4),
    "nearest+conv-3conv": ("nearest+conv", "3conv", 4),
    "pixelshuffle": ("pixelshuffle", "1conv", 4),
    "pixelshuffledirect": ("pixelshuffledirect", "1conv", 2),
    "denoise": ("", "3conv", 1),
}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _err(ref, got):
    ref = np.asarray(ref)
    return float(np.abs(ref - got.detach().numpy()).max()) / \
        float(np.abs(ref).max())


def _port_cfg(cfg):
    return ts.SwinIRConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    up, resi, scale = CASES[request.param]
    cfg = dataclasses.replace(js.SWINIR_TEST, upsampler=up, resi=resi,
                              scale=scale)
    params = _np(js.init(jax.random.PRNGKey(1), cfg))
    ref = np.asarray(js.apply(params, jnp.asarray(IMG), cfg))
    return cfg, params, ref


def _run(model, x=IMG):
    with torch.no_grad():
        return model(torch.from_numpy(x))


def test_window_helpers_match_jax():
    x = np.random.default_rng(1).standard_normal((2, 8, 12, 5)) \
        .astype(np.float32)
    wins = ts.window_partition(torch.from_numpy(x), 4)
    ref = np.asarray(js._window_partition(jnp.asarray(x), 4))
    assert np.array_equal(wins.numpy(), ref)
    back = ts.window_reverse(wins, 4, 8, 12)
    assert np.array_equal(back.numpy(), x)
    assert np.array_equal(
        np.asarray(js._window_reverse(jnp.asarray(ref), 4, 8, 12)), x)
    for w in (4, 8, 12):
        assert np.array_equal(ts.rel_pos_index(w), js._rel_pos_index(w))
    for r in (2, 3):
        y = np.random.default_rng(r).standard_normal((1, 5, 6, 4 * r * r)) \
            .astype(np.float32)
        assert np.array_equal(
            ts.pixel_shuffle(torch.from_numpy(y), r).numpy(),
            np.asarray(js._pixel_shuffle(jnp.asarray(y), r)))
        # and torch's own PixelShuffle on the NCHW view
        want = torch.nn.functional.pixel_shuffle(
            torch.from_numpy(y).permute(0, 3, 1, 2), r).permute(0, 2, 3, 1)
        assert torch.equal(ts.pixel_shuffle(torch.from_numpy(y), r), want)


def test_shift_mask_is_the_jax_fill():
    """The shifted block's cross-region mask: where JAX fills -1e9."""
    h, w, win, shift = 8, 12, 4, 2
    cross = ts.cross_region(h, w, win, shift, "cpu").numpy()
    img_mask = np.zeros((1, h, w, 1), np.float32)
    cnt = 0
    for hs in (slice(0, -win), slice(-win, -shift), slice(-shift, None)):
        for ws in (slice(0, -win), slice(-win, -shift), slice(-shift, None)):
            img_mask[:, hs, ws] = cnt
            cnt += 1
    mw = np.asarray(js._window_partition(jnp.asarray(img_mask), win))[..., 0]
    assert np.array_equal(cross, mw[:, None, :] != mw[:, :, None])
    assert cross.any() and not cross.all()


def test_bridge_matches_jax(case):
    cfg, params, ref = case
    got = _run(tms.swinir_from_jax(params, _port_cfg(cfg), device="cpu"))
    assert tuple(got.shape) == ref.shape == \
        (2, 13 * cfg.scale, 10 * cfg.scale, 3)
    assert _err(ref, got) <= TOL
    assert float(got.std()) > 1e-3


def test_export_reads_back_in_both_loaders(case):
    """The export is the BasicSR layout: the JAX loader reads it back to
    the tree it came from and derives the same architecture; the port's
    loader gives the same output."""
    cfg, params, ref = case
    model = tms.swinir_from_jax(params, _port_cfg(cfg), device="cpu")
    state = ts.state_dict_swinir(model)
    assert "layers.0.residual_group.blocks.1.attn." \
        "relative_position_bias_table" in state
    assert "layers.0.residual_group.blocks.0.attn." \
        "relative_position_index" in state
    jp, jcfg = js.load_swinir(state)
    assert jax.tree.structure(jp) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(params)):
        assert np.abs(np.asarray(a) - b).max() <= W_TOL
    again, tcfg = ts.load_swinir(
        {k: torch.from_numpy(np.asarray(v)) for k, v in state.items()},
        device="cpu")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert _err(ref, _run(again)) <= TOL


def test_loader_is_strict():
    cfg = js.SWINIR_TEST
    model = ts.random_swinir(_port_cfg(cfg), 3, device="cpu")
    state = ts.state_dict_swinir(model)
    state["layers.1.residual_group.blocks.0.attn_mask"] = np.zeros(3)
    ts.load_swinir(state, device="cpu")                  # buffers are fine
    with pytest.raises(KeyError, match="mystery"):
        ts.load_swinir(dict(state, mystery=np.zeros(3, np.float32)),
                       device="cpu")
    missing = {k: v for k, v in state.items() if k != "conv_hr.bias"}
    with pytest.raises(ValueError, match="conv_hr.bias"):
        ts.load_swinir(missing, device="cpu")
    wrong = dict(state, **{"conv_hr.weight": np.zeros((8, 8, 1, 1),
                                                      np.float32)})
    with pytest.raises(ValueError, match="shape"):
        ts.load_swinir(wrong, device="cpu")
    # BasicSR's .pth nesting
    wrapped = {"params_ema": state}
    assert ts.load_swinir(wrapped, device="cpu")[1] == _port_cfg(cfg)


def test_bridge_is_strict():
    cfg = js.SWINIR_TEST
    params = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                          jax.eval_shape(lambda: js.init(
                              jax.random.PRNGKey(0), cfg)))
    with pytest.raises(ValueError, match="mystery"):
        tms.swinir_from_jax(dict(params, mystery={"w": np.zeros(2)}),
                            _port_cfg(cfg), device="cpu")
    short = dict(params, groups=params["groups"][:1])
    with pytest.raises(ValueError, match="groups.1"):
        tms.swinir_from_jax(short, _port_cfg(cfg), device="cpu")
    wrong = jax.tree.map(np.copy, params)
    wrong["groups"][0]["blocks"][0]["rpb"] = np.zeros((3, 2), np.float32)
    with pytest.raises(ValueError, match="shape"):
        tms.swinir_from_jax(wrong, _port_cfg(cfg), device="cpu")


@pytest.mark.parametrize("name", ["SWINIR_M_REAL", "SWINIR_L_REAL",
                                  "SWINIR_CLASSICAL", "SWINIR_TEST"])
def test_presets_and_widths_match_jax(name):
    """The presets are the JAX package's, and the port's model holds as
    many parameters as the JAX init (the shipped swinir-x4 is
    SWINIR_CLASSICAL: 11.9 M)."""
    cfg = getattr(js, name)
    assert dataclasses.asdict(getattr(ts, name)) == dataclasses.asdict(cfg)
    shapes = jax.eval_shape(lambda: js.init(jax.random.PRNGKey(0), cfg))
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    with torch.device("meta"):
        model = ts.SwinIR(getattr(ts, name))
    assert sum(p.numel() for p in model.parameters()) == n_jax
