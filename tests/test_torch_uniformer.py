"""The port's UniFormer segmentation (gyre_tpu_torch/models/uniformer.py)
against the JAX package's, in f32 on the CPU on the same weights, at
UNIFORMER_TEST width and at a small config with 64-wide heads (what the
mmseg loader assumes): the JAX params through the strict bridge, an mmseg
checkpoint with random BatchNorm statistics through both loaders, the
port's export read back by the JAX loader, and the segmentation engine
through both managers. The attention runs through the port's plain twin
on the CPU (what K1 is held to on the card). Class logits within 1e-3 of
the JAX package's; the palette renders equal; the PSP bins equal the JAX
package's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from gyre_tpu.manager.manager import EngineManager as JManager
from gyre_tpu.models import uniformer as ju
from gyre_tpu_torch.manager.manager import EngineManager as TManager
from gyre_tpu_torch.models import modelset as tms
from gyre_tpu_torch.models import uniformer as tu
from test_torch_modes import one_torch_thread  # noqa: F401

TOL = 1e-3
IMG = np.random.default_rng(11).random((2, 64, 48, 3)).astype(np.float32)
# two SA heads of 64 in stage 3, one in stage 4 (load_uniformer's default
# head_dim), small enough for the CPU
SMALL = tu.UniFormerConfig(layers=(1, 1, 2, 1), embed_dim=(16, 32, 128, 64),
                           head_dim=64, num_classes=12, fpn_channels=16)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jcfg(cfg):
    return ju.UniFormerConfig(**dataclasses.asdict(cfg))


def _logits_fn(cfg):
    jcfg = _jcfg(cfg)

    def logits(p, x):
        xn = (x - jnp.asarray(ju.IMAGE_MEAN)) / jnp.asarray(ju.IMAGE_STD)
        lg = ju.head_apply(p["head"], jcfg,
                           ju.backbone_apply(p["backbone"], jcfg, xn))
        return jax.image.resize(lg, (x.shape[0], *x.shape[1:3],
                                     lg.shape[-1]), "bilinear")

    return jax.jit(logits)


def _check(jparams, cfg, model):
    ref = _logits_fn(cfg)(jparams, IMG)
    with torch.no_grad():
        got = model.logits(torch.from_numpy(IMG))
        render = model(torch.from_numpy(IMG))
    assert tuple(got.shape) == (2, 64, 48, cfg.num_classes)
    assert float(np.abs(np.asarray(ref) - got.numpy()).max()) <= TOL
    # the render: the palette of the argmax (equal where the logits' top
    # two are apart by more than their difference)
    jren = jax.jit(lambda p, x: ju.apply(p, x, _jcfg(cfg)))(jparams, IMG)
    top2 = np.sort(np.asarray(ref), axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2 * TOL
    assert clear.mean() > 0.5
    assert np.array_equal(np.asarray(jren)[clear], render.numpy()[clear])
    assert len(np.unique(render.numpy().reshape(-1, 3), axis=0)) > 1


def test_bridge_matches_jax_at_test_width():
    cfg = tu.UNIFORMER_TEST
    jparams = _np(jax.jit(ju.init, static_argnums=1)(jax.random.PRNGKey(0),
                                                      _jcfg(cfg)))
    _check(jparams, cfg, tms.uniformer_from_jax(jparams, cfg,
                                                device="cpu"))
    extra = dict(jparams, extra={"w": np.zeros(2, np.float32)})
    with pytest.raises(ValueError, match="extra"):
        tms.uniformer_from_jax(extra, cfg, device="cpu")


@pytest.fixture(scope="module")
def mmseg_state():
    """An mmseg checkpoint at SMALL: the port's export of a random model,
    then random BatchNorm statistics (CBlock norm1/norm2 before conv1 and
    fc1, the head's after its convs), an auxiliary head and a
    "state_dict." prefix, as published files carry them."""
    model = tu.random_uniformer(SMALL, 3, device="cpu")
    state = tu.state_dict_uniformer(model)
    rng = np.random.default_rng(4)
    for bn in [k[:-len(".running_var")] for k in state
               if k.endswith(".running_var")]:
        c = state[f"{bn}.weight"].shape
        state[f"{bn}.weight"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        state[f"{bn}.bias"] = rng.uniform(-0.2, 0.2, c).astype(np.float32)
        state[f"{bn}.running_mean"] = rng.uniform(-0.2, 0.2, c).astype(
            np.float32)
        state[f"{bn}.running_var"] = rng.uniform(0.5, 1.5, c).astype(
            np.float32)
    state["auxiliary_head.conv_seg.weight"] = np.zeros((12, 8, 1, 1),
                                                       np.float32)
    return {"state_dict." + k: v for k, v in state.items()}


def test_mmseg_checkpoint_loads_as_in_jax(mmseg_state):
    jparams, jcfg = ju.load_uniformer(mmseg_state)
    jparams = _np(jparams)
    model, cfg = tu.load_uniformer(mmseg_state, device="cpu")
    assert dataclasses.astuple(cfg) == dataclasses.astuple(jcfg)
    assert cfg == SMALL
    _check(jparams, cfg, model)
    bridged = tms.uniformer_from_jax(jparams, cfg, device="cpu")
    for (n, a), (_, b) in zip(model.named_parameters(),
                              bridged.named_parameters()):
        assert float((a - b).detach().abs().max()) <= 1e-6, n


def test_export_round_trip(mmseg_state):
    """The export of a loaded model, read by the JAX loader, is the tree
    the original checkpoint gave (BatchNorms folded, identities in their
    place)."""
    model, _ = tu.load_uniformer(mmseg_state, device="cpu")
    ref = _np(ju.load_uniformer(mmseg_state)[0])
    again = _np(ju.load_uniformer(tu.state_dict_uniformer(model))[0])
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(again)):
        assert np.abs(a - b).max() <= 1e-5 * max(1.0, np.abs(a).max())


@pytest.mark.parametrize("k,n", [(1, 7), (2, 7), (3, 7), (6, 7), (6, 13),
                                 (3, 2)])
def test_adaptive_pool_bins_match_jax(k, n):
    x = np.random.default_rng(k * n).random((1, n, n + 1, 3)).astype(
        np.float32)
    ref = ju._adaptive_pool(jnp.asarray(x), k)
    got = tu.adaptive_pool(torch.from_numpy(x), k)
    assert tuple(got.shape) == (1, k, k, 3)
    assert float(np.abs(np.asarray(ref) - got.numpy()).max()) <= 1e-6


def test_segmentation_engine_matches_jax(mmseg_state, tmp_path):
    """config/engines/utility.yaml's segmentation engine over the
    checkpoint through both managers: the same render where the class is
    clear; ready, "real"; without weights, random at UNIFORMER_TEST."""
    path = str(tmp_path / "uni.safetensors")
    save_file(mmseg_state, path)
    spec = [{"id": "segmentation", "task": "segmentation", "model": path},
            {"id": "seg2", "task": "segmentation", "model": "@nowhere"}]
    tm = TManager(spec, device="cpu", compute_dtype=torch.float32)
    jm = JManager(spec[:1], compute_dtype=jnp.float32)
    try:
        tm.load_engines()
        ref = np.asarray(jm.task_pipeline("segmentation")(IMG[:1]))
        got = tm.task_pipeline("segmentation")(IMG[:1]).numpy()
        assert got.shape == (1, 64, 48, 3)
        assert (ref == got).all(axis=-1).mean() >= 0.95
        assert all(s["ready"] for s in tm.status())
        rnd = tm.task_pipeline("segmentation", "seg2")
        assert rnd.models[0].cfg == tu.UNIFORMER_TEST
        assert tuple(rnd(IMG[:1]).shape) == (1, 64, 48, 3)
        assert [s["weights"] for s in tm.status()] == ["real", "random"]
    finally:
        tm.dispatcher.stop()
        jm.dispatcher.stop()


def test_bf16_path_runs_on_the_plain_attention():
    """In bf16 on the CPU the SA stages take the attention's plain twin
    (on the card, K1): logits finite, close to f32."""
    f32 = tu.random_uniformer(SMALL, 1, torch.float32, "cpu")
    b16 = tu.random_uniformer(SMALL, 1, torch.bfloat16, "cpu")
    with torch.no_grad():
        a = f32.logits(torch.from_numpy(IMG[:1]))
        b = b16.logits(torch.from_numpy(IMG[:1]))
    assert b.dtype == torch.float32 and torch.isfinite(b).all()
    assert float((a - b).abs().max()) <= 2e-2 * float(a.abs().max())
