"""Hinted generation end to end: the port's UnifiedPipeline with ControlNet
and T2I-adapter hints against the JAX package's on the SD_TEST preset, f32,
the same weights through the bridges and the JAX package's noise injected
(as tests/test_torch_pipeline.py). Each case at every hint priority
(balanced; prompt: soft injection; hint: soft injection and cfg_only),
a masked hint and two hints; images within 2e-3 absolute in [0, 1].

Under the hires fix the JAX package fails on the shapes (its low-resolution
pass adds the target size's hint embedding); the port gives the low pass
the hint at its own size (ROADMAP queue 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gyre_tpu.models import configs
from gyre_tpu.models import modelset as jms
from gyre_tpu.models import t2i_adapter as jt2i
from gyre_tpu.pipeline import unified as junified
from gyre_tpu_torch.models import modelset as tms
from gyre_tpu_torch.pipeline import modes as tmodes
from gyre_tpu_torch.pipeline import unified as tunified
from test_torch_hints import T2I_CHANNELS, UCFG, _np, live_controlnet
from test_torch_modes import one_torch_thread  # noqa: F401
from test_torch_pipeline import _jax_noise

CFG = configs.SD_TEST
REQUEST = dict(prompt="a (red:1.2) boat at [dusk]", negative_prompt="blurry",
               height=64, width=64, steps=3, sampler="k_dpmpp_2m",
               guidance_scale=7.5, seeds=[3])
PRIORITIES = {"balanced": {},
              "prompt": {"soft_injection": True},
              "hint": {"soft_injection": True, "cfg_only": True}}


@pytest.fixture(scope="module")
def setup():
    """(JAX pipeline, port pipeline, {name: (JAX params, port params,
    kind)}, hint images)."""
    ms = jms.random_modelset(CFG, seed=0, dtype=jnp.float32)
    tm = tms.from_jax_params(_np(ms.unet_params), _np(ms.vae_params),
                             [_np(t) for t in ms.text_params], CFG,
                             device="cpu")
    models = {}
    for name, seed in (("cn_a", 0), ("cn_b", 1)):
        jp = live_controlnet(seed)
        models[name] = (jp, tms.controlnet_from_jax(_np(jp), UCFG,
                                                    device="cpu"),
                        "controlnet")
    ja = jt2i.init(jax.random.PRNGKey(2), channels=T2I_CHANNELS)
    models["t2i"] = (ja, tms.t2i_adapter_from_jax(_np(ja), device="cpu"),
                     "t2i")
    r = np.random.default_rng(0)
    images = [r.random((1, 64, 64, 3), np.float32) for _ in range(2)]
    return (junified.UnifiedPipeline(ms, compute_dtype=jnp.float32),
            tunified.UnifiedPipeline(tm, compute_dtype=torch.float32),
            models, images)


def _hints(models, images, spec, side):
    """spec: [(model name, image index, extra hint keys)]."""
    out = []
    for name, i, extra in spec:
        jp, tp, kind = models[name]
        out.append(dict(params=jp if side == "jax" else tp, kind=kind,
                        image=images[i], scale=0.9, **extra))
    return out


@pytest.fixture(scope="module")
def jax_image(setup):
    """case (None: no hint) -> the JAX package's image, made once."""
    jpipe, _, models, images = setup
    made = {}

    def get(case):
        if case not in made:
            spec = CASES[case] if case else []
            made[case] = np.asarray(jpipe(
                hints=_hints(models, images, spec, "jax") or None,
                **REQUEST))
        return made[case]
    return get


CASES = {
    **{f"controlnet_{p}": [("cn_a", 0, kw)] for p, kw in PRIORITIES.items()},
    **{f"t2i_{p}": [("t2i", 0, kw)] for p, kw in PRIORITIES.items()},
    "two_controlnets": [("cn_a", 0, {}), ("cn_b", 1, PRIORITIES["hint"])],
    "controlnet_and_t2i": [("cn_a", 0, PRIORITIES["prompt"]),
                           ("t2i", 1, {})],
    "masked_controlnet": [("cn_a", 0, {"mask": np.tile(
        np.linspace(0, 1, 64, dtype=np.float32)[None, :, None, None],
        (1, 1, 64, 1))})],
}


# for each case, the cases whose JAX images it must differ from by 10x the
# tolerance, so that a port that dropped the hint, or weighted or masked it
# as another case does, fails the parity check
RIVALS = {
    **{f"{m}_{p}": [None] + [f"{m}_{q}" for q in PRIORITIES if q != p]
       for m in ("controlnet", "t2i") for p in PRIORITIES},
    "two_controlnets": [None, "controlnet_balanced"],
    "controlnet_and_t2i": [None, "controlnet_prompt", "t2i_balanced"],
    "masked_controlnet": [None, "controlnet_balanced"],
}
TOL = 2e-3


@pytest.mark.parametrize("case", list(CASES))
def test_hinted_image_matches_jax(setup, jax_image, monkeypatch, case):
    _, tpipe, models, images = setup
    ref = jax_image(case)
    for rival in RIVALS[case]:
        assert np.abs(ref - jax_image(rival)).max() >= 10 * TOL, rival
    monkeypatch.setattr(tmodes, "txt2img_initial", _jax_noise)
    out = tpipe(hints=_hints(models, images, CASES[case], "port"),
                **REQUEST).numpy()
    assert out.shape == ref.shape == (1, 64, 64, 3)
    assert np.abs(out - ref).max() <= TOL


def test_priorities_differ_and_a_zero_mask_is_no_hint(setup, monkeypatch):
    _, tpipe, models, images = setup
    monkeypatch.setattr(tmodes, "txt2img_initial", _jax_noise)
    base = tpipe(**REQUEST)
    outs = {p: tpipe(hints=_hints(models, images, [("cn_a", 0, kw)],
                                  "port"), **REQUEST)
            for p, kw in PRIORITIES.items()}
    for a in outs:
        assert float((outs[a] - base).abs().max()) > 1e-3
        for b in outs:
            assert a == b or not torch.equal(outs[a], outs[b])
    zero = np.zeros((1, 64, 64, 1), np.float32)
    masked = tpipe(hints=_hints(models, images, [
        ("cn_a", 0, {"mask": zero}), ("t2i", 1, {"mask": zero})], "port"),
        **REQUEST)
    assert torch.equal(masked, base)


def test_hires_fix_with_a_hint(setup):
    """Under the hires fix the port conditions both passes (the low one
    with the hint image at its own size); the JAX package raises."""
    jpipe, tpipe, models, images = setup
    big = dict(REQUEST, height=128, width=128, hires_fix=True, steps=2)
    for spec in ([("cn_a", 0, PRIORITIES["hint"])], [("t2i", 0, {})]):
        with pytest.raises(TypeError, match="incompatible shapes"):
            jpipe(hints=_hints(models, [np.repeat(np.repeat(
                images[0], 2, 1), 2, 2)], spec, "jax"), **big)
        hint = _hints(models, [np.repeat(np.repeat(images[0], 2, 1), 2, 2)],
                      spec, "port")
        out = tpipe(hints=hint, **big)
        plain = tpipe(**big)
        assert out.shape == (1, 128, 128, 3)
        assert bool(out.isfinite().all())
        assert float((out - plain).abs().max()) > 1e-3
