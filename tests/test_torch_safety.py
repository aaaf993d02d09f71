"""The port's safety checker (gyre_tpu_torch.pipeline.safety) against the
JAX package's on the same diffusers-layout weights (f32 on the CPU:
scores within 1e-4, flags equal), its strict loader and export, the
manager's checker, and the servicer under nsfw_behaviour ignore, flag and
block (mirroring tests/test_safety.py).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gyre_tpu.models import clip as jclip
from gyre_tpu.pipeline.safety import SafetyChecker as JChecker
from gyre_tpu_torch.generated import generation_pb2 as tpb
from gyre_tpu_torch.http.router import FakeGrpcContext as TContext
from gyre_tpu_torch.manager.manager import EngineManager as TManager
from gyre_tpu_torch.models.load import write_safetensors
from gyre_tpu_torch.ops import images as timages
from gyre_tpu_torch.pipeline.safety import SafetyChecker as TChecker
from gyre_tpu_torch.services import generate as tgen
from test_safety import IMG, PROJ, synth_safety_state
from test_torch_modes import one_torch_thread  # noqa: F401


def _np(t):
    return np.asarray(t.detach().cpu().numpy() if torch.is_tensor(t) else t)


def synth_state():
    """tests/test_safety.py's checker layout and embeddings over a tower
    whose weights are the port's random init (larger than that file's
    0.02 normals, so that distinct images embed apart), f32 numpy."""
    state = {k: np.asarray(v) for k, v in synth_safety_state().items()
             if "embeds" in k}
    tower = TChecker.random(seed=3, device="cpu").state_dict()
    state.update({k: v.numpy() for k, v in tower.items()
                  if "embeds" not in k})
    return state


def _state():
    return {k: torch.from_numpy(v) for k, v in synth_state().items()}


def jax_scores(chk, images):
    """The JAX checker's scores (check's arithmetic before the threshold
    test), from its own tower."""
    imgs = jnp.asarray(images)
    import jax

    imgs = jax.image.resize(imgs, (imgs.shape[0], IMG, IMG, 3), "bilinear")
    emb = jclip.vision_apply(chk.vision_params, chk.vision_cfg,
                             jclip.preprocess_image(imgs))["image_embeds"]
    emb = emb / jnp.maximum(jnp.linalg.norm(emb, axis=-1, keepdims=True),
                            1e-8)

    def cos(e):
        return emb @ (e / jnp.maximum(jnp.linalg.norm(e, axis=-1,
                                                      keepdims=True),
                                      1e-8)).T

    adj = jnp.zeros((emb.shape[0], 1))
    if chk.special_embeds is not None:
        special = cos(chk.special_embeds) - chk.special_thresholds[None]
        adj = jnp.where((special > 0).any(axis=-1, keepdims=True), 0.01, 0.0)
    return np.asarray(cos(chk.concept_embeds) - chk.concept_thresholds[None]
                      + adj)


@pytest.fixture(scope="module")
def checkers():
    return (JChecker.from_state_dict(synth_state()),
            TChecker.from_state_dict(_state(), torch.float32, "cpu"))


def _hot(checkers, imgs):
    """Both checkers with concept 0 set to imgs[0]'s embedding, a
    special-care concept that fires on every image (+0.01), and every
    concept threshold halfway between imgs[0]'s cosine (1) and the
    largest of the others' with it: imgs[0] flags, the others do not."""
    jchk, tchk = checkers
    emb = _np(tchk.embed(imgs))
    near = float((emb[1:] @ emb[0]).max())
    concepts = np.asarray(jchk.concept_embeds).copy()
    concepts[0] = emb[0]
    cut = np.full(len(concepts), (1 + near) / 2 + 0.01, np.float32)
    jhot = dataclasses.replace(jchk, concept_embeds=jnp.asarray(concepts),
                               concept_thresholds=jnp.asarray(cut),
                               special_embeds=jnp.asarray(emb[:1]),
                               special_thresholds=jnp.asarray([0.5]))
    thot = dataclasses.replace(
        tchk, concept_embeds=torch.from_numpy(concepts),
        concept_thresholds=torch.from_numpy(cut),
        special_embeds=torch.from_numpy(emb[:1].copy()),
        special_thresholds=torch.tensor([0.5]))
    return jhot, thot


@pytest.mark.parametrize("case", ["random", "concept_matched"])
def test_check_matches_jax(checkers, case):
    """Scores within 1e-4 and flags equal, on random 48² images (resized
    to the tower's 32², antialiased) and with a concept set to an image's
    own embedding (it and only it flagged; the special-care margin in)."""
    imgs = np.random.default_rng(1).random((3, 48, 48, 3)).astype(
        np.float32)
    jchk, tchk = checkers if case == "random" else _hot(checkers, imgs)
    ref, got = jax_scores(jchk, imgs), _np(tchk.scores(imgs))
    assert got.shape == (3, 17)
    assert np.abs(got - ref).max() <= 1e-4
    assert (tchk.check(imgs) == jchk.check(imgs)).all()
    if case == "concept_matched":
        assert tchk.check(imgs).tolist() == [True, False, False]
        # the margins are wider than the bound
        assert np.sort(np.abs(got[:, 0]))[0] > 1e-3


def test_from_state_dict_is_strict_and_state_dict_reads_back(checkers):
    _, tchk = checkers
    assert tchk.trained and tchk.vision_cfg.projection_dim == PROJ
    assert tchk.concept_embeds.shape == (17, PROJ)
    assert tchk.special_embeds.shape == (3, PROJ)
    back = TChecker.from_state_dict(tchk.state_dict(), torch.float32, "cpu")
    imgs = np.random.default_rng(2).random((2, 40, 40, 3)).astype(
        np.float32)
    assert torch.equal(back.scores(imgs), tchk.scores(imgs))
    assert set(tchk.state_dict()) == set(_state())
    with pytest.raises(KeyError, match="concept_embeds"):
        TChecker.from_state_dict({k: v for k, v in _state().items()
                                  if "concept" not in k}, torch.float32,
                                 "cpu")
    with pytest.raises(KeyError, match="unread"):
        TChecker.from_state_dict(dict(_state(), stray=torch.zeros(1)),
                                 torch.float32, "cpu")
    rnd = TChecker.random(device="cpu")
    assert not rnd.trained and rnd.check(imgs).shape == (2,)


def _manager(spec_extra=None, **kw):
    spec = {"id": "tiny", "model": "preset/test", "default": True}
    spec.update(spec_extra or {})
    return TManager([spec], device="cpu", compute_dtype=torch.float32,
                    batch_max=2, **kw)


def _request(seeds=(3, 4)):
    req = tpb.Request(engine_id="tiny", request_id="s")
    req.prompt.add().text = "a boat"
    img = req.image
    img.height, img.width, img.steps = 64, 64, 2
    img.samples = len(seeds)
    img.seed.extend(seeds)
    return req


def _images(answers):
    """(uint8 image, finish_reason) of each answer."""
    return [(np.round(timages.decode_png(a.artifacts[0].binary)[0] * 255.0
                      ).astype(np.uint8), a.artifacts[0].finish_reason)
            for a in answers]


def test_block_mode_fails_closed_without_trained_weights():
    m = _manager()
    try:
        svc = tgen.GenerationServiceServicer(m, batch_max=1,
                                             nsfw_behaviour="block")
        with pytest.raises(RuntimeError, match="trained safety-checker"):
            svc._safety_check(np.zeros((1, 64, 64, 3), np.float32))
        flag = tgen.GenerationServiceServicer(m, batch_max=1)
        assert not flag._safety_check(np.zeros((2, 64, 64, 3),
                                               np.float32)).any()
    finally:
        m.dispatcher.stop()


# two distinct images: the test preset's 2-step images are near constant,
# so that no concept can tell them apart
SERVED = (np.random.default_rng(9).random((2, 64, 64, 3)) * 255).astype(
    np.uint8)


def _serve(m, mode):
    """The answers of a 2-image request under ``mode``, the engine standing
    in with SERVED (the servicer, the checker and the dispatcher run as
    they are)."""
    from contextlib import contextmanager

    @contextmanager
    def with_engine(*_, **__):
        yield lambda **kw: torch.from_numpy(SERVED[:len(kw["seeds"])])

    m.with_engine = with_engine
    return _images(tgen.GenerationServiceServicer(
        m, nsfw_behaviour=mode).Generate(_request(), TContext()))


def test_servicer_ignore_flag_block(tmp_path, checkers):
    """Two images of one request: under "ignore" both served as they are;
    a checker whose concept is the first image's embedding, configured by
    a `safety_checker:` key, flags that one (FILTER) under "flag" and
    blacks it out under "block"; the other is served as it is."""
    m = _manager()
    try:
        plain = _serve(m, "ignore")
    finally:
        m.dispatcher.stop()
    assert [r for _, r in plain] == [tpb.NULL, tpb.NULL]
    assert all(np.array_equal(p, q) for (p, _), q in zip(plain, SERVED))
    _, thot = _hot(checkers, SERVED.astype(np.float32) / 255.0)
    path = tmp_path / "checker.safetensors"
    write_safetensors(str(path), thot.state_dict())
    m = _manager({"safety_checker": str(path)})
    try:
        assert m.safety_checker().trained
        for mode in ("flag", "block"):
            got = _serve(m, mode)
            assert [r for _, r in got] == [tpb.FILTER, tpb.NULL]
            assert np.array_equal(got[1][0], SERVED[1])
            if mode == "flag":
                assert np.array_equal(got[0][0], SERVED[0])
            else:
                assert not got[0][0].any()
    finally:
        m.dispatcher.stop()


def test_manager_checker_from_spec(tmp_path, checkers):
    """A `task: safety` engine's model loads as the trained checker; one
    that resolves and does not load raises (the JAX manager warns and
    serves without); one that does not resolve gives None."""
    _, tchk = checkers
    good = tmp_path / "good"
    good.mkdir()
    write_safetensors(str(good / "model.safetensors"), tchk.state_dict())
    m = TManager([{"id": "tiny", "model": "preset/test"},
                  {"id": "safety", "task": "safety", "model": str(good)}],
                 device="cpu", compute_dtype=torch.float32)
    assert m.safety_checker().trained
    assert m.safety_checker() is m.safety_checker()
    m.dispatcher.stop()
    bad = tmp_path / "bad.safetensors"
    write_safetensors(str(bad), {"x": torch.zeros(2)})
    m = _manager({"safety_checker": str(bad)})
    with pytest.raises(KeyError):
        m.safety_checker()
    m.dispatcher.stop()
    m = _manager({"safety_checker": str(tmp_path / "missing")})
    assert m.safety_checker() is None
    m.dispatcher.stop()
