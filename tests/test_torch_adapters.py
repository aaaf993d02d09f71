"""The port's adapters (gyre_tpu_torch.pipeline.lora, the manager's adapted
views, the servicer's weight artifacts) against the JAX package on the CPU
at the SD_TEST preset in f32.

The same numpy state dicts, made from a seed, go through both packages:
each LoRA/LyCORIS format's folded tree equals the JAX fold carried over by
``from_jax_params`` within 1e-6 with the same count of applied modules, the
numpy-only functions equal their originals, a textual inversion gives the
same token table and ids, and a LoRA+TI image is within 2e-3 of the JAX
package's with its noise injected (as tests/test_torch_pipeline.py).
"""

import threading

import grpc
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save as np_save

from gyre_tpu.generated import generation_pb2 as jpb
from gyre_tpu.generated import tensors_pb2 as jtpb
from gyre_tpu.http.router import AbortError as JAbortError
from gyre_tpu.http.router import FakeGrpcContext as JContext
from gyre_tpu.manager.manager import EngineManager as JManager
from gyre_tpu.models import configs
from gyre_tpu.models import modelset as jms
from gyre_tpu.pipeline import lora as jlora
from gyre_tpu.pipeline import unified as junified
from gyre_tpu.services import generate as jgen
from gyre_tpu_torch.generated import generation_pb2 as tpb
from gyre_tpu_torch.generated import tensors_pb2 as ttpb
from gyre_tpu_torch.http.router import AbortError as TAbortError
from gyre_tpu_torch.http.router import FakeGrpcContext as TContext
from gyre_tpu_torch.manager.manager import EngineManager as TManager
from gyre_tpu_torch.models import modelset as tms
from gyre_tpu_torch.pipeline import lora as tlora
from gyre_tpu_torch.pipeline import modes as tmodes
from gyre_tpu_torch.pipeline import unified as tunified
from gyre_tpu_torch.services import generate as tgen
from gyre_tpu_torch.utils.cache import MemoryLRUCache
from gyre_tpu_torch.utils.resources import ResourceProvider
from test_torch_modes import one_torch_thread  # noqa: F401
from test_torch_pipeline import _jax_noise

CFG = configs.SD_TEST
ENGINES = [{"id": "tiny", "name": "Tiny", "default": True,
            "model": "preset/test"}]
TOKEN = "<cat-toy>"
REQUEST = dict(prompt=f"a (red:1.2) {TOKEN} at [dusk]",
               negative_prompt="blurry", height=64, width=64, steps=3,
               sampler="k_dpmpp_2m", guidance_scale=7.5, seeds=[3, 4])

# kohya module names over every target the resolver knows, at SD_TEST
UNET_TARGETS = [
    f"down_blocks_0_attentions_0_transformer_blocks_0_attn{a}_to_{t}"
    for a in (1, 2) for t in ("q", "k", "v", "out_0")] + [
    "down_blocks_0_attentions_0_transformer_blocks_0_ff_net_0_proj",
    "down_blocks_0_attentions_0_transformer_blocks_0_ff_net_2",
    "down_blocks_0_attentions_0_proj_in",
    "down_blocks_0_attentions_0_proj_out",
    "down_blocks_1_resnets_0_conv1", "down_blocks_1_resnets_0_conv2",
    "down_blocks_1_resnets_0_conv_shortcut",
    "down_blocks_1_resnets_0_time_emb_proj",
    "mid_block_attentions_0_transformer_blocks_0_attn1_to_v",
    "mid_block_resnets_1_conv2", "up_blocks_2_resnets_1_conv1",
    "up_blocks_1_attentions_2_transformer_blocks_0_ff_net_2"]
TE_TARGETS = [f"layers_{i}_{t}" for i in (0, 1) for t in (
    "self_attn_q_proj", "self_attn_k_proj", "self_attn_v_proj",
    "self_attn_out_proj", "mlp_fc1", "mlp_fc2")]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    """(JAX ModelSet, port ModelSet) on the same random weights."""
    ms = jms.random_modelset(CFG, seed=0, dtype=jnp.float32)
    tm = tms.from_jax_params(_np_tree(ms.unet_params),
                             _np_tree(ms.vae_params),
                             [_np_tree(t) for t in ms.text_params], CFG,
                             device="cpu")
    return ms, tm


def _torch_shape(module: str):
    """A kohya module's weight shape in torch layout, from the port's spec
    tree."""
    which, path = tlora.resolve_path(module)
    unet_s, _, text_s = tms.model_specs(CFG)
    spec = tlora._tree_get(unet_s if which == "unet" else text_s[0],
                           path + ("w",))
    if spec.kind == "conv_hwio":
        kh, kw, ci, co = spec.shape
        return (co, ci, kh, kw)
    return spec.shape


def kohya_names():
    return ([f"lora_unet_{t}" for t in UNET_TARGETS] +
            [f"lora_te_text_model_encoder_{t}" for t in TE_TARGETS])


def make_state(fmt: str, seed: int = 0, rank: int = 4, scale=0.2) -> dict:
    """A state dict of ``fmt`` over the kohya targets, f32 numpy."""
    r = np.random.default_rng(seed)

    def rnd(*shape):
        return (r.standard_normal(shape) * scale).astype(np.float32)

    state = {}
    for name in kohya_names():
        shape = _torch_shape(name)
        out, inn = shape[0], shape[1]
        k = shape[2:] if len(shape) == 4 else ()
        if fmt in ("kohya", "diffusers"):
            up = rnd(out, rank, *((1, 1) if k else ()))
            down = rnd(rank, inn, *k)
            if fmt == "kohya":
                state[f"{name}.lora_up.weight"] = up
                state[f"{name}.lora_down.weight"] = down
                state[f"{name}.alpha"] = np.asarray(rank / 2, np.float32)
            else:
                which, _ = tlora.resolve_path(name)
                dname = _diffusers_name(name)
                if which == "unet":
                    state[f"{dname}.lora_B.weight"] = up
                    state[f"{dname}.lora_A.weight"] = down
                else:
                    state[f"{dname}.lora.up.weight"] = up
                    state[f"{dname}.lora.down.weight"] = down
        elif fmt == "loha" and not k:
            for w in ("w1", "w2"):
                state[f"{name}.hada_{w}_a"] = rnd(out, rank)
                state[f"{name}.hada_{w}_b"] = rnd(rank, inn)
            state[f"{name}.alpha"] = np.asarray(rank, np.float32)
        elif fmt == "lokr" and not k and out % 2 == 0 and inn % 2 == 0:
            if len(state) % 2:
                state[f"{name}.lokr_w1"] = rnd(2, 2)
            else:                             # w1 as a low-rank product
                state[f"{name}.lokr_w1_a"] = rnd(2, 1)
                state[f"{name}.lokr_w1_b"] = rnd(1, 2)
            state[f"{name}.lokr_w2"] = rnd(out // 2, inn // 2)
        elif fmt == "diff":
            state[f"{name}.diff"] = rnd(*shape) * 0.1
    return state


def _diffusers_name(kohya: str) -> str:
    """A kohya module name in the diffusers/peft layout."""
    if kohya.startswith("lora_te"):
        layer, rest = kohya.split("layers_")[1].split("_", 1)
        rest = rest.replace("self_attn_", "self_attn.").replace(
            "mlp_", "mlp.")
        return f"text_encoder.text_model.encoder.layers.{layer}.{rest}"
    name = kohya[len("lora_unet_"):]
    for a, b in (("down_blocks_", "down_blocks."),
                 ("up_blocks_", "up_blocks."), ("mid_block_", "mid_block."),
                 ("attentions_", "attentions."), ("resnets_", "resnets."),
                 ("transformer_blocks_", "transformer_blocks.")):
        name = name.replace(a, b)
    name = name.replace(".0_attn", ".0.attn").replace(
        "_to_out_0", ".to_out.0").replace("_to_", ".to_")
    name = name.replace("_ff_net_0_proj", ".ff.net.0.proj").replace(
        "_ff_net_2", ".ff.net.2")
    for sect in ("down_blocks", "up_blocks", "attentions", "resnets"):
        name = name.replace(f"{sect}.0_", f"{sect}.0.").replace(
            f"{sect}.1_", f"{sect}.1.").replace(f"{sect}.2_", f"{sect}.2.")
    return "unet." + name


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _fold_both(models, state, scale):
    ms, tm = models
    base = {p: t.clone() for p, t in _leaves(
        [tm.unet_params, tm.text_params])}
    ju, jt, japplied = jlora.apply_lora(ms.unet_params, ms.text_params,
                                        state, scale)
    tu, tt, tapplied = tlora.apply_lora(tm.unet_params, tm.text_params,
                                        state, scale, config=CFG)
    ref = tms.from_jax_params(_np_tree(ju), _np_tree(ms.vae_params),
                              [_np_tree(t) for t in jt], CFG, device="cpu")
    # the base tree is untouched, in every bit
    for p, t in _leaves([tm.unet_params, tm.text_params]):
        assert torch.equal(t, base[p]), p
    return (tu, tt, tapplied), (ref.unet_params, ref.text_params, japplied)


def _max_diff(a, b):
    return max(float((x - y).abs().max()) for (_, x), (_, y) in
               zip(_leaves(a), _leaves(b)))


# ------------------------------------------------------------- the fold


@pytest.mark.parametrize("fmt", ["kohya", "diffusers", "loha", "lokr",
                                 "diff"])
def test_fold_matches_jax(models, fmt):
    state = make_state(fmt)
    assert tlora.detect_lora_format(state) == \
        jlora.detect_lora_format(state)
    (tu, tt, ta), (ru, rt, ja) = _fold_both(models, state, 0.8)
    assert ta == ja > 0
    assert _max_diff(tu, ru) <= 1e-6 and _max_diff(tt, rt) <= 1e-6
    # the fold changed what it applied to and shared the rest
    _, tm = models
    assert not torch.equal(tu["down"][1]["resnets"][0]["time_emb"]["w"],
                           tm.unet_params["down"][1]["resnets"][0]
                           ["time_emb"]["w"])
    assert tu["conv_in"] is tm.unet_params["conv_in"]
    assert tu["down"][3] is tm.unet_params["down"][3]


@pytest.mark.parametrize("case", ["conv_on_fused_conv", "conv1x1",
                                  "linear_on_conv", "conv_on_linear"])
def test_fold_layouts_match_jax(models, case):
    """A 3x3 conv LoRA on a fused resnet conv (HWIO in the port), a 1x1
    conv LoRA on a 1x1 conv, a 2-D delta on a conv leaf (skipped by
    both) and a 1x1 conv delta on a linear leaf (its tap taken)."""
    r = np.random.default_rng(1)
    name, up, down = {
        "conv_on_fused_conv": ("lora_unet_down_blocks_1_resnets_0_conv1",
                               (64, 2, 1, 1), (2, 32, 3, 3)),
        "conv1x1": ("lora_unet_down_blocks_1_resnets_0_conv_shortcut",
                    (64, 2, 1, 1), (2, 32, 1, 1)),
        "linear_on_conv": ("lora_unet_down_blocks_0_attentions_0_proj_in",
                           (32, 2), (2, 32)),
        "conv_on_linear": (
            "lora_unet_down_blocks_0_attentions_0_transformer_blocks_0_"
            "attn1_to_q", (32, 2, 1, 1), (2, 32, 1, 1)),
    }[case]
    state = {f"{name}.lora_up.weight": r.standard_normal(up, np.float32),
             f"{name}.lora_down.weight": r.standard_normal(down,
                                                           np.float32)}
    (tu, tt, ta), (ru, rt, ja) = _fold_both(models, state, 1.0)
    assert ta == ja == (0 if case == "linear_on_conv" else 1)
    assert _max_diff(tu, ru) <= 1e-6


def test_named_weights_scale_the_models_apart(models):
    state = make_state("kohya", seed=2)
    for scale in ({"*": 0.5}, {"unet": 0.0, "text_encoder": 1.0},
                  {"*": 0.3, "text_encoder": 0.9}, 0.7):
        (tu, tt, _), (ru, rt, _) = _fold_both(models, state, scale)
        assert _max_diff(tu, ru) <= 1e-6 and _max_diff(tt, rt) <= 1e-6
    _, tm = models
    tu, tt, _ = tlora.apply_lora(tm.unet_params, tm.text_params, state,
                                 {"unet": 0.0, "text_encoder": 1.0},
                                 config=CFG)
    assert _max_diff(tu, tm.unet_params) == 0.0
    assert _max_diff(tt, tm.text_params) > 0.0


# ------------------------------------------------- numpy-only functions


def test_resolvers_match_jax():
    names = kohya_names() + [_diffusers_name(n) for n in kohya_names()] + [
        "lora_unet_mid_block_resnets_0_time_emb_proj",
        "unet.mid_block.attentions.0.transformer_blocks.0.attn2.processor."
        "to_k", "text_model.encoder.layers.3.mlp.fc2", "lora_te2_text_"
        "model_encoder_layers_1_mlp_fc1", "lora_unet_bogus", "unet.up_blocks"
        ".x.resnets", "down_blocks.0.attentions.0.norm", "something"]
    for name in names:
        assert tlora.resolve_path(name) == jlora.resolve_path(name), name


@pytest.mark.parametrize("fmt", ["kohya", "diffusers", "loha", "lokr",
                                 "diff"])
def test_grouping_and_rebuild_match_jax(fmt):
    state = make_state(fmt, seed=3)
    tg, jg = tlora.group_modules(state), jlora.group_modules(state)
    assert tg.keys() == jg.keys()
    for name in tg:
        assert tg[name].keys() == jg[name].keys()
        np.testing.assert_array_equal(tlora._rebuild_delta(tg[name]),
                                      jlora._rebuild_delta(jg[name]))
    for state in ({"a:up": 1}, {"x.lora_A.weight": 1}, {"y": 1},
                  {"m.lokr_w1": 1}):
        assert tlora.detect_lora_format(state) == \
            jlora.detect_lora_format(state)


def test_ti_extraction_matches_jax():
    r = np.random.default_rng(4)
    for state in ({"string_to_param": {"*": r.random((2, 32), np.float32)}},
                  {"emb_params": r.random((3, 32), np.float32)},
                  {"<a>": r.random(32, np.float32),
                   "<b>": r.random((2, 32), np.float32),
                   "junk": r.random((2, 2, 2), np.float32)}):
        t, j = tlora.extract_ti_embeddings(state), \
            jlora.extract_ti_embeddings(state)
        assert t.keys() == j.keys()
        for k in t:
            np.testing.assert_array_equal(t[k], j[k])


def test_textual_inversion_matches_jax(models):
    ms, tm = models
    r = np.random.default_rng(5)
    emb = {TOKEN: r.standard_normal((2, 64)).astype(np.float32) * 0.02,
           "<one>": r.standard_normal((1, 64)).astype(np.float32),
           "<wide>": r.standard_normal((1, 48)).astype(np.float32)}
    jt, jtok = jlora.apply_textual_inversions(ms, emb)
    tt, ttok = tlora.apply_textual_inversions(tm, emb)
    np.testing.assert_array_equal(tt[0]["token_embedding"].numpy(),
                                  np.asarray(jt[0]["token_embedding"]))
    assert tt[0]["position_embedding"] is \
        tm.text_params[0]["position_embedding"]
    assert tm.text_params[0]["token_embedding"].shape[0] + 3 == \
        tt[0]["token_embedding"].shape[0]            # <wide> skipped
    for text in (f"a {TOKEN} and <one>, <wide>", "plain words",
                 f"{TOKEN}{TOKEN}"):
        assert ttok.encode(text) == jtok.encode(text)


# ------------------------------------------------------------- images


def test_lora_and_ti_image_matches_jax(models, monkeypatch):
    ms, tm = models
    lora = make_state("kohya", seed=6)
    emb = {TOKEN: np.random.default_rng(7).standard_normal(
        (2, 64)).astype(np.float32) * 0.05}
    ju, jt, _ = jlora.apply_lora(ms.unet_params, ms.text_params, lora, 0.9)
    jms_ = jms.ModelSet(config=ms.config, unet_params=ju,
                        vae_params=ms.vae_params, text_params=jt,
                        tokenizer=ms.tokenizer, schedule=ms.schedule)
    jt, jtok = jlora.apply_textual_inversions(jms_, emb)
    jms_.text_params, jms_.tokenizer = jt, jtok
    jpipe = junified.UnifiedPipeline(ms, compute_dtype=jnp.float32).derive(
        jms_)
    tu, tt, _ = tlora.apply_lora(tm.unet_params, tm.text_params, lora, 0.9,
                                 config=CFG)
    import dataclasses

    tms_ = dataclasses.replace(tm, unet_params=tu, text_params=tt)
    tt, ttok = tlora.apply_textual_inversions(tms_, emb)
    tms_ = dataclasses.replace(tms_, text_params=tt, tokenizer=ttok)
    base = tunified.UnifiedPipeline(tm, compute_dtype=torch.float32)
    tpipe = base.derive(tms_)
    monkeypatch.setattr(tmodes, "txt2img_initial", _jax_noise)
    out = tpipe(**REQUEST).numpy()
    ref = np.asarray(jpipe(**REQUEST))
    assert np.abs(out - ref).max() <= 2e-3
    assert np.abs(out - base(**REQUEST).numpy()).max() > 1e-2


# ------------------------------------------------------- adapted views


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    root = tmp_path_factory.mktemp("loras")
    m = TManager(ENGINES, device="cpu", compute_dtype=torch.float32,
                 batch_max=2, gather_ms=0.0)
    m.load_engines()
    cache = MemoryLRUCache()
    m.resources = ResourceProvider(cache, local_roots={"loras": str(root)})
    servicer = tgen.GenerationServiceServicer(m, batch_max=2,
                                              resource_cache=cache)
    servicer.root = root
    yield servicer
    m.dispatcher.stop()


@pytest.fixture(scope="module")
def ref():
    m = JManager(ENGINES, compute_dtype=jnp.float32, batch_max=2)
    m.load_engines()
    yield jgen.GenerationServiceServicer(m, batch_max=2)
    m.dispatcher.stop()


def test_adapted_views_are_their_own_dispatch_views(port):
    m = port.manager
    base = m.dispatch_view("tiny")
    before = {p: t.clone() for p, t in _leaves(
        [base.pipe.ms.unet_params, base.pipe.ms.text_params])}
    a, b = make_state("kohya", seed=8), make_state("kohya", seed=9)
    va = m.adapted_pipeline("tiny", [(a, 1.0, "a")])
    assert va is not base and va.pipe is not base.pipe
    assert m.adapted_pipeline("tiny", [(a, 1.0, "a")]) is va     # cached
    assert m.adapted_pipeline("tiny", [(b, 1.0, "b")]) is not va
    assert m.adapted_pipeline("tiny", [(a, 0.5, "a")]) is not va
    # scales that give each model the same weight share one view
    assert m.adapted_pipeline("tiny", [(a, {"*": 1.0}, "a")]) is va
    assert m.adapted_pipeline("tiny", [(a, {"unet": 1.0}, "a")]) is va
    assert m.adapted_pipeline("tiny", [(a, {"*": 0.5, "unet": 1.0,
                                            "text_encoder": 1}, "a")]) is va
    assert m.adapted_pipeline("tiny") is base
    with m.with_engine("tiny", loras=[(a, 1.0, "a")]) as view:
        assert view is va
    for i in range(10):                        # bounded: oldest dropped
        m.adapted_pipeline("tiny", tis=[({"<t>": np.full(
            (1, 64), i, np.float32)}, f"ti{i}")])
    assert len(m._adapted) == 8
    assert m.adapted_pipeline("tiny", [(a, 1.0, "a")]) is not va
    for p, t in _leaves([base.pipe.ms.unet_params,
                         base.pipe.ms.text_params]):
        assert torch.equal(t, before[p]), p


def test_adapter_host_work_stays_off_the_dispatcher(port, monkeypatch):
    """Only the uploads and adds of a new adapted view run on the
    dispatcher's thread; the deltas are rebuilt on the caller's."""
    m = port.manager
    threads = {}
    for name in ("lora_deltas", "fold_deltas"):
        fn = getattr(tlora, name)

        def spy(*args, _fn=fn, _name=name, **kw):
            threads[_name] = threading.current_thread()
            return _fn(*args, **kw)
        monkeypatch.setattr(tlora, name, spy)
    view = m.adapted_pipeline("tiny", [(make_state("lokr", seed=11), 0.7,
                                        "host-work")])
    assert threads["lora_deltas"] is threading.current_thread()
    assert threads["fold_deltas"] is m.dispatcher._thread
    assert view is not m.dispatch_view("tiny")


# ----------------------------------------------------------- servicer


def _request(pb, seed=7):
    req = pb.Request(engine_id="tiny", request_id=f"r{seed}")
    req.prompt.add().text = f"a boat {TOKEN}"
    img = req.image
    img.height, img.width, img.steps, img.samples = 64, 64, 2, 1
    img.seed.append(seed)
    img.transform.diffusion = pb.SAMPLER_K_DPMPP_2M
    img.parameters.add().sampler.cfg_scale = 7.5
    return req


def _tensor_msg(tensors_pb, arr):
    return tensors_pb.Tensor(dtype=tensors_pb.DT_FLOAT32,
                             shape=list(arr.shape),
                             data=np.ascontiguousarray(arr,
                                                       np.float32).tobytes())


def _lora_prompt(pb, tensors_pb, req, state, how, weight=None, **fields):
    prompt = req.prompt.add()
    art = prompt.artifact
    art.type = pb.ARTIFACT_LORA
    if how == "lora":
        for k, v in state.items():
            art.lora.lora.tensors.add(key=k, tensor=_tensor_msg(
                tensors_pb, np.asarray(v)))
    elif how == "binary":
        art.binary = np_save({k: np.asarray(v, np.float32)
                              for k, v in state.items()})
    for k, v in fields.items():
        if k == "cache_control":
            art.cache_control.cache_id, art.cache_control.max_age = v
        else:
            setattr(art, k, v)
    if weight is not None:
        prompt.parameters.weight = weight
    return prompt


def _image(servicer, req, ctx):
    (answer,) = list(servicer.Generate(req, ctx()))
    return answer.artifacts[0].binary


def test_servicer_lora_transports_agree(port, monkeypatch):
    state = make_state("kohya", seed=10)
    # one content, one key: numpy arrays (the Tensor messages) and tensors
    # (safetensors bytes) digest alike
    assert tgen.state_digest(state) == tgen.state_digest(
        {k: torch.from_numpy(np.asarray(v)) for k, v in state.items()})
    base = _image(port, _request(tpb), TContext)
    folds = []
    deltas = tlora.lora_deltas
    monkeypatch.setattr(tlora, "lora_deltas",
                        lambda *a, **k: folds.append(1) or deltas(*a, **k))
    got = {}
    for how in ("lora", "binary"):
        req = _request(tpb)
        _lora_prompt(tpb, ttpb, req, state, how, weight=0.8)
        got[how] = _image(port, req, TContext)
    req = _request(tpb)
    _lora_prompt(tpb, ttpb, req, state, "binary", weight=0.8,
                 cache_control=("mine", 60))
    got["upload"] = _image(port, req, TContext)
    req = _request(tpb)
    _lora_prompt(tpb, ttpb, req, state, "cache", weight=0.8,
                 cache_id="mine")
    got["cache_id"] = _image(port, req, TContext)
    (port.root / "style.safetensors").write_bytes(np_save(
        {k: np.asarray(v, np.float32) for k, v in state.items()}))
    req = _request(tpb)
    _lora_prompt(tpb, ttpb, req, state, "url", weight=0.8,
                 url="file:loras/style.safetensors")
    got["url"] = _image(port, req, TContext)
    assert len(set(got.values())) == 1 and got["lora"] != base
    assert len(folds) == 1           # every transport shares the one view
    # named_weights: the text encoder alone at 0 keeps only the unet's
    req = _request(tpb)
    prompt = _lora_prompt(tpb, ttpb, req, state, "lora")
    prompt.parameters.named_weights.add(name="text_encoder", weight=0.0)
    prompt.parameters.named_weights.add(name="unet", weight=0.0)
    assert _image(port, req, TContext) == base


def test_cache_id_miss_is_failed_precondition_as_in_jax(port, ref):
    codes = []
    for pb, servicer, ctx, err in ((tpb, port, TContext, TAbortError),
                                   (jpb, ref, JContext, JAbortError)):
        req = _request(pb)
        _lora_prompt(pb, None, req, {}, "cache", cache_id="never-stored")
        context = ctx()
        with pytest.raises(err):
            list(servicer.Generate(req, context))
        codes.append((context.code, "never-stored" in context.details))
    assert codes[0] == codes[1] == (grpc.StatusCode.FAILED_PRECONDITION,
                                    True)


def test_ti_overrides_and_the_jax_cache_key_collision(port, ref):
    """TI with token_overrides gives the JAX servicer's token table and
    ids. Two distinct LoRAs sent through the ``lora`` field without a uuid
    share one cache key in the JAX servicer (``hash(art.binary[:256])`` of
    an empty binary), so the second request runs on the first LoRA's
    weights; the port keys each by a digest of its content."""
    r = np.random.default_rng(11)
    vecs = r.standard_normal((2, 64)).astype(np.float32) * 0.05
    loras = [make_state("kohya", seed=s) for s in (12, 13)]
    views = []
    images = []
    for pb, tensors_pb, servicer, ctx in (
            (tpb, ttpb, port, TContext),
            (jpb, jtpb, ref, JContext)):
        out = []
        for lora in loras:
            req = _request(pb)
            _lora_prompt(pb, tensors_pb, req, lora, "lora")
            prompt = req.prompt.add()
            prompt.artifact.type = pb.ARTIFACT_TOKEN_EMBEDDING
            prompt.artifact.token_embedding.text = "<orig>"
            prompt.artifact.token_embedding.tensor.CopyFrom(
                _tensor_msg(tensors_pb, vecs))
            prompt.parameters.token_overrides.add(original_token="<orig>",
                                                  token=TOKEN)
            out.append(_image(servicer, req, ctx))
        images.append(out)
        adapted = list(servicer.manager._adapted.values())[-1]
        views.append(getattr(adapted, "pipe", adapted).ms)
    tms_, jms_ = views              # random engines of either package:
    ttab = tms_.text_params[0]["token_embedding"].numpy()   # their rows
    jtab = np.asarray(jms_.text_params[0]["token_embedding"])  # differ
    assert ttab.shape == jtab.shape
    np.testing.assert_array_equal(ttab[-2:], jtab[-2:])
    np.testing.assert_array_equal(ttab[-2:], vecs)
    for text in (f"a boat {TOKEN}", "<orig> boat"):
        assert tms_.tokenizer.encode(text) == jms_.tokenizer.encode(text)
    assert images[0][0] != images[0][1]      # the port: two LoRAs
    assert images[1][0] == images[1][1]      # the JAX package: one
