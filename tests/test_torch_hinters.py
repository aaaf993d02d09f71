"""The port's HED, informative-drawings and DexiNed hinters
(gyre_tpu_torch/models/hinters.py) against the JAX package's, in f32 on
the CPU on the same weights: the JAX params through the strict bridges,
published-layout checkpoints (DexiNed's from tests/torch_oracles.py with
random BatchNorm statistics) through both packages' loaders, and each
port export read back by the JAX loader. Models within 1e-3 of the JAX
package's output, the loaded weights within 1e-6. Full published widths
at 64x48 images; one JAX compile a model (module-scoped jit, params as
arguments). Then the edge, line-art and DexiNed engines through both
packages' managers from one checkpoint on disk, and the port's own rule
for a DexiNed checkpoint that does not load."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from gyre_tpu.manager.manager import EngineManager as JManager
from gyre_tpu.models import hinters as jh
from gyre_tpu_torch.manager.manager import EngineManager as TManager
from gyre_tpu_torch.models import hinters as th
from gyre_tpu_torch.models import modelset as tms
from test_torch_modes import one_torch_thread  # noqa: F401
from torch_oracles import DexiNed as OracleDexiNed

TOL = 1e-3          # a model's output against the JAX package's
W_TOL = 1e-6        # a loaded weight against the other loader's

J_HED = jax.jit(jh.hed_apply)
J_DRAW = jax.jit(jh.drawings_apply)
J_DEXI = jax.jit(jh.dexined_apply)

IMG = np.random.default_rng(3).random((2, 64, 48, 3)).astype(np.float32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _err(ref, got):
    return float(np.abs(np.asarray(ref) - got.detach().numpy()).max())


def _run(model):
    with torch.no_grad():
        return model(torch.from_numpy(IMG))


def _same_trees(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(la, lb):
        assert np.shape(x) == np.shape(y)
        assert np.abs(np.asarray(x) - np.asarray(y)).max() <= W_TOL


@pytest.fixture(scope="module")
def hed_params():
    return _np(jax.jit(jh.hed_init)(jax.random.PRNGKey(1)))


@pytest.fixture(scope="module")
def hed_ref(hed_params):
    return np.asarray(J_HED(hed_params, IMG))


def test_hed_bridge_matches_jax(hed_params, hed_ref):
    got = _run(tms.hed_from_jax(hed_params, device="cpu"))
    assert tuple(got.shape) == (2, 64, 48, 1)
    assert _err(hed_ref, got) <= TOL
    assert float(got.std()) > 1e-3


def test_bridges_are_strict(hed_params):
    extra = dict(hed_params, mystery={"w": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="mystery"):
        tms.hed_from_jax(extra, device="cpu")
    missing = dict(hed_params, sides=hed_params["sides"][:4])
    with pytest.raises(ValueError, match="sides.4"):
        tms.hed_from_jax(missing, device="cpu")
    wrong = jax.tree.map(np.copy, hed_params)
    wrong["fuse"]["w"] = np.zeros((1, 1, 4, 1), np.float32)
    with pytest.raises(ValueError, match="shape"):
        tms.hed_from_jax(wrong, device="cpu")


def test_hed_export_and_loaders_match_jax(hed_params, hed_ref):
    """The port's export, read by the JAX loader, is the tree it came
    from; the port's loader reads it back to the same bits and output."""
    model = tms.hed_from_jax(hed_params, device="cpu")
    state = th.state_dict_hed(model)
    assert "conv5_3.weight" in state and "score_final.weight" in state
    assert "score_final.bias" not in state
    _same_trees(hed_params, _np(jh.load_hed_params(state)))
    again = th.load_hed(state, device="cpu")
    for (n, a), (_, b) in zip(model.named_parameters(),
                              again.named_parameters()):
        assert torch.equal(a, b), n
    assert _err(hed_ref, _run(again)) <= TOL


def test_hed_published_state_without_biases_loads_as_in_jax(hed_params):
    """A checkpoint whose side convs carry no bias: both loaders take it
    as zero."""
    state = th.state_dict_hed(tms.hed_from_jax(hed_params, device="cpu"))
    rng = np.random.default_rng(5)
    state = {k: (rng.standard_normal(v.shape).astype(np.float32) * 0.01
                 if k.endswith("bias") else v) for k, v in state.items()
             if k != "score_dsn2.bias"}
    jp = _np(jh.load_hed_params(state))
    ref = J_HED(jp, IMG)
    got = _run(th.load_hed(state, device="cpu"))
    assert _err(ref, got) <= TOL


@pytest.fixture(scope="module")
def draw_params():
    return _np(jax.jit(jh.drawings_init)(jax.random.PRNGKey(2)))


def test_drawings_bridge_export_and_loader_match_jax(draw_params):
    ref = np.asarray(J_DRAW(draw_params, IMG))
    model = tms.drawings_from_jax(draw_params, device="cpu")
    got = _run(model)
    assert tuple(got.shape) == (2, 64, 48, 1)
    assert _err(ref, got) <= TOL
    assert float(got.std()) > 1e-3
    state = th.state_dict_drawings(model)
    assert state["model3.0.weight"].shape == (256, 128, 3, 3)   # [in,out]
    _same_trees(draw_params, _np(jh.load_drawings_params(state)))
    again = th.load_drawings(state, device="cpu")
    assert _err(ref, _run(again)) <= TOL


def test_drawings_published_state_matches_jax():
    """A published-layout state dict of its own (random convs and
    biases) through both loaders: the same line art."""
    rng = np.random.default_rng(6)
    ref_model = th.Drawings(n_blocks=2, base=16)
    state = {}
    for conv, key in th._drawings_keys(ref_model):
        state[f"{key}.weight"] = rng.standard_normal(
            tuple(conv.weight.shape)).astype(np.float32) * 0.1
        state[f"{key}.bias"] = rng.standard_normal(
            conv.bias.shape[0]).astype(np.float32) * 0.1
    ref = jax.jit(jh.drawings_apply)(_np(jh.load_drawings_params(state)),
                                     IMG)
    got = _run(th.load_drawings(state, device="cpu"))
    assert _err(ref, got) <= TOL
    assert float(got.std()) > 1e-3


@pytest.fixture(scope="module")
def dexi_state():
    """The published DexiNed layout from the torch oracle, every
    BatchNorm with random statistics so that folding is exercised."""
    torch.manual_seed(0)
    net = OracleDexiNed().eval()
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5)
                m.bias.uniform_(-0.2, 0.2)
                m.running_mean.uniform_(-0.2, 0.2)
                m.running_var.uniform_(0.5, 1.5)
    return {k: v.numpy() for k, v in net.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def test_dexined_loaders_match_jax(dexi_state):
    jp = _np(jh.load_dexined_params(dexi_state))
    ref = np.asarray(J_DEXI(jp, IMG))
    model = th.load_dexined(dexi_state, device="cpu")
    got = _run(model)
    assert tuple(got.shape) == (2, 64, 48, 1)
    assert _err(ref, got) <= TOL
    assert float(got.std()) > 1e-2
    # the bridge from the JAX loader's tree gives the same weights
    bridged = tms.dexined_from_jax(jp, device="cpu")
    for (n, a), (_, b) in zip(model.named_parameters(),
                              bridged.named_parameters()):
        assert float((a - b).detach().abs().max()) <= W_TOL, n


def test_dexined_export_round_trip(dexi_state):
    """The export (BatchNorms folded into the convs, identities in their
    place) read by the JAX loader gives the loaded tree again."""
    model = th.load_dexined(dexi_state, device="cpu")
    state = th.state_dict_dexined(model)
    assert set(state) - set(dexi_state) == set()
    assert "block_cat.bn.weight" not in state
    jp = _np(jh.load_dexined_params(state))
    _same_trees(_np(jh.load_dexined_params(dexi_state)), jp)
    assert _err(J_DEXI(jp, IMG), _run(model)) <= TOL


def test_dexined_missing_key_raises(dexi_state):
    """A checkpoint without one of the published keys raises KeyError in
    both loaders (the JAX package's engine then random-inits; the port's
    engine raises: test_dexined_engine_with_a_bad_checkpoint_raises)."""
    bad = {k: v for k, v in dexi_state.items()
           if not k.startswith("pre_dense_4.conv")}
    with pytest.raises(KeyError, match="pre_dense_4"):
        jh.load_dexined_params(bad)
    with pytest.raises(KeyError, match="pre_dense_4"):
        th.load_dexined(bad, device="cpu")


def test_random_models_run_in_bf16():
    """The random full-width models in the card's dtype on the CPU: the
    maps stay in [0, 1] and near the f32 map (2e-2 of max |f32|, the
    card's bound)."""
    img = torch.from_numpy(IMG[:1])
    for make in (th.random_hed, th.random_drawings, th.random_dexined):
        f32 = make(0, dtype=torch.float32, device="cpu")
        b16 = make(0, dtype=torch.bfloat16, device="cpu")
        with torch.no_grad():
            a, b = f32(img), b16(img)
        assert b.dtype == torch.float32 and tuple(b.shape) == (1, 64, 48, 1)
        assert float(b.min()) >= 0 and float(b.max()) <= 1
        assert float((a - b).abs().max()) <= 2e-2 * float(a.abs().max())


# --------------------------------------------------------- task engines


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory, hed_params, draw_params, dexi_state):
    root = tmp_path_factory.mktemp("hinters")
    states = {
        "hed": th.state_dict_hed(tms.hed_from_jax(hed_params, device="cpu")),
        "lineart": th.state_dict_drawings(
            tms.drawings_from_jax(draw_params, device="cpu")),
        "dexined": dexi_state}
    paths = {}
    for name, state in states.items():
        paths[name] = str(root / f"{name}.safetensors")
        save_file({k: np.ascontiguousarray(v) for k, v in state.items()},
                  paths[name])
    return paths


def _engines(ckpts):
    """config/engines/utility.yaml's edge, line-art and DexiNed entries
    over the files."""
    return [{"id": "hed-edge", "task": "edge", "model": ckpts["hed"]},
            {"id": "lineart", "task": "hinter", "kind": "lineart",
             "model": ckpts["lineart"]},
            {"id": "dexined-edge", "task": "hinter", "kind": "dexined",
             "model": ckpts["dexined"]}]


def test_edge_engines_match_jax(ckpts):
    """Each engine's 3-channel hint equals the JAX package's (1e-3), built
    once, weights "real", ready from the start."""
    tm = TManager(_engines(ckpts), device="cpu",
                  compute_dtype=torch.float32)
    jm = JManager(_engines(ckpts), compute_dtype=jnp.float32)
    try:
        tm.load_engines()
        assert all(s["ready"] for s in tm.status())
        img = IMG[:1]
        for task, eid in (("edge", "hed-edge"), ("hinter", "lineart"),
                          ("hinter", "dexined-edge")):
            ref = jm.task_pipeline(task, eid)(img)
            got = tm.task_pipeline(task, eid)(img)
            assert tuple(got.shape) == (1, 64, 48, 3), eid
            assert _err(ref, got) <= TOL, eid
            assert tm.task_pipeline(task, eid) is tm.task_pipeline(task, eid)
        assert {s["id"]: s["weights"] for s in tm.status()} == {
            "hed-edge": "real", "lineart": "real", "dexined-edge": "real"}
    finally:
        tm.dispatcher.stop()
        jm.dispatcher.stop()


def test_dexined_engine_with_a_bad_checkpoint_raises(dexi_state, tmp_path):
    """A DexiNed checkpoint that resolves and does not load: the JAX
    package warns and serves a random DexiNed
    (gyre_tpu/manager/manager.py:762-769); the port's engine raises, as its
    depth engines do (a deliberate difference, ROADMAP queue 3)."""
    path = str(tmp_path / "bad.safetensors")
    save_file({k: v for k, v in dexi_state.items()
               if not k.startswith("pre_dense_4.")}, path)
    spec = [{"id": "dexined-edge", "task": "hinter", "kind": "dexined",
             "model": path}]
    jm = JManager(spec, compute_dtype=jnp.float32)
    tm = TManager(spec, device="cpu", compute_dtype=torch.float32)
    try:
        assert jm.task_pipeline("hinter") is not None     # random-init
        with pytest.raises(KeyError, match="pre_dense_4"):
            tm.task_pipeline("hinter")
    finally:
        tm.dispatcher.stop()
        jm.dispatcher.stop()


def test_weightless_edge_engines_random_init():
    """No resolvable weights: each kind random-inits at its published
    width (the JAX package's rule), reported "random"."""
    tm = TManager([{"id": "e", "task": "edge", "model": "@nowhere"},
                   {"id": "l", "task": "hinter", "kind": "lineart"}],
                  device="cpu", compute_dtype=torch.float32)
    try:
        for task in ("edge", "hinter"):
            out = tm.task_pipeline(task)(IMG[:1])
            assert tuple(out.shape) == (1, 64, 48, 3)
            assert torch.isfinite(out).all()
        assert isinstance(tm.task_pipeline("edge").models[0], th.HED)
        assert isinstance(tm.task_pipeline("hinter").models[0], th.Drawings)
        assert [s["weights"] for s in tm.status()] == ["random", "random"]
    finally:
        tm.dispatcher.stop()
