"""CodeFormer (gyre_tpu_torch.models.codeformer) against the JAX package's
gyre_tpu/models/codeformer.py on the CPU in f32: ``restore`` at
CODEFORMER_TEST at fidelity 0, 0.5 and 1 (the JAX random tree bridged;
1e-3, as for the other models), the block plans' fuse indices (the
published ones at CODEFORMER), the strict loader and exporter (the
codeformer.pth layout, read back by both loaders), and the face-restore
engine on one checkpoint in both packages' managers at a non-square size
(the resize to the model's size and back; 2e-3) and through the port's
generate servicer (one PNG of the init image's size).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from gyre_tpu.manager.manager import EngineManager as JManager
from gyre_tpu.models import codeformer as jcf
from gyre_tpu_torch.generated import generation_pb2 as tpb
from gyre_tpu_torch.http.router import FakeGrpcContext as TContext
from gyre_tpu_torch.manager.manager import EngineManager as TManager
from gyre_tpu_torch.models import codeformer as tcf
from gyre_tpu_torch.models import modelset as tms
from gyre_tpu_torch.ops import images as timages
from gyre_tpu_torch.services import generate as tgen
from test_torch_modes import one_torch_thread  # noqa: F401

CFG = jcf.CODEFORMER_TEST
TCFG = tcf.CODEFORMER_TEST
X = np.random.RandomState(0).rand(2, 32, 32, 3).astype(np.float32)


@pytest.fixture(scope="module")
def models():
    """(JAX params, the port's CodeFormer on them)."""
    params = jcf.init(jax.random.PRNGKey(0), CFG)
    return params, tms.codeformer_from_jax(jax.tree.map(np.asarray, params),
                                           TCFG, device="cpu")


@pytest.mark.parametrize("fidelity", [0.0, 0.5, 1.0])
def test_restore_matches_jax(models, fidelity):
    params, model = models
    run = jax.jit(lambda p, x: jcf.restore(p, x, fidelity=fidelity,
                                           cfg=CFG))
    want = np.asarray(run(params, jnp.asarray(X)))
    with torch.no_grad():
        got = model(torch.from_numpy(X), fidelity).numpy()
    assert got.shape == want.shape == X.shape
    assert np.abs(got - want).max() <= 1e-3
    assert got.std() > 1e-3


def test_fidelity_changes_the_image(models):
    _, model = models
    with torch.no_grad():
        a = model(torch.from_numpy(X), 0.0)
        b = model(torch.from_numpy(X), 1.0)
    assert (a - b).abs().max() > 1e-5


def test_fuse_indices_match_the_published_net():
    """sczhou/CodeFormer's codeformer_arch.py hard-codes these positions;
    the plans give them at CODEFORMER, and both packages' plans agree at
    both configs."""
    _, enc = tcf.encoder_plan(tcf.CODEFORMER)
    _, gen = tcf.generator_plan(tcf.CODEFORMER)
    assert enc == {"512": 2, "256": 5, "128": 8, "64": 11, "32": 14,
                   "16": 18}
    assert gen == {"16": 6, "32": 9, "64": 12, "128": 15, "256": 18,
                   "512": 21}
    for tc, jc in ((tcf.CODEFORMER, jcf.CODEFORMER), (TCFG, CFG)):
        assert tcf.encoder_plan(tc) == jcf.encoder_plan(jc)
        assert tcf.generator_plan(tc) == jcf.generator_plan(jc)


def test_loader_is_strict_and_the_export_reads_back(models):
    params, model = models
    state = tcf.state_dict_codeformer(model)
    assert "quantize.embedding.weight" in state
    assert "ft_layers.1.self_attn.in_proj_weight" in state
    assert "fuse_convs_dict.32.shift.2.bias" in state
    assert "encoder.blocks.2.conv.weight" in state      # the downsample
    tstate = {k: torch.from_numpy(v) for k, v in state.items()}
    back = tcf.load_codeformer(dict(tstate, **{
        "quantize.buffer": torch.zeros(1)}), device="cpu")
    assert back.cfg == TCFG
    jparams, jcfg = jcf.load_codeformer(state)
    assert jcfg == CFG
    with torch.no_grad():
        got = back(torch.from_numpy(X), 0.5).numpy()
    want = np.asarray(jcf.restore(jparams, jnp.asarray(X), fidelity=0.5,
                                  cfg=jcfg))
    assert np.abs(got - want).max() <= 1e-3
    with pytest.raises(KeyError, match="zzz"):
        tcf.load_codeformer(dict(tstate, **{"generator.blocks.0.zzz":
                                            torch.zeros(1)}), device="cpu")
    missing = dict(tstate)
    del missing["ft_layers.0.linear2.bias"]
    with pytest.raises(ValueError, match="linear2"):
        tcf.load_codeformer(missing, device="cpu")
    bad = dict(tstate, **{"idx_pred_layer.1.weight": torch.zeros(3, 3)})
    with pytest.raises(ValueError, match="idx_pred"):
        tcf.load_codeformer(bad, device="cpu")


def test_face_restore_engine_matches_jax(models, tmp_path):
    """One codeformer.pth-layout checkpoint under both managers'
    face_restore engines (``fidelity`` 0.7): a 48x40 image is restored at
    the model's 32x32 and resized back, within 2e-3 of the JAX engine's;
    a request to the port's engine answers a PNG of the same size."""
    _, model = models
    path = str(tmp_path / "codeformer.safetensors")
    save_file(tcf.state_dict_codeformer(model), path)
    engines = [{"id": "codeformer", "task": "face_restore", "model": path,
                "fidelity": 0.7}]
    tm = TManager(engines, device="cpu", compute_dtype=torch.float32)
    jm = JManager(engines, compute_dtype=jnp.float32, batch_max=1)
    img = np.round(np.random.RandomState(1).rand(1, 48, 40, 3) * 255
                   ).astype(np.float32) / 255
    try:
        tm.load_engines()
        got = tm.task_pipeline("face_restore", "codeformer")(img).numpy()
        want = np.asarray(jm.task_pipeline("face_restore",
                                           "codeformer")(img))
        assert got.shape == want.shape == (1, 48, 40, 3)
        assert np.abs(got - want).max() <= 2e-3
        assert {s["id"]: (s["ready"], s["weights"]) for s in tm.status()} \
            == {"codeformer": (True, "real")}
        req = tpb.Request(engine_id="codeformer", request_id="face")
        p = req.prompt.add()
        p.artifact.type = tpb.ARTIFACT_IMAGE
        p.artifact.binary = timages.encode_png(img[0])
        p.parameters.init = True
        (answer,) = tgen.GenerationServiceServicer(tm).Generate(req,
                                                               TContext())
        served = timages.decode_png(answer.artifacts[0].binary)
        assert served.shape == (1, 48, 40, 3)
        assert np.abs(served - got).max() <= 1.0 / 255 + 1e-6
    finally:
        tm.dispatcher.stop()
        jm.dispatcher.stop()
