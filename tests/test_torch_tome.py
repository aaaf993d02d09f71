"""Token merging (gyre_tpu_torch.ops.tome) against the JAX package's
gyre_tpu/ops/tome.py: merge and unmerge on tie-free random tokens (1e-4;
the same indices), the properties that hold whatever order ties take
(duplicate tokens merge losslessly, the shapes, unmerge of merge keeps a
kept token exactly), the SD_TEST UNet with ``tome_ratio`` (1e-3, as for
the other models), and the ``tome_ratio`` engine option served through
both packages' servicers on the same weights and noise (one PNG level),
an image that differs from the unmerged engine's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gyre_tpu.generated import generation_pb2 as jpb
from gyre_tpu.http.router import FakeGrpcContext as JContext
from gyre_tpu.manager.manager import EngineManager as JManager
from gyre_tpu.models import configs as jconfigs
from gyre_tpu.models import unet as junet
from gyre_tpu.ops import tome as jtome
from gyre_tpu.services import generate as jgen
from gyre_tpu_torch.generated import generation_pb2 as tpb
from gyre_tpu_torch.http.router import FakeGrpcContext as TContext
from gyre_tpu_torch.manager.manager import EngineManager as TManager
from gyre_tpu_torch.models import configs as tconfigs
from gyre_tpu_torch.models import modelset as tms
from gyre_tpu_torch.models import unet as tunet
from gyre_tpu_torch.ops import images as timages
from gyre_tpu_torch.ops import tome as ttome
from gyre_tpu_torch.pipeline import modes as tmodes
from gyre_tpu_torch.services import generate as tgen
from test_torch_diffusion_upscaler import bridged_random
from test_torch_modes import _jax_initial, one_torch_thread  # noqa: F401

LEVEL = 1.0 / 255 + 1e-6


def _tokens(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("n,c,r", [(64, 16, 16), (63, 8, 20), (16, 4, 1)])
def test_merge_and_unmerge_match_jax(n, c, r):
    x = _tokens(n, (2, n, c))
    jm, jinfo = jtome.merge(jnp.asarray(x), r)
    tm, tinfo = ttome.merge(torch.from_numpy(x), r)
    assert tm.shape == jm.shape and tm.is_contiguous()
    assert np.abs(tm.numpy() - np.asarray(jm)).max() <= 1e-4
    for key in ("best_dst", "merged_mask", "keep_idx"):
        assert np.array_equal(tinfo[key].numpy(), np.asarray(jinfo[key]))
    out = _tokens(1, tm.shape)
    ju = jtome.unmerge(jnp.asarray(out), jinfo)
    tu = ttome.unmerge(torch.from_numpy(out), tinfo)
    assert np.abs(tu.numpy() - np.asarray(ju)).max() <= 1e-4


@pytest.mark.parametrize("ratio", [0.0, 0.3, 0.5, 0.95])
def test_self_attention_wrapper_matches_jax(ratio):
    x = _tokens(5, (1, 48, 8))
    want = jtome.tome_self_attention(lambda t: jnp.tanh(t) * 2, jnp.asarray(x),
                                     ratio)
    got = ttome.tome_self_attention(lambda t: torch.tanh(t) * 2,
                                    torch.from_numpy(x), ratio)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-4


def test_duplicate_tokens_merge_losslessly():
    """Pairs of equal tokens: every source ties with its destination (and
    the r-th place ties too), yet under identity attention the round trip
    is lossless, whichever sources the tie-break picks."""
    base = _tokens(2, (1, 16, 8))
    x = torch.from_numpy(np.repeat(base, 2, axis=1))
    out = ttome.tome_self_attention(lambda t: t, x, 0.5)
    assert torch.allclose(out, x, atol=1e-5)
    merged, info = ttome.merge(x, 8)
    assert merged.shape == (1, 24, 8)
    assert int(info["merged_mask"].sum()) == 8


def test_tied_merge_properties():
    """A bf16-like tie: all-equal tokens. The shapes hold, the merged count
    is r, and unmerge of merge returns every token (all are equal)."""
    x = torch.ones((2, 32, 8))
    merged, info = ttome.merge(x, 10)
    assert merged.shape == (2, 22, 8) and merged.is_contiguous()
    assert info["merged_mask"].sum(dim=1).tolist() == [10, 10]
    back = ttome.unmerge(merged, info)
    assert back.shape == x.shape and torch.equal(back, x)


def test_kept_tokens_come_back_exactly():
    x = torch.from_numpy(_tokens(3, (2, 40, 8)))
    merged, info = ttome.merge(x, 12)
    back = ttome.unmerge(merged, info)
    src = info["src_idx"]
    kept = ~info["merged_mask"]
    for row in range(2):
        idx = src[kept[row]]
        assert torch.equal(back[row, idx], x[row, idx])
        assert torch.equal(back[row, info["dst_idx"]],
                           merged[row, :info["dst_idx"].numel()])


def test_unet_with_tome_matches_jax():
    cfg = jconfigs.UNET_TEST
    params = junet.init(jax.random.PRNGKey(4), cfg)
    tparams = tms._from_jax(tunet.param_specs(tconfigs.UNET_TEST),
                            jax.tree.map(np.asarray, params), "unet",
                            torch.float32, torch.device("cpu"))
    x = _tokens(6, (2, 16, 16, 4))
    t = np.asarray([10.0, 600.0], np.float32)
    ctx = _tokens(7, (2, 77, cfg.cross_attention_dim))
    run = jax.jit(lambda *a: junet.apply(*a[:1], cfg, *a[1:],
                                         tome_ratio=0.5))
    want = np.asarray(run(params, jnp.asarray(x), jnp.asarray(t),
                          jnp.asarray(ctx)))
    args = (tparams, tconfigs.UNET_TEST, torch.from_numpy(x),
            torch.from_numpy(t), torch.from_numpy(ctx))
    with torch.no_grad():
        got = tunet.apply(*args, tome_ratio=0.5).numpy()
        plain = tunet.apply(*args).numpy()
    assert np.abs(got - want).max() <= 1e-3
    assert np.abs(got - plain).max() > 1e-3


def _request(pb, engine_id):
    req = pb.Request(engine_id=engine_id, request_id=engine_id)
    req.prompt.add().text = "a boat"
    img = req.image
    img.height, img.width, img.steps = 64, 64, 3
    img.seed.append(9)
    return req


def test_tome_ratio_option_serves_as_in_jax(monkeypatch):
    """The engine option ``tome_ratio`` 0.5 on SD_TEST weights shared by
    both packages (the JAX random ModelSet bridged), with the JAX
    package's initial noise: the port's PNG within one level of the JAX
    servicer's, and not the unmerged engine's image."""
    bridged_random(monkeypatch)
    monkeypatch.setattr(tmodes, "txt2img_initial", _jax_initial)
    engines = [{"id": "tome", "model": "preset/test",
                "options": {"tome_ratio": 0.5}},
               {"id": "plain", "model": "preset/test"}]
    tm = TManager(engines, device="cpu", compute_dtype=torch.float32,
                  batch_max=1, gather_ms=0.0)
    jm = JManager(engines[:1], compute_dtype=jnp.float32, batch_max=1)
    try:
        port = tgen.GenerationServiceServicer(tm, batch_max=1)
        ref = jgen.GenerationServiceServicer(jm, batch_max=1)

        def image(servicer, pb, eid, ctx):
            (answer,) = servicer.Generate(_request(pb, eid), ctx)
            return timages.decode_png(answer.artifacts[0].binary)

        got = image(port, tpb, "tome", TContext())
        want = image(ref, jpb, "tome", JContext())
        plain = image(port, tpb, "plain", TContext())
        assert got.shape == want.shape == (1, 64, 64, 3)
        assert np.abs(got - want).max() <= LEVEL
        assert np.abs(got - plain).max() > LEVEL
    finally:
        tm.dispatcher.stop()
        jm.dispatcher.stop()
