"""The port's generation modes (gyre_tpu_torch.pipeline.modes, ops.resize,
the image ops, vae.encode) against the JAX package, and img2img and the
4-channel inpaint end to end on the SD_TEST preset against the JAX
package's UnifiedPipeline (inpaint9, depth2img and graft are in
tests/test_torch_modes_inpaint9.py; hires fix, tiling and the tiled decode
in tests/test_torch_modes_hires.py).

The JAX package's random draws are put in at the port's one seam,
``utils.rng.draw`` (``jax_draws``), and its txt2img noise through
``modes.txt2img_initial``: torch generators cannot reproduce threefry.

Tolerances: the mode functions and ``resize`` 1e-5 absolute (f32, sums in
another order; ``match_histograms`` exact on ties); ``vae.encode``'s mean
and logvar 1e-3, as for the other models; images end to end 2e-3 absolute
in [0, 1], as for txt2img and the samplers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gyre_tpu.models import configs
from gyre_tpu.models import modelset as jms
from gyre_tpu.models import vae as jvae
from gyre_tpu.ops import images as jimages
from gyre_tpu.pipeline import modes as jmodes
from gyre_tpu.pipeline import unified as junified
from gyre_tpu.utils import rng as jrng
from gyre_tpu_torch.models import modelset as tms
from gyre_tpu_torch.models import vae as tvae
from gyre_tpu_torch.ops import images as timages
from gyre_tpu_torch.ops import resize as tresize
from gyre_tpu_torch.pipeline import modes as tmodes
from gyre_tpu_torch.pipeline import unified as tunified
from gyre_tpu_torch.utils import rng as trng

CFG = configs.SD_TEST
SIZE = 64
REQUEST = dict(prompt="a (red:1.2) boat at [dusk]", negative_prompt="blurry",
               height=SIZE, width=SIZE, steps=4, sampler="k_euler",
               guidance_scale=7.5, seeds=[3, 4])


# ----------------------------------------------------------------- helpers


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one CPU thread while the module runs. The suite runs its
    files in parallel processes; with torch's intra-op threads in each,
    every small op of a UNet call waits at a thread barrier for cores the
    other processes hold, and a call that takes 0.1 s alone takes minutes.
    One thread each keeps a call at its own speed."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_key(key):
    """The JAX package's key for a port key: the seed's root key with the
    key's sub-streams folded in."""
    seed, *subs = key if isinstance(key, tuple) else (key,)
    k = jrng.key_for_seed(seed)
    for name in subs:
        k = jrng.stream(k, name)
    return k


def jax_keys(keys):
    return jnp.stack([jax_key(k) for k in keys])


def _jax_draw(keys, path, shape, device, dist="normal"):
    rows = []
    for key in keys:
        k = jax_key(key)
        for p in path:
            k = jrng.stream(k, p) if isinstance(p, str) else \
                jrng.step_key(k, p)
        fn = jax.random.uniform if dist == "uniform" else jax.random.normal
        rows.append(np.asarray(fn(k, tuple(shape), jnp.float32)))
    return torch.from_numpy(np.stack(rows)).to(device)


def _jax_initial(keys, shape, sigma_max, device, natural=0):
    x = jmodes.txt2img_initial(jax_keys(keys), shape, sigma_max,
                               natural=natural)
    return torch.from_numpy(np.array(x)).to(device)


@pytest.fixture
def jax_draws(monkeypatch):
    """Every random draw of the port's pipeline from the JAX package."""
    monkeypatch.setattr(trng, "draw", _jax_draw)
    monkeypatch.setattr(tmodes, "txt2img_initial", _jax_initial)


def make_pipes(cfg, graft_cfg=None):
    """(JAX pipeline, port pipeline) on the same random weights (seed 0;
    a grafted top model from seed 1)."""
    def both(c, seed):
        ms = jms.random_modelset(c, seed=seed, dtype=jnp.float32)
        tree = (jax.tree.map(np.asarray, ms.unet_params),
                jax.tree.map(np.asarray, ms.vae_params),
                [jax.tree.map(np.asarray, t) for t in ms.text_params])
        return ms, tms.from_jax_params(*tree, c, device="cpu")

    jms_, tms_ = both(cfg, 0)
    jg = tg = None
    if graft_cfg is not None:
        jg, tg = both(graft_cfg, 1)
    return (junified.UnifiedPipeline(jms_, compute_dtype=jnp.float32,
                                     graft_ms=jg),
            tunified.UnifiedPipeline(tms_, compute_dtype=torch.float32,
                                     graft_ms=tg))


def init_image(size=SIZE, batch=2, seed=11):
    """A smooth random image: gradients and blobs, values in [0, 1] with
    some clipped to 0 and 1 (ties for match_histograms)."""
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    imgs = []
    for _ in range(batch):
        c = r.uniform(-0.3, 1.3, (3, 3))
        img = np.stack([c[i, 0] * yy + c[i, 1] * xx + c[i, 2] *
                        np.sin(6 * xx * yy + i) for i in range(3)], -1)
        imgs.append(np.clip(img, 0, 1))
    return np.asarray(imgs, np.float32)


def mask_image(size=SIZE, batch=2):
    """1 regenerates: a block off the centre and a soft band."""
    m = np.zeros((batch, size, size, 1), np.float32)
    m[:, size // 4:size * 3 // 4, size // 8:size // 2] = 1.0
    m[1, :, -12:] = 0.5
    return m


def check_images(pipes, request, size=SIZE, tol=2e-3):
    """The port's image against the JAX package's single scan."""
    jpipe, tpipe = pipes
    ref = np.asarray(jpipe(**request))
    out = tpipe(**request).numpy()
    assert out.shape == ref.shape == (len(request["seeds"]), size, size, 3)
    err = np.abs(out - ref).max()
    assert err <= tol, err
    return out, ref


# --------------------------------------------------------- mode functions


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("src,dst,method", [
    ((72, 72), (128, 128), "bicubic"), ((128, 128), (72, 72), "bicubic"),
    ((8, 12), (13, 5), "bicubic"), ((512, 512), (64, 64), "bilinear"),
    ((8, 8), (64, 64), "bilinear"), ((9, 7), (20, 3), "bilinear"),
    ((8, 12), (64, 96), "nearest"), ((10, 10), (7, 13), "nearest")])
def test_resize_matches_jax(src, dst, method):
    x = np.random.default_rng(0).standard_normal((2, *src, 3)).astype(
        np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, *dst, 3), method))
    out = tresize.resize(torch.from_numpy(x), dst, method).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def test_interpolate_is_not_jax_resize():
    """Why ops/resize.py exists: F.interpolate's bicubic up is far off."""
    x = np.random.default_rng(1).standard_normal((1, 72, 72, 4)).astype(
        np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (1, 128, 128, 4),
                                      "bicubic"))
    interp = torch.nn.functional.interpolate(
        torch.from_numpy(x).permute(0, 3, 1, 2), size=(128, 128),
        mode="bicubic").permute(0, 2, 3, 1).numpy()
    assert np.abs(interp - ref).max() > 0.1


@pytest.mark.parametrize("name,args", [
    ("normalise", ()), ("normalise", (-1.0, 1.0)), ("to_grayscale", ()),
    ("gaussian_blur", (2.0,)), ("gaussian_blur", (0.6,))])
def test_image_ops_match_jax(name, args):
    x = np.random.default_rng(2).random((2, 19, 13, 3)).astype(np.float32)
    ref = np.asarray(getattr(jimages, name)(jnp.asarray(x), *args))
    out = getattr(timages, name)(torch.from_numpy(x), *args).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def test_match_histograms_matches_jax_on_ties():
    """Images clipped to [0, 1]: many ties at 0 and 1, ranked by pixel
    order as jnp.argsort's stable sort ranks them."""
    r = np.random.default_rng(3)
    src = np.clip(r.standard_normal((2, 16, 16, 3)) * 0.6 + 0.5, 0, 1)
    ref = np.clip(r.standard_normal((2, 16, 16, 3)) * 0.4 + 0.3, 0, 1)
    src, ref = src.astype(np.float32), ref.astype(np.float32)
    assert (src == 0).sum() > 50 and (src == 1).sum() > 50
    want = np.asarray(jimages.match_histograms(jnp.asarray(src),
                                               jnp.asarray(ref)))
    got = timages.match_histograms(torch.from_numpy(src),
                                   torch.from_numpy(ref)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def vae_params():
    ms = jms.random_modelset(CFG, seed=0, dtype=jnp.float32)
    tree = (jax.tree.map(np.asarray, ms.unet_params),
            jax.tree.map(np.asarray, ms.vae_params),
            [jax.tree.map(np.asarray, t) for t in ms.text_params])
    return ms.vae_params, tms.from_jax_params(*tree, CFG,
                                              device="cpu").vae_params


def test_vae_encode_matches_jax(vae_params):
    jp, tp = vae_params
    x = np.random.default_rng(4).uniform(-1, 1, (2, 64, 48, 3)).astype(
        np.float32)
    jm, jl = jax.jit(lambda p, x: jvae.encode(p, CFG.vae, x))(
        jp, jnp.asarray(x))
    tm, tl = tvae.encode(tp, CFG.vae, torch.from_numpy(x))
    assert tm.shape == tl.shape == (2, 8, 6, 4)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-3)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-3)
    noise = np.random.default_rng(5).standard_normal(tm.shape).astype(
        np.float32)
    np.testing.assert_allclose(
        tvae.sample_posterior(tm, tl, torch.from_numpy(noise)).numpy(),
        np.asarray(jvae.sample_posterior(jm, jl, noise)), atol=1e-3)


LAT = np.random.default_rng(6).standard_normal((2, 8, 8, 4)).astype(
    np.float32)
KEEP = (np.random.default_rng(7).random((2, 8, 8, 1)) > 0.4).astype(
    np.float32)


@pytest.mark.parametrize("fill", ["zero", "random", "original", "shaped"])
def test_masked_area_fills_match_jax(jax_draws, fill):
    keys = [3, 4]
    if fill == "shaped":
        ref = jmodes.shaped_noise_fill(jnp.asarray(LAT), jnp.asarray(KEEP),
                                       jax_keys(keys))
        out = tmodes.shaped_noise_fill(_t(LAT), _t(KEEP), keys)
    else:
        ref = jmodes.masked_area_fill(jnp.asarray(LAT), jnp.asarray(KEEP),
                                      jax_keys(keys), fill)
        out = tmodes.masked_area_fill(_t(LAT), _t(KEEP), keys, fill)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_img2img_initial_and_blend_match_jax(jax_draws):
    keys = [3, 4]
    ref = jmodes.img2img_initial(jnp.asarray(LAT), jax_keys(keys), 7.5)
    out = tmodes.img2img_initial(_t(LAT), keys, 7.5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    soft = np.random.default_rng(8).random((2, 8, 8, 1)).astype(np.float32)
    jwrap, jfinal = jmodes.make_inpaint_blend(jnp.asarray(LAT),
                                              jnp.asarray(soft), 14.6, 0.03)
    twrap, tfinal = tmodes.make_inpaint_blend(_t(LAT), _t(soft), 14.6, 0.03)
    x = np.random.default_rng(9).standard_normal(LAT.shape).astype(
        np.float32)
    for sigma in (14.6, 3.0, 0.7, 0.03):
        ref = jwrap(lambda x, s: x * 0.5)(jnp.asarray(x), jnp.float32(sigma))
        out = twrap(lambda x, s: x * 0.5)(_t(x), sigma)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(tfinal(_t(x)).numpy(),
                               np.asarray(jfinal(jnp.asarray(x))), atol=1e-5)


def test_hires_fix_and_graft_wrappers_match_jax(jax_draws):
    """The cross-injection of the hires fix and the graft's random-map
    blend, on analytic denoisers at a few sigmas."""
    keys = [3, (4, "x")]
    jk = jax_keys(keys)
    jprog = jmodes.log_progress(jnp.float32(14.6), jnp.float32(0.03))
    tprog = tmodes.log_progress(14.6, 0.03)
    jwrap, jpack, _ = jmodes.make_hires_fix(jk, 8, 8, 12, 12)
    twrap, tpack, tunpack = tmodes.make_hires_fix(keys, 8, 8, 12, 12)
    lo = np.random.default_rng(10).standard_normal((2, 8, 8, 4))
    hi = np.random.default_rng(11).standard_normal((2, 12, 12, 4))
    lo, hi = lo.astype(np.float32), hi.astype(np.float32)
    jx, tx = jpack(jnp.asarray(lo), jnp.asarray(hi)), tpack(_t(lo), _t(hi))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    assert torch.equal(tunpack(tx)[0], _t(lo))
    jgw = jmodes.make_graft(jk)(lambda x, s: x * 0.9, lambda x, s: -x,
                                jprog)
    tgw = tmodes.make_graft(keys)(lambda x, s: x * 0.9, lambda x, s: -x,
                                  tprog)
    jhw = jwrap(lambda x, s: x * 0.5, lambda x, s: x * 0.8, jprog)
    thw = twrap(lambda x, s: x * 0.5, lambda x, s: x * 0.8, tprog)
    for sigma in (14.6, 4.0, 1.0, 0.2, 0.03):
        s = jnp.float32(sigma)
        np.testing.assert_allclose(thw(tx, sigma).numpy(),
                                   np.asarray(jhw(jx, s)), atol=1e-5)
        np.testing.assert_allclose(tgw(_t(hi), sigma).numpy(),
                                   np.asarray(jgw(jnp.asarray(hi), s)),
                                   atol=1e-5)


def test_extra_channel_wrappers_match_jax():
    mask = _t(KEEP)
    ml = _t(LAT)
    x = np.random.default_rng(12).standard_normal((4, 8, 8, 4)).astype(
        np.float32)
    t = np.zeros(4, np.float32)

    def model(x, t, context):
        return x

    ref = jmodes.make_inpaint9_inputs(jnp.asarray(KEEP), jnp.asarray(LAT))(
        model)(jnp.asarray(x), t, None)
    out = tmodes.make_inpaint9_inputs(mask, ml)(model)(_t(x), _t(t), None)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    ref = jmodes.make_extra_channels_wrapper(jnp.asarray(KEEP))(model)(
        jnp.asarray(x), t, None)
    out = tmodes.make_extra_channels_wrapper(mask)(model)(_t(x), _t(t),
                                                          None)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_draws_are_per_key():
    """A key's draw does not depend on the batch; sub-streams and uniform
    draws are streams of their own."""
    a = trng.batched_uniform([5, (5, "lo"), 6], (3, 3, 1), "cpu")
    assert torch.equal(a[0], trng.batched_uniform([5], (3, 3, 1), "cpu")[0])
    assert not torch.equal(a[0], a[1]) and not torch.equal(a[0], a[2])
    assert 0.0 <= float(a.min()) and float(a.max()) < 1.0
    assert trng.substream([5, (6, "a")], "b") == [(5, "b"), (6, "a", "b")]
    n = trng.batched_stream_normal([(5, "lo")], "init", 0, (4,), "cpu")
    assert not torch.equal(
        n, trng.batched_stream_normal([5], "init", 0, (4,), "cpu"))


# ------------------------------------------------------------ end to end


@pytest.fixture(scope="module")
def pipes():
    return make_pipes(CFG)


def test_img2img_matches_jax(pipes, jax_draws):
    check_images(pipes, dict(REQUEST, init_image=init_image(),
                             strength=0.6))


@pytest.mark.parametrize("fill", ["shaped", "zero", "random", "original"])
def test_inpaint_matches_jax(pipes, jax_draws, fill):
    """4-channel inpainting: the masked-area fill, the per-step blend and
    the image-space outmask composite with its histogram match."""
    init = init_image()
    out, _ = check_images(pipes, dict(
        REQUEST, init_image=init, mask_image=mask_image(), strength=1.0,
        masked_area_init=fill))
    # pixels the upsampled keep mask holds at 1 are the init image's
    keep = np.asarray(jax.image.resize(
        1.0 - jnp.asarray(mask_image()).reshape(2, 8, 8, 8, 8, 1).mean(
            (2, 4)), (2, SIZE, SIZE, 1), "bilinear")) >= 1.0
    assert keep.any() and (~keep).any()
    np.testing.assert_array_equal(np.where(keep, out, 0),
                                  np.where(keep, init, 0))


@pytest.mark.parametrize("kwargs,total", [
    ({"init_image": init_image(), "strength": 0.7}, 4),    # 4 of 5 steps
    ({"init_image": init_image(), "mask_image": mask_image(),
      "strength": 1.0}, 5),
], ids=["img2img", "inpaint"])
def test_modes_chunked_equal_unchunked(pipes, kwargs, total):
    from test_torch_pipeline_samplers import check_chunked

    check_chunked(pipes[1], dict(REQUEST, steps=5, **kwargs), total)
