"""The port's warp and motion schedule (aphantasia_torch/ops/warp.py,
motion/anima.py) against the JAX package on the CPU: bilinear sampling
under its three paddings, the torchvision-style affine of the video
frames at the corners and under the zero fill, the homography grid, and
the keyframe curves and the 4-track motion schedule, which must be equal
exactly (host numpy and scipy on both sides, the same seeds)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from aphantasia_tpu.motion import anima as janima
from aphantasia_tpu.ops import warp as jwarp
from aphantasia_torch.motion import anima as tanima
from aphantasia_torch.ops import warp as twarp


def _img(seed, shape):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


@pytest.mark.parametrize("padding", ["zeros", "border", "reflection"])
@pytest.mark.parametrize("align", [True, False])
def test_grid_sample_matches_jax(padding, align):
    """A grid reaching 60% past every edge (so zero taps, clamped taps and
    two reflections all occur), batched and unbatched: within 1e-5."""
    img = _img(0, (2, 3, 13, 17))
    grid = (np.random.RandomState(1).rand(2, 9, 11, 2) * 3.2 - 1.6
            ).astype(np.float32)
    want = np.asarray(jwarp.grid_sample(jnp.asarray(img), jnp.asarray(grid),
                                        padding, align, fill=0.25))
    got = twarp.grid_sample(torch.tensor(img), torch.tensor(grid), padding,
                            align, fill=0.25).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    want1 = np.asarray(jwarp.grid_sample(jnp.asarray(img[0]),
                                         jnp.asarray(grid[0]), padding, align))
    got1 = twarp.grid_sample(torch.tensor(img[0]), torch.tensor(grid[0]),
                             padding, align).numpy()
    np.testing.assert_allclose(got1, want1, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("padding", ["zeros", "border", "reflection"])
def test_grid_sample_matches_torch_grid_sample(padding):
    """The same function as `F.grid_sample` (bilinear, align_corners=True)
    on a grid inside and outside the frame: within 1e-5."""
    img = _img(2, (1, 2, 10, 14))
    grid = (np.random.RandomState(3).rand(1, 7, 9, 2) * 2.8 - 1.4
            ).astype(np.float32)
    want = F.grid_sample(torch.tensor(img), torch.tensor(grid), "bilinear",
                         padding, align_corners=True).numpy()
    got = twarp.grid_sample(torch.tensor(img), torch.tensor(grid),
                            padding).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("motion", [
    (0.0, (0.0, 0.0), 1.0, 0.0),          # identity
    (3.0, (1.5, -2.0), 1.02, 0.5),        # a frame of the schedule
    (-35.0, (9.0, 6.5), 0.8, 12.0),       # corners pulled in: zero fill
    (90.0, (-14.0, 11.0), 1.3, -20.0),    # most of the frame shifted out
])
def test_frame_transform_matches_jax(motion):
    """`frame_transform` (and `tv_affine` on an unbatched image) on a
    24x32 three-channel frame: within 1e-5 everywhere, the four corner
    pixels and every zero-filled pixel included; float motion scalars and
    0-d float32 tensors give the same frame."""
    angle, shift, scale, shear = motion
    img = _img(4, (1, 3, 24, 32)) * 4.0 - 2.0
    want = np.asarray(jwarp.frame_transform(
        jnp.asarray(img), (24, 32), jnp.float32(angle),
        tuple(jnp.float32(s) for s in shift), jnp.float32(scale),
        jnp.float32(shear)))
    got = twarp.frame_transform(torch.tensor(img), (24, 32), angle, shift,
                                scale, shear).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    corners = (slice(None), slice(None), [0, 0, -1, -1], [0, -1, 0, -1])
    np.testing.assert_allclose(got[corners], want[corners], atol=1e-5)
    t = [torch.tensor(v, dtype=torch.float32) for v in
         (angle, shift[0], shift[1], scale, shear)]
    got_t = twarp.frame_transform(torch.tensor(img), (24, 32), t[0],
                                  (t[1], t[2]), t[3], t[4]).numpy()
    np.testing.assert_array_equal(got_t, got)
    unb = twarp.tv_affine(torch.tensor(img[0]), angle, shift, scale,
                          shear).numpy()
    np.testing.assert_array_equal(unb, got[0])
    if motion[0] == 0.0 and motion[2] == 1.0:
        np.testing.assert_allclose(got, img, atol=1e-6)


def test_frame_transform_zero_fill_is_per_tap():
    """A constant frame shifted by half a pixel past its edge: the edge
    column mixes the frame with one zero tap (0.5 of the value), as JAX's
    per-tap fill gives, and the columns shifted out are zero."""
    img = np.ones((1, 1, 6, 8), np.float32)
    got = twarp.tv_affine(torch.tensor(img), 0.0, (2.5, 0.0)).numpy()
    want = np.asarray(jwarp.tv_affine(jnp.asarray(img), 0.0, (2.5, 0.0)))
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(got[0, 0, :, 2], 0.5, atol=1e-6)
    assert (got[0, 0, :, :2] == 0).all() and (got[0, 0, :, 3:] == 1).all()


def test_affine_matrix_base_grid_and_homography_match_jax():
    inv, tr = twarp.inverse_affine_px(17.0, (2.0, -3.0), 1.1, 7.0)
    jinv, jt = jwarp.inverse_affine_px(17.0, (2.0, -3.0), 1.1, 7.0)
    np.testing.assert_allclose(inv.numpy(), np.asarray(jinv), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jt))
    np.testing.assert_allclose(twarp.base_grid(5, 7).numpy(),
                               np.asarray(jwarp.base_grid(5, 7)), atol=1e-7)
    mat = np.asarray([[1.05, 0.02, -1.5], [-0.03, 0.97, 2.0],
                      [1e-3, -2e-3, 1.0]], np.float32)
    got = twarp.homography_grid(torch.tensor(mat), 9, 12)
    want = jwarp.homography_grid(jnp.asarray(mat), 9, 12)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-5)


def test_keyframe_curves_equal_jax():
    """smoothstep, lerp, slerp_np, cublerp and latent_anima (uniform and
    gaussian keys, cubic, slerp and lerp segments, looped or not, with a
    gaussian filter) equal the JAX package's bit for bit."""
    x = np.linspace(-0.2, 1.2, 33)
    for nn in (0.5, 1.0, 2.0, 2.5):
        np.testing.assert_array_equal(tanima.smoothstep(x, nn),
                                      janima.smoothstep(x, nn))
    rs = np.random.RandomState(5)
    z1, z2 = rs.randn(4, 3), rs.randn(4, 3)
    for fn in ("lerp", "slerp_np"):
        np.testing.assert_array_equal(getattr(tanima, fn)(z1, z2, 7, 0.5),
                                      getattr(janima, fn)(z1, z2, 7, 0.5))
    pts = rs.rand(5, 2)
    np.testing.assert_array_equal(tanima.cublerp(pts, 5, 4),
                                  janima.cublerp(pts, 5, 4))
    for kw in (dict(uniform=True, cubic=True, start_lat=[0.6]),
               dict(uniform=False, cubic=False, looped=False),
               dict(uniform=True, cubic=False, smooth=1.5),
               dict(gauss=True)):
        shape = [1, 3] if kw.get("gauss") else [1]
        np.testing.assert_array_equal(
            tanima.latent_anima(shape, 37, 8, seed=3, **kw),
            janima.latent_anima(shape, 37, 8, seed=3, **kw))


@pytest.mark.parametrize("gen", ["RGB", "FFT"])
@pytest.mark.parametrize("glob_steps,fstep", [(600, 100), (9, 4), (4, 2)])
def test_motion_schedule_equals_jax(gen, glob_steps, fstep):
    """The four tracks of `motion_schedule` exactly equal the JAX
    package's for the CLI's defaults, a short run and the smallest
    (a track may run past the last frame, which no frame reads)."""
    kw = dict(scale=0.012, shift=10.0, angle=0.8, shear=0.4, seed=7)
    got = tanima.motion_schedule(glob_steps, fstep, gen, **kw)
    want = janima.motion_schedule(glob_steps, fstep, gen, **kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.shape[0] >= glob_steps
        np.testing.assert_array_equal(g, w)
