"""FAST + ORB kernels: synthetic-corner ground truth and cv2 cross-checks."""

import jax.numpy as jnp
import numpy as np
import pytest

from gfplslam_tpu.ops import fast, orb, pyramid


def square_grid(h=64, w=64, sq=16):
    """Isolated bright squares: their corners are genuine FAST-9 corners
    (checkerboard X-junctions are not — no 9-long contiguous arc)."""
    img = np.zeros((h, w), np.float32)
    for i in range(2, h - sq, 2 * sq):
        for j in range(2, w - sq, 2 * sq):
            img[i:i + sq, j:j + sq] = 200.0
    return img


def test_fast_detects_corner():
    # an isolated bright square produces corners at its vertices
    img = np.zeros((48, 48), np.float32)
    img[16:32, 16:32] = 255.0
    s = np.asarray(fast.fast_score_map(jnp.asarray(img), 20.0))
    assert s.max() > 0
    ys, xs = np.nonzero(s)
    # all responses near the square boundary
    assert np.all((ys >= 13) & (ys <= 34) & (xs >= 13) & (xs <= 34))


def test_fast_flat_image_silent():
    img = np.full((48, 48), 80.0, np.float32)
    s = np.asarray(fast.fast_score_map(jnp.asarray(img), 20.0))
    assert s.max() == 0


def test_fast_agrees_with_cv2():
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(3)
    img = (rng.uniform(0, 255, size=(96, 128))).astype(np.float32)
    img = np.asarray(pyramid.gaussian_blur(jnp.asarray(img), 1.5, 3))
    u8 = np.clip(img, 0, 255).astype(np.uint8)
    det = cv2.FastFeatureDetector_create(threshold=20, nonmaxSuppression=False)
    kps = det.detect(u8, None)
    cv_set = {(int(round(k.pt[1])), int(round(k.pt[0]))) for k in kps}
    s = np.asarray(fast.fast_score_map(jnp.asarray(img), 20.0))
    our_set = set(zip(*np.nonzero(s)))
    # interior only (cv2 uses a different border policy)
    cv_in = {(y, x) for (y, x) in cv_set if 4 <= y < 92 and 4 <= x < 124}
    our_in = {(y, x) for (y, x) in our_set if 4 <= y < 92 and 4 <= x < 124}
    if cv_in:
        jaccard = len(cv_in & our_in) / len(cv_in | our_in)
        assert jaccard > 0.8, f"jaccard {jaccard}"


@pytest.mark.parametrize("h,w,th", [(40, 70, 20.0), (64, 100, 7.0),
                                    (33, 45, 35.0)])
def test_fast_score_map_matches_arc_reference(h, w, th):
    """Integer intensities make the bf16 margins exact, so the score map
    equals the per-pixel FAST-9 arc-score definition bit for bit."""
    from chip_smoke import fast_score_reference
    rng = np.random.default_rng(h * w)
    img = rng.integers(0, 256, size=(h, w)).astype(np.float32)
    got = np.asarray(fast.fast_score_map(jnp.asarray(img), jnp.asarray(th)))
    ref = fast_score_reference(img, th)
    assert (ref > 0).any()
    np.testing.assert_array_equal(got, ref)


def test_fast_score_vmap_traced_threshold():
    """frame.py's per-level pattern: vmap over padded levels with a
    closed-over traced threshold (the adaptive-FAST scalar) equals one call
    per image."""
    import jax
    rng = np.random.default_rng(12)
    imgs = jnp.asarray(rng.integers(0, 256, size=(3, 40, 64))
                       .astype(np.float32))

    @jax.jit
    def run(imgs, th):
        return jax.vmap(lambda im: fast.fast_score_map(im, th))(imgs)

    for th in (10.0, 35.0):
        out = np.asarray(run(imgs, jnp.asarray(th)))
        ref = np.stack([np.asarray(fast.fast_score_map(imgs[i],
                                                       jnp.asarray(th)))
                        for i in range(3)])
        np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("h,w,scale", [(40, 70, 1.0), (33, 45, 1.0),
                                       (30, 64, 0.37)])
def test_fast_triton_kernel_interpret_matches_xla(h, w, scale):
    """The GPU kernel in the Pallas interpreter equals the XLA formulation
    bit for bit, on shapes that are and are not whole tiles and on
    non-integer intensities (blurred pyramid levels), where both round
    every margin to bf16 the same way. The wrapper pads and crops back."""
    rng = np.random.default_rng(h + w)
    img = jnp.asarray(rng.integers(0, 256, size=(h, w)).astype(np.float32)
                      * scale)
    th = jnp.asarray(12.0)
    got = np.asarray(fast.fast_score_map_triton(img, th, interpret=True))
    ref = np.asarray(fast.fast_score_map_xla(img, th))
    assert got.shape == (h, w)
    assert (ref > 0).any()
    np.testing.assert_array_equal(got, ref)
    assert not got[:3].any() and not got[:, -3:].any()


def test_fast_triton_kernel_vmap_traced_threshold():
    """The front end's pattern on the GPU path: the kernel vmapped over
    (camera, level) images with a traced threshold."""
    import jax
    rng = np.random.default_rng(5)
    imgs = jnp.asarray(rng.integers(0, 256, size=(2, 2, 24, 40))
                       .astype(np.float32))

    @jax.jit
    def run(imgs, th):
        f = lambda im: fast.fast_score_map_triton(im, th, interpret=True)
        return jax.vmap(jax.vmap(f))(imgs)

    th = jnp.asarray(15.0)
    out = np.asarray(run(imgs, th))
    for c in range(2):
        for lv in range(2):
            np.testing.assert_array_equal(
                out[c, lv], np.asarray(fast.fast_score_map_xla(imgs[c, lv],
                                                               th)))


def test_fast_score_map_kernel_choice():
    """fast_score_map lowers to the Triton kernel for CUDA and to plain
    XLA for the CPU."""
    import jax
    img = jnp.zeros((24, 40), jnp.float32)
    th = jnp.asarray(20.0)
    traced = jax.jit(fast.fast_score_map).trace(img, th)
    cpu = traced.lower(lowering_platforms=("cpu",)).as_text()
    cuda = traced.lower(lowering_platforms=("cuda",)).as_text()
    assert "custom_call" not in cpu
    assert "fast9_score" in cuda and "triton" in cuda


def test_select_keypoints_shapes_and_spread():
    img = square_grid()
    s = fast.fast_score_map(jnp.asarray(img), 20.0)
    kps = fast.select_keypoints(s, n_out=64, cell=16, per_cell=2, border=4)
    assert kps.xy.shape == (64, 2)
    n_valid = int(np.sum(np.asarray(kps.valid)))
    assert n_valid > 4
    xy = np.asarray(kps.xy)[np.asarray(kps.valid)]
    # keypoints spread over multiple cells
    assert len({(int(x) // 16, int(y) // 16) for x, y in xy}) >= 4


def test_ic_angle_gradient_direction():
    # horizontal intensity ramp -> centroid points +x -> angle ~ 0
    img = np.tile(np.arange(64, dtype=np.float32), (64, 1))
    a = float(orb.ic_angle_one(jnp.asarray(img), jnp.asarray([32.0, 32.0])))
    assert abs(a) < 0.1
    # vertical ramp -> angle ~ pi/2
    a2 = float(orb.ic_angle_one(jnp.asarray(img.T), jnp.asarray([32.0, 32.0])))
    assert abs(a2 - np.pi / 2) < 0.1


def test_descriptor_rotation_invariance(rng):
    """Descriptors of the same patch under 90-degree rotation should be much
    closer (with steering) than random descriptor pairs."""
    img = rng.uniform(0, 255, size=(96, 96)).astype(np.float32)
    img = np.asarray(pyramid.gaussian_blur(jnp.asarray(img), 2.0, 3))
    rot = np.rot90(img, k=-1).copy()  # (x,y) -> (N-1-y, x)
    xy = jnp.asarray([48.0, 48.0])
    a0 = orb.ic_angle_one(jnp.asarray(img), xy)
    a1 = orb.ic_angle_one(jnp.asarray(rot), xy)
    d0 = orb.brief_descriptor_one(jnp.asarray(img), xy, a0)
    d1 = orb.brief_descriptor_one(jnp.asarray(rot), xy, a1)
    from gfplslam_tpu.ops.hamming import hamming_matrix
    dist = int(hamming_matrix(d0[None], d1[None])[0, 0])
    # random pairs average 128; steered same-point should be well below
    assert dist < 80, dist


def test_descriptor_determinism(rng):
    img = rng.uniform(0, 255, size=(64, 64)).astype(np.float32)
    xy = jnp.asarray([[32.0, 32.0], [20.0, 40.0]])
    ang = orb.ic_angles(jnp.asarray(img), xy)
    d1 = np.asarray(orb.brief_descriptors(jnp.asarray(img), xy, ang))
    d2 = np.asarray(orb.brief_descriptors(jnp.asarray(img), xy, ang))
    assert d1.dtype == np.uint32 and d1.shape == (2, 8)
    np.testing.assert_array_equal(d1, d2)


def test_pyramid_shapes():
    img = jnp.zeros((480, 752))
    lv = pyramid.build_pyramid(img, 4, 1.2)
    assert [l.shape for l in lv] == [(480, 752), (400, 627), (333, 522), (278, 435)]
