"""ORB orientation + 256-bit binary descriptors as batched gather kernels.

Capability parity with the reference's extractor (ORBextractor.cc): intensity
-centroid orientation ``IC_Angle`` (:77-102) and rotated-BRIEF descriptors
(:103-142, 1043-1105). Design decisions:

- orientation and description are ``vmap``-ed closed forms over the padded
  keypoint array (one gather kernel each), not per-keypoint loops;
- the sampling pattern defaults to ORB's standard learned 256-pair table
  (public constant data, ops/orb_pattern.py; reference ships the same table
  at ORBextractor.cc:150-406) expressed in sample-pool form: the 512 pair
  endpoints dedupe to 375 unique offsets, so each keypoint costs 375
  gathers + 256 comparisons. A generated isotropic-Gaussian pool
  (``make_brief_pool``) remains available for A/B runs;
- descriptors are packed into 8 uint32 words for popcount matching
  (stereoFrame.h:185-201's bit-hack becomes ``lax.population_count``).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

PATCH_RADIUS = 15          # orientation disc radius (HALF_PATCH_SIZE)
DESC_BITS = 256
DESC_WORDS = 8             # 256 bits / 32


def _disc_mask(radius: int) -> np.ndarray:
    y, x = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    return (x * x + y * y <= radius * radius).astype(np.float32)


_DISC = _disc_mask(PATCH_RADIUS)
_DISC_X = (_DISC * np.mgrid[-PATCH_RADIUS:PATCH_RADIUS + 1,
                            -PATCH_RADIUS:PATCH_RADIUS + 1][1]).astype(np.float32)
_DISC_Y = (_DISC * np.mgrid[-PATCH_RADIUS:PATCH_RADIUS + 1,
                            -PATCH_RADIUS:PATCH_RADIUS + 1][0]).astype(np.float32)


def make_brief_pattern(seed: int = 1234, n_bits: int = DESC_BITS,
                       radius: int = 13) -> np.ndarray:
    """[n_bits, 4] int32 (x1, y1, x2, y2) — BRIEF-II isotropic Gaussian pairs,
    sigma = patch_size/5, clipped to the sampling radius. Deterministic."""
    rng = np.random.default_rng(seed)
    sigma = (2 * radius + 1) / 5.0
    pts = rng.normal(scale=sigma, size=(n_bits, 4))
    return np.clip(np.round(pts), -radius, radius).astype(np.int32)


BRIEF_PATTERN = make_brief_pattern()


def make_brief_pool(seed: int = 1234, n_pool: int = DESC_BITS,
                    n_bits: int = DESC_BITS, radius: int = 13):
    """Sample-pool BRIEF: ``n_pool`` isotropic-Gaussian offsets plus
    ``n_bits`` comparison pairs drawn from the pool (each sample feeds ~2
    bits). Halves the per-keypoint gather count vs independent pairs at a
    negligible descriptor-correlation cost. Deterministic."""
    rng = np.random.default_rng(seed)
    sigma = (2 * radius + 1) / 5.0
    pool = np.clip(np.round(rng.normal(scale=sigma, size=(n_pool, 2))),
                   -radius, radius).astype(np.int32)
    pairs = set()
    out = []
    while len(out) < n_bits:
        i, j = rng.integers(0, n_pool, 2)
        key = (min(i, j), max(i, j))
        if i != j and key not in pairs and not np.array_equal(pool[i], pool[j]):
            pairs.add(key)
            out.append((i, j))
    return pool, np.asarray(out, np.int32)


RANDOM_POOL, RANDOM_PAIRS = make_brief_pool()

from gfplslam_tpu.ops.orb_pattern import orb_pool_pairs  # noqa: E402

ORB_POOL, ORB_PAIRS = orb_pool_pairs()

# active pattern (learned ORB table by default; see set_pattern)
BRIEF_POOL, BRIEF_PAIRS = ORB_POOL, ORB_PAIRS


def set_pattern(kind: str = "orb") -> None:
    """Select the descriptor sampling pattern: "orb" (learned table,
    default) or "random" (generated Gaussian pool). The pool is captured at
    trace time, so call this before building any jitted program (or run
    ``jax.clear_caches()`` after switching)."""
    global BRIEF_POOL, BRIEF_PAIRS
    if kind == "orb":
        BRIEF_POOL, BRIEF_PAIRS = ORB_POOL, ORB_PAIRS
    elif kind == "random":
        BRIEF_POOL, BRIEF_PAIRS = RANDOM_POOL, RANDOM_PAIRS
    else:
        raise ValueError(f"unknown pattern {kind!r}")


def _gather_patch(img: jax.Array, cx: jax.Array, cy: jax.Array,
                  radius: int) -> jax.Array:
    """[2r+1, 2r+1] patch around (cx, cy) with clamped borders."""
    h, w = img.shape
    dy = jnp.arange(-radius, radius + 1)
    dx = jnp.arange(-radius, radius + 1)
    ys = jnp.clip(cy.astype(jnp.int32) + dy, 0, h - 1)
    xs = jnp.clip(cx.astype(jnp.int32) + dx, 0, w - 1)
    return img[ys[:, None], xs[None, :]]


def ic_angle_one(img: jax.Array, xy: jax.Array) -> jax.Array:
    """Intensity-centroid orientation of one keypoint (IC_Angle,
    ORBextractor.cc:77-102): atan2(m01, m10) over the radius-15 disc."""
    patch = _gather_patch(img, xy[0], xy[1], PATCH_RADIUS)
    m10 = jnp.sum(patch * jnp.asarray(_DISC_X))
    m01 = jnp.sum(patch * jnp.asarray(_DISC_Y))
    return jnp.arctan2(m01, m10)


def ic_angles(img: jax.Array, xy: jax.Array) -> jax.Array:
    """[N,2] keypoints -> [N] angles (radians)."""
    return jax.vmap(lambda p: ic_angle_one(img, p))(xy)


def _box_filter(x: jax.Array, radius: int) -> jax.Array:
    """(2r+1)-square box sum as banded-matrix matmuls (see
    pyramid._separable_mxu). Border behavior: zero outside (the cumsum
    form's semantics)."""
    from gfplslam_tpu.ops.pyramid import _band_matrix
    h, w = x.shape[-2], x.shape[-1]
    ones = tuple([1.0] * (2 * radius + 1))
    # f32 (not bf16): the coordinate-weighted moment inputs reach ~2e5 and
    # the caller subtracts nearly-equal box sums — bf16 rounding would
    # corrupt the orientation angles
    mv = jnp.asarray(np.minimum(_band_matrix(h, ones), 1.0))
    mh = jnp.asarray(np.minimum(_band_matrix(w, ones), 1.0))
    return (mv @ x) @ mh.T


def ic_angle_maps(img: jax.Array, radius: int = PATCH_RADIUS
                  ) -> tuple[jax.Array, jax.Array]:
    """Dense intensity-centroid moment maps (m10, m01) over a square window.

    Dense replacement for per-keypoint disc-patch gathers (IC_Angle,
    ORBextractor.cc:77-102): three cumsum-based box filters compute the
    centered first moments for EVERY pixel; per-keypoint work drops to two
    1-element gathers. The square window (vs the reference's disc) changes
    angles slightly — descriptors are self-consistent in-engine, so only
    determinism and stability matter."""
    h, w = img.shape
    xr = jnp.arange(w, dtype=img.dtype)[None, :]
    yr = jnp.arange(h, dtype=img.dtype)[:, None]
    s = _box_filter(img, radius)
    sx = _box_filter(img * xr, radius)
    sy = _box_filter(img * yr, radius)
    return sx - xr * s, sy - yr * s


def ic_angles_dense(img: jax.Array, xy: jax.Array) -> jax.Array:
    """[N,2] keypoints -> [N] angles via the dense moment maps (two gathers
    per keypoint instead of a 31x31 patch gather)."""
    h, w = img.shape
    m10, m01 = ic_angle_maps(img)
    xi = jnp.clip(jnp.round(xy[:, 0]).astype(jnp.int32), 0, w - 1)
    yi = jnp.clip(jnp.round(xy[:, 1]).astype(jnp.int32), 0, h - 1)
    return jnp.arctan2(m01[yi, xi], m10[yi, xi])


def brief_descriptor_one(img_blur: jax.Array, xy: jax.Array,
                         angle: jax.Array) -> jax.Array:
    """256-bit steered BRIEF of one keypoint -> [8] uint32.

    Pool offsets are rotated by the keypoint angle and rounded, matching the
    reference's steered sampling (ORBextractor.cc:103-142 GET_VALUE); bits
    compare pool-sample pairs (one gather per pool sample).
    """
    h, w = img_blur.shape
    pool = jnp.asarray(BRIEF_POOL, jnp.float32)         # [P, 2]
    ca, sa = jnp.cos(angle), jnp.sin(angle)
    rx = jnp.round(ca * pool[:, 0] - sa * pool[:, 1])
    ry = jnp.round(sa * pool[:, 0] + ca * pool[:, 1])
    xi = jnp.clip((xy[0] + rx).astype(jnp.int32), 0, w - 1)
    yi = jnp.clip((xy[1] + ry).astype(jnp.int32), 0, h - 1)
    vals = img_blur[yi, xi]                             # [P]
    pairs = jnp.asarray(BRIEF_PAIRS)
    bits = (vals[pairs[:, 0]] < vals[pairs[:, 1]]).astype(jnp.uint32)
    words = bits.reshape(DESC_WORDS, 32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(words << shifts[None, :], axis=1, dtype=jnp.uint32)


def brief_descriptors(img_blur: jax.Array, xy: jax.Array,
                      angles: jax.Array) -> jax.Array:
    """[N,2] keypoints + [N] angles -> [N, 8] uint32 descriptors."""
    return jax.vmap(lambda p, a: brief_descriptor_one(img_blur, p, a))(xy, angles)


PATCH_R = 19  # covers rotated pool offsets: |p| <= 13*sqrt(2) ~ 18.4

# ---------------------------------------------------------------------------
# Matmul-binned steered BRIEF: the random-gather elimination.
#
# The 375-gather-per-keypoint BRIEF (brief_descriptors) does one random
# device-memory gather per pool offset. This variant replaces them with
# matmul work (whether that pays on the GPU, where gathers are cheaper, is
# an open measurement — ROADMAP.md, Speed item 5):
#   1. ONE contiguous (39, 40) patch per keypoint (block dynamic_slice —
#      byte-bound DMA-like access, not per-element gather),
#   2. rotation quantized to N_ROT_BINS bins (<= 5.6 deg error; the
#      descriptor stays self-consistent in-engine since both frames
#      quantize identically),
#   3. in-patch sampling for ALL bins as one [N, 1560] @ [1560, B*375]
#      one-hot matmul in bf16 (patch values are 8-bit intensities — bf16
#      is exact for the comparisons that follow), then the keypoint's bin
#      selected with a [N, B] one-hot contraction. No gathers anywhere.
# ---------------------------------------------------------------------------
N_ROT_BINS = 32
_SEL_CACHE: dict = {}


def _rotation_selectors() -> np.ndarray:
    """[E=39*40, B*P] bf16 one-hot: for each rotation-bin center, the
    flattened in-patch index of every rotated pool offset."""
    key = id(BRIEF_POOL)
    if key in _SEL_CACHE:
        return _SEL_CACHE[key]
    pool = np.asarray(BRIEF_POOL, np.float32)              # [P, 2]
    p = pool.shape[0]
    b = N_ROT_BINS
    ang = (np.arange(b) + 0.5) * (2 * np.pi / b)
    ca, sa = np.cos(ang), np.sin(ang)
    rx = np.round(ca[:, None] * pool[None, :, 0]
                  - sa[:, None] * pool[None, :, 1]).astype(np.int64)
    ry = np.round(sa[:, None] * pool[None, :, 0]
                  + ca[:, None] * pool[None, :, 1]).astype(np.int64)
    side_y, side_x = 2 * PATCH_R + 1, 2 * PATCH_R + 2
    idx = (ry + PATCH_R) * side_x + (rx + PATCH_R)         # [B, P]
    sel = np.zeros((side_y * side_x, b * p), np.float32)
    cols = (np.arange(b)[:, None] * p + np.arange(p)[None, :]).ravel()
    sel[idx.ravel(), cols] = 1.0
    sel = sel.astype(jnp.bfloat16)
    _SEL_CACHE[key] = sel
    return sel


def brief_patches(img_blur: jax.Array, xy: jax.Array) -> jax.Array:
    """[N,2] keypoints -> [N, E] bf16 flattened (39, 40) patches (block
    dynamic_slice — byte-bound, no per-element gathers)."""
    h, w = img_blur.shape
    r = PATCH_R
    side_y, side_x = 2 * r + 1, 2 * r + 2
    n = xy.shape[0]
    # +edge padding so the widened (lane-friendlier) x-slice never clamps
    imgp = jnp.pad(img_blur, ((0, 1), (0, 8)), mode="edge")
    xi = jnp.clip(jnp.round(xy[:, 0]).astype(jnp.int32), r, w - 1 - r)
    yi = jnp.clip(jnp.round(xy[:, 1]).astype(jnp.int32), r, h - 1 - r)
    patches = jax.vmap(lambda y, x: jax.lax.dynamic_slice(
        imgp, (y - r, x - r), (side_y, side_x)))(yi, xi)
    return patches.reshape(n, side_y * side_x).astype(jnp.bfloat16)


def brief_from_patches(pf: jax.Array, angles: jax.Array) -> jax.Array:
    """[N, E] bf16 patches + [N] angles -> [N, 8] uint32 descriptors.
    Separated from patch extraction so callers can CONCATENATE the patches
    of all pyramid levels first — the [N, 1560] @ [1560, B*375] selector
    matmul runs once at N ~ 1024+ instead of once per level at N ~ 256."""
    n = pf.shape[0]
    pool_n = np.asarray(BRIEF_POOL).shape[0]
    sel = jnp.asarray(_rotation_selectors())               # [E, B*P] bf16
    all_bins = jax.lax.dot_general(
        pf, sel, (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32)                # [N, B*P]
    all_bins = all_bins.reshape(n, N_ROT_BINS, pool_n)
    two_pi = 2.0 * jnp.pi
    bin_idx = jnp.floor((angles % two_pi) / (two_pi / N_ROT_BINS))
    bin_oh = jax.nn.one_hot(bin_idx.astype(jnp.int32), N_ROT_BINS,
                            dtype=jnp.float32)             # [N, B]
    vals = jnp.einsum("nbp,nb->np", all_bins, bin_oh)      # [N, P]

    pairs = jnp.asarray(BRIEF_PAIRS)
    bits = (vals[:, pairs[:, 0]] < vals[:, pairs[:, 1]]).astype(jnp.uint32)
    words = bits.reshape(n, DESC_WORDS, 32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(words << shifts[None, None, :], axis=2, dtype=jnp.uint32)


def brief_descriptors_mxu(img_blur: jax.Array, xy: jax.Array,
                          angles: jax.Array) -> jax.Array:
    """[N,2] keypoints + [N] angles -> [N, 8] uint32 descriptors, gather-free
    (see the design note above)."""
    return brief_from_patches(brief_patches(img_blur, xy), angles)



def brief_descriptors_patch(img_blur: jax.Array, xy: jax.Array,
                            angles: jax.Array) -> jax.Array:
    """Patch-extraction steered BRIEF: [N,2] + [N] -> [N, 8] uint32.

    Numerically the same descriptor family as :func:`brief_descriptors`
    (same pool/pairs, same steering) but the memory access pattern is
    block-shaped: ONE contiguous (2R+1)^2 block per keypoint
    (``dynamic_slice`` under vmap lowers to a coalesced block gather)
    followed by row-local pattern sampling inside the patch, instead of
    ~375 random single-element gathers per keypoint against the full image.
    Centers are rounded before sampling (<=0.5 px shift vs the
    float-center path; descriptors are self-consistent in-engine)."""
    h, w = img_blur.shape
    r = PATCH_R
    n = xy.shape[0]
    side = 2 * r + 1
    xi = jnp.clip(jnp.round(xy[:, 0]).astype(jnp.int32), r, w - 1 - r)
    yi = jnp.clip(jnp.round(xy[:, 1]).astype(jnp.int32), r, h - 1 - r)
    patches = jax.vmap(lambda y, x: jax.lax.dynamic_slice(
        img_blur, (y - r, x - r), (side, side)))(yi, xi)
    pf = patches.reshape(n, side * side)

    pool = jnp.asarray(BRIEF_POOL, jnp.float32)
    ca, sa = jnp.cos(angles), jnp.sin(angles)
    rx = jnp.round(ca[:, None] * pool[None, :, 0]
                   - sa[:, None] * pool[None, :, 1]).astype(jnp.int32)
    ry = jnp.round(sa[:, None] * pool[None, :, 0]
                   + ca[:, None] * pool[None, :, 1]).astype(jnp.int32)
    idx = (ry + r) * side + (rx + r)                     # [N, P] in-patch
    vals = jnp.take_along_axis(pf, idx, axis=1)          # [N, P]
    pairs = jnp.asarray(BRIEF_PAIRS)
    bits = (vals[:, pairs[:, 0]] < vals[:, pairs[:, 1]]).astype(jnp.uint32)
    words = bits.reshape(n, DESC_WORDS, 32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(words << shifts[None, None, :], axis=2, dtype=jnp.uint32)
