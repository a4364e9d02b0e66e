"""Shared BA numerics: block accumulation, Schur reduction, camera solve.

The pieces of one Levenberg-Marquardt iteration, factored out so the
single-chip solver (models/ba.py) and the landmark-sharded distributed
solver (parallel/dist_ba.py) run the SAME numerics — the distributed solver
just ``psum``s the reduced camera system (and the error pieces) over the
mesh between :func:`schur_reduce` and :func:`camera_solve`.

Design notes (why this looks the way it does):
- index-summed accumulations are ONE-HOT MATMUL contractions over
  [Obs, K] / [Obs, P] selectors, not duplicate-index scatter-adds. Whether
  ``jax.ops.segment_sum`` (atomics on the GPU) is faster is an open
  measurement (ROADMAP.md, Speed item 2).
- each selector matrix is read by exactly one matmul: the per-obs value
  columns (H blocks, b, cross blocks) are concatenated first.
- landmark block inverses are closed-form (adjugate 3x3, block-Schur 6x6)
  rather than batched ``jnp.linalg.inv`` (LU per block).

Reference parity: the math mirrors levMarquardtOptimizationLBA
(mapHandler.cpp:1217-1838) — robust weight 1/(1+r^2 sigma^2), analytic
point/line Jacobians, lambda-damped normal equations — with the dense NxN
LDLT replaced by the proper landmark/camera Schur structure.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from gfplslam_tpu.utils import se3


def inv3(m: jax.Array) -> jax.Array:
    """Batched closed-form 3x3 inverse (adjugate / det)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co_a = e * i - f * h
    co_b = f * g - d * i
    co_c = d * h - e * g
    det = a * co_a + b * co_b + c * co_c
    idet = 1.0 / jnp.where(jnp.abs(det) < 1e-18, 1e-18, det)
    adj = jnp.stack([
        jnp.stack([co_a, c * h - b * i, b * f - c * e], -1),
        jnp.stack([co_b, a * i - c * g, c * d - a * f], -1),
        jnp.stack([co_c, b * g - a * h, a * e - b * d], -1),
    ], -2)
    return adj * idet[..., None, None]


def inv6(m: jax.Array) -> jax.Array:
    """Batched 6x6 inverse via 2x2-of-3x3 block Schur with closed-form 3x3
    inverses. Valid for the damped symmetric blocks used here."""
    a = m[..., :3, :3]
    b = m[..., :3, 3:]
    c = m[..., 3:, :3]
    d = m[..., 3:, 3:]
    a_inv = inv3(a)
    s = d - c @ a_inv @ b
    s_inv = inv3(s)
    aib = a_inv @ b
    cai = c @ a_inv
    tl = a_inv + aib @ s_inv @ cai
    tr = -aib @ s_inv
    bl = -s_inv @ cai
    top = jnp.concatenate([tl, tr], axis=-1)
    bot = jnp.concatenate([bl, s_inv], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


class BABlocks(NamedTuple):
    """Undamped normal-equation blocks at one state (one shard's partial
    sums in the distributed solver) + the robust error pieces that come free
    from the residual pass."""
    hcc: jax.Array      # [K, 6, 6] camera diag blocks
    bc: jax.Array       # [K, 6]
    hpp: jax.Array      # [P, 3, 3] point landmark blocks
    bp: jax.Array       # [P, 3]
    hcl_p: jax.Array    # [P, K, 6, 3] camera-point cross blocks
    hll: jax.Array      # [L, 6, 6] line landmark blocks (endpoint 6-dof)
    bl: jax.Array       # [L, 6]
    hcl_l: jax.Array    # [L, K, 6, 6]
    pt_act: jax.Array   # [P] bool — landmark has support
    ln_act: jax.Array   # [L]
    err_sum: jax.Array  # robust error numerator (local partial sum)
    err_cnt: jax.Array  # observation count (local partial sum)


def make_selectors(prob) -> tuple:
    """One-hot selector matrices, built once per problem (loop-invariant)."""
    k = prob.kf_pose.shape[0]
    p = prob.pt_pos.shape[0]
    l = prob.ln_sp.shape[0]
    return (jax.nn.one_hot(prob.po_kf, k, dtype=jnp.float32),
            jax.nn.one_hot(prob.lo_kf, k, dtype=jnp.float32),
            jax.nn.one_hot(prob.po_lm, p, dtype=jnp.float32),
            jax.nn.one_hot(prob.lo_lm, l, dtype=jnp.float32))


# Obs-chunking threshold for the landmark-family one-hot contractions: at
# the single-device global-BA shape (Op=65536, P=16384, K=512) the
# unchunked intermediates ([Op, P] one-hot + [Op, 12+18K] values +
# [Op, K, 6, 3] cross products) peak at ~9 GB; accumulating over obs
# chunks bounds them to ~chunk/Op of that while keeping every matmul
# large. Local windows (Op ~ 1k) stay on the unchunked path.
OBS_CHUNK = 8192


def _lm_family_blocks(oh_lm, oh_kf, w, j_pose, j_lm, r, width):
    """[Obs]-indexed landmark-family accumulation: returns [N_lm, width]
    with columns (H_lm | b_lm | per-KF cross blocks), chunked over the
    observation axis when it is large."""
    d = j_lm.shape[-1]

    def values(oh_kf_c, w_c, jp_c, jl_c, r_c):
        v_h = w_c[:, None, None] * jnp.einsum("nri,nrj->nij", jl_c, jl_c)
        v_b = w_c[:, None] * jnp.einsum("nri,nr->ni", jl_c, r_c)
        v_x = (oh_kf_c[:, :, None, None]
               * (w_c[:, None, None] * jnp.einsum(
                   "nri,nrj->nij", jp_c, jl_c))[:, None])  # [n,K,6,d]
        return jnp.concatenate(
            [v_h.reshape(-1, d * d), v_b, v_x.reshape(v_x.shape[0], -1)],
            axis=1)

    n = w.shape[0]
    if n <= OBS_CHUNK or n % OBS_CHUNK != 0:
        return oh_lm.T @ values(oh_kf, w, j_pose, j_lm, r)

    def body(acc, sl):
        oh_lm_c, oh_kf_c, w_c, jp_c, jl_c, r_c = sl
        return acc + oh_lm_c.T @ values(oh_kf_c, w_c, jp_c, jl_c, r_c), None

    chunked = jax.tree.map(
        lambda x: x.reshape(n // OBS_CHUNK, OBS_CHUNK, *x.shape[1:]),
        (oh_lm, oh_kf, w, j_pose, j_lm, r))
    acc0 = jnp.zeros((oh_lm.shape[1], width))
    acc, _ = jax.lax.scan(body, acc0, chunked)
    return acc


def build_blocks(cam, prob, sel, point_residuals, line_residuals,
                 t_cw, pt_pos, ln_sp, ln_ep) -> BABlocks:
    """Residual pass + block accumulation at one state."""
    oh_pk, oh_lk, oh_pp, oh_ll = sel
    k = prob.kf_pose.shape[0]
    p = pt_pos.shape[0]
    l = ln_sp.shape[0]
    rp, jp_pose, jp_lm, wp = point_residuals(cam, t_cw, prob, pt_pos)
    rl, jl_pose, jl_sp, jl_ep, wl = line_residuals(
        cam, t_cw, prob, ln_sp, ln_ep)
    wp = jnp.where(prob.po_valid, wp, 0.0)
    wl = jnp.where(prob.lo_valid, wl, 0.0)
    err_sum = (jnp.sum(jnp.sum(rp * rp, -1) * wp)
               + jnp.sum(jnp.sum(rl * rl, -1) * wl))
    err_cnt = (jnp.sum(prob.po_valid) + jnp.sum(prob.lo_valid)
               ).astype(jnp.float32)

    # Camera family: [Op+Ol, 42] (Hcc 36 + bc 6) against [Op+Ol, K].
    v_cc_p = wp[:, None, None] * jnp.einsum("nri,nrj->nij", jp_pose, jp_pose)
    v_cc_l = wl[:, None, None] * jnp.einsum("nri,nrj->nij", jl_pose, jl_pose)
    v_bc_p = wp[:, None] * jnp.einsum("nri,nr->ni", jp_pose, rp)
    v_bc_l = wl[:, None] * jnp.einsum("nri,nr->ni", jl_pose, rl)
    v_cam = jnp.concatenate([
        jnp.concatenate([v_cc_p.reshape(-1, 36), v_bc_p], axis=1),
        jnp.concatenate([v_cc_l.reshape(-1, 36), v_bc_l], axis=1),
    ], axis=0)                                              # [Op+Ol, 42]
    oh_k = jnp.concatenate([oh_pk, oh_lk], axis=0)          # [Op+Ol, K]
    cam_blocks = oh_k.T @ v_cam                             # [K, 42]
    hcc = cam_blocks[:, :36].reshape(k, 6, 6)
    bc = cam_blocks[:, 36:]

    # Point-landmark family: [Op, 9 + 3 + K*18] against [Op, P].
    pt_blocks = _lm_family_blocks(oh_pp, oh_pk, wp, jp_pose, jp_lm, rp,
                                  12 + 18 * k)
    hpp = pt_blocks[:, :9].reshape(p, 3, 3)
    bp = pt_blocks[:, 9:12]
    hcl_p = pt_blocks[:, 12:].reshape(p, k, 6, 3)

    # Line-landmark family: [Ol, 36 + 6 + K*36] against [Ol, L].
    jl_lm = jnp.concatenate([jl_sp, jl_ep], axis=-1)   # [Ol,2,6]
    ln_blocks = _lm_family_blocks(oh_ll, oh_lk, wl, jl_pose, jl_lm, rl,
                                  42 + 36 * k)
    hll = ln_blocks[:, :36].reshape(l, 6, 6)
    bl = ln_blocks[:, 36:42]
    hcl_l = ln_blocks[:, 42:].reshape(l, k, 6, 6)

    # activity gate: a landmark whose total weighted information is ~zero
    # (all its observations robust-downweighted to nothing, i.e. outlier
    # associations) must NOT take a step — its gradient/Hessian ratio is
    # unbounded and the saturating robust cost lets LM accept the resulting
    # fly-away (observed: 18 m landmark steps at trace ~1e-3). One healthy
    # observation contributes ~(fx/z)^2 ~ 1e3 to the trace.
    pt_act = prob.pt_valid & (jax.vmap(jnp.trace)(hpp) > 1e-2)
    ln_act = prob.ln_valid & (jax.vmap(jnp.trace)(hll) > 1e-2)
    return BABlocks(hcc=hcc, bc=bc, hpp=hpp, bp=bp, hcl_p=hcl_p,
                    hll=hll, bl=bl, hcl_l=hcl_l,
                    pt_act=pt_act, ln_act=ln_act,
                    err_sum=err_sum, err_cnt=err_cnt)


# Observability gates for landmark update directions (see landmark_inverses).
# REL: an eigendirection below this fraction of the block's largest
# eigenvalue is unobservable at the current window's parallax — for a point
# the depth/lateral curvature ratio is ~(B/z)^2 with B the effective
# parallax baseline, so 1e-3 freezes depth whenever B/z < ~3% (~1.8 deg,
# the classic min-parallax triangulation gate). ABS matches the pt_act
# trace floor (one healthy obs contributes ~(fx/z)^2 ~ 1e3).
EIG_REL_GATE = 1e-3
EIG_ABS_GATE = 1e-2


def _sym3_eigvals(h: jax.Array) -> jax.Array:
    """Closed-form (trigonometric) eigenvalues of batched symmetric 3x3
    matrices, ascending [..., 3]. Smith's method: closed form, where a
    batched ``linalg.eigh`` would run an iterative solver inside the LM
    loop."""
    q = jnp.trace(h, axis1=-2, axis2=-1) / 3.0
    a = h - q[..., None, None] * jnp.eye(3)
    p2 = jnp.sum(a * a, axis=(-2, -1)) / 6.0
    p = jnp.sqrt(jnp.maximum(p2, 1e-30))
    d = (a[..., 0, 0] * (a[..., 1, 1] * a[..., 2, 2]
                         - a[..., 1, 2] * a[..., 2, 1])
         - a[..., 0, 1] * (a[..., 1, 0] * a[..., 2, 2]
                           - a[..., 1, 2] * a[..., 2, 0])
         + a[..., 0, 2] * (a[..., 1, 0] * a[..., 2, 1]
                           - a[..., 1, 1] * a[..., 2, 0]))
    r = jnp.clip(d / (2.0 * p ** 3), -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    e1 = q + 2.0 * p * jnp.cos(phi)                       # largest
    e3 = q + 2.0 * p * jnp.cos(phi + 2.0 * np.pi / 3.0)   # smallest
    e2 = 3.0 * q - e1 - e3
    return jnp.stack([e3, e2, e1], axis=-1)


def _keep_projector3(h: jax.Array) -> jax.Array:
    """[..., 3, 3] projector onto the OBSERVABLE eigenspace of symmetric
    3x3 blocks: eigendirections with eigenvalue > max(EIG_ABS_GATE,
    EIG_REL_GATE * lambda_max). Eigenvectors come from the matrix products
    (H - l2 I)(H - l3 I) (their columns span the l1-eigenspace), so the
    whole analysis is closed-form batched VPU math — no iterative eigh."""
    w = _sym3_eigvals(h)                                   # ascending
    wmax = jnp.maximum(w[..., 2], 0.0)
    gate = jnp.maximum(EIG_ABS_GATE, EIG_REL_GATE * wmax)
    keep = w > gate[..., None]
    n_keep = jnp.sum(keep, axis=-1)
    eye = jnp.eye(3)

    def outer_unit(m):
        # rank-1 projector from the dominant column of m (safe norm)
        norms = jnp.sum(m * m, axis=-2)
        j = jnp.argmax(norms, axis=-1)
        v = jnp.take_along_axis(
            m, j[..., None, None].repeat(3, -2), axis=-1)[..., 0]
        nv = jnp.sqrt(jnp.maximum(jnp.sum(v * v, axis=-1, keepdims=True),
                                  1e-30))
        v = v / nv
        return v[..., :, None] * v[..., None, :]

    l1 = w[..., 0, None, None]
    l2 = w[..., 1, None, None]
    l3 = w[..., 2, None, None]
    # n_keep==2: cut the weakest direction v1 (columns of (H-l2)(H-l3))
    p_cut1 = eye - outer_unit((h - l2 * eye) @ (h - l3 * eye))
    # n_keep==1: keep only the strongest direction v3
    p_keep1 = outer_unit((h - l1 * eye) @ (h - l2 * eye))
    return jnp.where((n_keep == 3)[..., None, None], eye,
                     jnp.where((n_keep == 2)[..., None, None], p_cut1,
                               jnp.where((n_keep == 1)[..., None, None],
                                         p_keep1, 0.0)))


# stiffness added along unobservable directions: the damped inverse then
# steps ~1/_CUT_STIFFNESS there — numerically zero next to observable steps
_CUT_STIFFNESS = 1e8


def landmark_inverses(bk: BABlocks, lam) -> tuple[jax.Array, jax.Array]:
    """Damped landmark block inverses restricted to observable
    eigendirections (zero for empty slots).

    Why not a plain damped inverse: a landmark seen at low parallax has a
    near-null Hessian direction (its depth along the viewing ray); the
    solved step there is gradient-noise divided by ~zero curvature, i.e.
    meters of motion to cancel a pixel of noise. Observed failure mode
    (tests/test_ba_window.py): landmarks with 1-3 window observations slid
    0.7-7 m along their rays while strictly DECREASING their own chi2, so
    neither the global LM accept test nor a per-landmark descent veto can
    reject the step. Adding ~infinite stiffness along sub-gate
    eigendirections (closed-form 3x3 spectral analysis; the 6x6 line
    blocks gate their two endpoint 3x3 diagonal blocks) holds such
    landmarks fixed along their unobservable axes — the fixed-shape analog
    of the reference's min-parallax triangulation gating applied per
    solve."""
    eye3 = jnp.eye(3)
    eye6 = jnp.eye(6)
    proj_p = _keep_projector3(bk.hpp)
    hpp_d = (bk.hpp + lam * jax.vmap(jnp.diag)(
        jnp.maximum(jax.vmap(jnp.diagonal)(bk.hpp), 1e-6))
        + _CUT_STIFFNESS * (eye3 - proj_p))
    # line blocks: per-endpoint observability (block-diagonal projector)
    pa = _keep_projector3(bk.hll[:, :3, :3])
    pb = _keep_projector3(bk.hll[:, 3:, 3:])
    proj_l = (jnp.zeros_like(bk.hll)
              .at[:, :3, :3].set(pa).at[:, 3:, 3:].set(pb))
    hll_d = (bk.hll + lam * jax.vmap(jnp.diag)(
        jnp.maximum(jax.vmap(jnp.diagonal)(bk.hll), 1e-6))
        + _CUT_STIFFNESS * (eye6 - proj_l))
    hpp_inv = inv3(jnp.where(bk.pt_act[:, None, None], hpp_d, eye3[None]))
    hll_inv = inv6(jnp.where(bk.ln_act[:, None, None], hll_d, eye6[None]))
    hpp_inv = jnp.where(bk.pt_act[:, None, None], hpp_inv, 0.0)
    hll_inv = jnp.where(bk.ln_act[:, None, None], hll_inv, 0.0)
    return hpp_inv, hll_inv


def schur_reduce(bk: BABlocks, hpp_inv, hll_inv
                 ) -> tuple[jax.Array, jax.Array]:
    """Local (pre-psum) reduced camera system: S = blockdiag(Hcc) - sum_lm
    Hcl Hll^-1 Hlc and rhs = bc - sum_lm Hcl Hll^-1 bl.

    Two-step contraction with an explicit [6K, P*d] matmul for the landmark
    reduction: a single-einsum 3-operand form lets XLA pick a path that
    materializes [P, 6K, 6K] (memory-bound)."""
    k = bk.hcc.shape[0]
    a_p = jnp.einsum("pkil,plm->pkim", bk.hcl_p, hpp_inv)   # [P,K,6,3]
    a_l = jnp.einsum("pkil,plm->pkim", bk.hcl_l, hll_inv)   # [L,K,6,6]
    flat_ap = a_p.transpose(1, 2, 0, 3).reshape(6 * k, -1)
    flat_hp = bk.hcl_p.transpose(1, 2, 0, 3).reshape(6 * k, -1)
    flat_al = a_l.transpose(1, 2, 0, 3).reshape(6 * k, -1)
    flat_hl = bk.hcl_l.transpose(1, 2, 0, 3).reshape(6 * k, -1)
    s_red = flat_ap @ flat_hp.T + flat_al @ flat_hl.T
    s_local = block_diag_embed(bk.hcc) - s_red
    rhs_local = (bk.bc - jnp.einsum("pkim,pm->ki", a_p, bk.bp)
                 - jnp.einsum("pkim,pm->ki", a_l, bk.bl))
    return s_local, rhs_local


def camera_solve(s_full, rhs, kf_opt, lam) -> jax.Array:
    """Damp + freeze + solve the (psum'd) reduced camera system."""
    k = kf_opt.shape[0]
    diag_mask = jnp.repeat(kf_opt, 6)
    s_full = s_full + lam * jnp.diag(jnp.maximum(jnp.diagonal(s_full), 1e-6))
    s_full = jnp.where(diag_mask[:, None] & diag_mask[None, :], s_full, 0.0)
    s_full = s_full + jnp.diag(jnp.where(diag_mask, 0.0, 1.0))
    rhs_f = jnp.where(diag_mask, rhs.reshape(-1), 0.0)
    dx_cam = jnp.linalg.solve(
        s_full + 1e-10 * jnp.eye(6 * k), rhs_f).reshape(k, 6)
    return jnp.where(kf_opt[:, None], dx_cam, 0.0)


def back_substitute(bk: BABlocks, hpp_inv, hll_inv, dx_cam
                    ) -> tuple[jax.Array, jax.Array]:
    """Landmark updates given the camera step: Hll dxl = bl - Hlc dxc."""
    hlc_dc_p = jnp.einsum("pkil,ki->pl", bk.hcl_p, dx_cam)
    dx_pt = jnp.einsum("plm,pm->pl", hpp_inv, bk.bp - hlc_dc_p)
    hlc_dc_l = jnp.einsum("pkil,ki->pl", bk.hcl_l, dx_cam)
    dx_ln = jnp.einsum("plm,pm->pl", hll_inv, bk.bl - hlc_dc_l)
    return dx_pt, dx_ln


MAX_LM_STEP = 1.0  # metres — per-iteration landmark trust region


def _clip_step(dx: jax.Array, cap: float = MAX_LM_STEP) -> jax.Array:
    """Scale a [N, 3] step down to at most ``cap`` metres per landmark.
    Weakly-observed landmarks can solve to huge steps along their
    near-unobservable (depth) direction; the robust cost saturates for them
    so LM's accept test cannot veto the fly-away. A trust region keeps every
    step physical while leaving well-conditioned updates untouched."""
    n = jnp.linalg.norm(dx, axis=-1, keepdims=True)
    return dx * (cap / jnp.maximum(n, cap))


def retract(bk: BABlocks, t_cw, pt_pos, ln_sp, ln_ep, dx_cam, dx_pt, dx_ln):
    """Apply the step (GN direction is -dx since b = J^T r)."""
    t_cw_new = jax.vmap(lambda t, d: se3.expmap_se3(-d) @ t)(t_cw, dx_cam)
    dx_pt = _clip_step(dx_pt)
    dx_sp = _clip_step(dx_ln[:, :3])
    dx_ep = _clip_step(dx_ln[:, 3:])
    pt_new = pt_pos - jnp.where(bk.pt_act[:, None], dx_pt, 0.0)
    ln_sp_new = ln_sp - jnp.where(bk.ln_act[:, None], dx_sp, 0.0)
    ln_ep_new = ln_ep - jnp.where(bk.ln_act[:, None], dx_ep, 0.0)
    return t_cw_new, pt_new, ln_sp_new, ln_ep_new


def accept_landmarks(sel, prob, chi2_p_old, chi2_p_new, chi2_l_old,
                     chi2_l_new, pt_old, pt_new, sp_old, sp_new,
                     ep_old, ep_new):
    """Per-landmark step acceptance: keep a landmark's candidate position
    only if it does not worsen that landmark's own (unweighted) reprojection
    chi2, evaluated at the CANDIDATE camera poses.

    Why this exists: the robust weight 1/(1+r^2 sigma^2) saturates for a
    landmark whose observations are all far off, so its contribution to the
    GLOBAL robust error is ~constant and LM's global accept test cannot veto
    an individually divergent landmark step (observed: landmarks stepping
    away at the trust-region cap every iteration while total robust error
    decreases — mapHandler.cpp:1217-1838's dense solve has the same robust
    weight but its landmarks never fly because each window there is solved
    once from fresh triangulations, not iterated on a persistent map). The
    unweighted per-landmark chi2 does NOT saturate, so vetoing on it freezes
    any landmark whose step moves it against its own evidence while leaving
    well-conditioned updates untouched.

    ``chi2_*`` are per-observation squared errors [Op]/[Ol] at the candidate
    cameras with old vs new landmark positions; the per-landmark sums are
    one-hot matvecs over the already-built selector matrices."""
    _, _, oh_pp, oh_ll = sel
    cp_old = jnp.where(prob.po_valid, chi2_p_old, 0.0)
    cp_new = jnp.where(prob.po_valid, chi2_p_new, 0.0)
    e_p_old = cp_old @ oh_pp                                # [P]
    e_p_new = cp_new @ oh_pp
    keep_p = e_p_new <= e_p_old
    cl_old = jnp.where(prob.lo_valid, chi2_l_old, 0.0)
    cl_new = jnp.where(prob.lo_valid, chi2_l_new, 0.0)
    e_l_old = cl_old @ oh_ll                                # [L]
    e_l_new = cl_new @ oh_ll
    keep_l = e_l_new <= e_l_old
    pt = jnp.where(keep_p[:, None], pt_new, pt_old)
    sp = jnp.where(keep_l[:, None], sp_new, sp_old)
    ep = jnp.where(keep_l[:, None], ep_new, ep_old)
    return pt, sp, ep


def block_diag_embed(blocks: jax.Array) -> jax.Array:
    """[K,6,6] -> [6K,6K] block diagonal."""
    k = blocks.shape[0]
    out = jnp.zeros((k, 6, k, 6))
    idx = jnp.arange(k)
    out = out.at[idx, :, idx, :].set(blocks)
    return out.reshape(6 * k, 6 * k)
