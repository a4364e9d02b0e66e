"""Distributed bundle adjustment over a device mesh.

The reference has no distributed capability (single-process C++,
SURVEY.md section 2.4); this is its scaling path: keyframe/map-block
partitioned BA across devices and hosts.

Design (SURVEY.md section 7 item 7): landmarks and their observations are
sharded across the mesh axis — each device owns a block of landmarks and all
observations of those landmarks; keyframe poses are replicated. Each device:

1. assembles its landmarks' Hll blocks and their Schur reductions of the
   camera system locally,
2. ``psum``s the reduced [6K, 6K] camera system + rhs over the mesh,
3. solves the (tiny) camera system replicated, and
4. back-substitutes its own landmark updates locally.

The LM loop runs inside ``shard_map`` with replicated control flow (the
psum'd error keeps every device's lambda schedule identical). Collectives
ride the mesh axis — NVLink between the GPUs of one host; under the CPU
test fixture, the 8-device virtual mesh.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from gfplslam_tpu.config import CameraParams
from gfplslam_tpu.models import ba as ba_ref
from gfplslam_tpu.models import ba_core
from gfplslam_tpu.models.ba import BAProblem, BAResult
from gfplslam_tpu.utils import se3


def make_mesh(n_devices: int | None = None, axis: str = "lm") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (axis,))


def shard_problem_by_landmark(prob: BAProblem, n_shards: int,
                              return_perm: bool = False):
    """Reorder + pad the problem so landmark blocks and their observations
    partition evenly into ``n_shards`` contiguous blocks (host-side, once
    per window). Observations of landmark slot i go to shard i % n_shards
    after a stable re-binning of landmark slots.

    With ``return_perm``, also returns (po_perm, lo_perm): for each sharded
    observation slot, the ORIGINAL problem index it came from (-1 = padding)
    — needed to map the sharded solve's outlier marks back onto the
    original problem's observation order."""
    def pad_to(x, n):
        pad = n - x.shape[0]
        return np.pad(np.asarray(x), [(0, pad)] + [(0, 0)] * (x.ndim - 1))

    p = prob.pt_pos.shape[0]
    l = prob.ln_sp.shape[0]
    p_pad = -(-p // n_shards) * n_shards
    l_pad = -(-l // n_shards) * n_shards
    op = prob.po_kf.shape[0]
    ol = prob.lo_kf.shape[0]
    op_pad = -(-op // n_shards) * n_shards
    ol_pad = -(-ol // n_shards) * n_shards

    # landmark slots keep their ids (block partition: slot // (p_pad/n))
    new = prob._replace(
        pt_pos=jnp.asarray(pad_to(prob.pt_pos, p_pad)),
        pt_valid=jnp.asarray(pad_to(prob.pt_valid, p_pad)),
        ln_sp=jnp.asarray(pad_to(prob.ln_sp, l_pad)),
        ln_ep=jnp.asarray(pad_to(prob.ln_ep, l_pad)),
        ln_valid=jnp.asarray(pad_to(prob.ln_valid, l_pad)),
    )

    # re-bin observations so each obs lands in its landmark's shard
    def rebin(kf, lm, payload, sigma2, valid, n_lm_pad, n_obs_pad):
        kf = np.asarray(kf)
        lm = np.asarray(lm)
        valid = np.asarray(valid)
        block = n_lm_pad // n_shards
        shard_of = np.where(valid, lm // block, n_shards)  # invalid -> tail
        # per-shard capacity sized to the LARGEST shard's load (rounded up
        # for shape stability) — a uniform n_obs_pad/n_shards split silently
        # dropped observations whenever landmark popularity was skewed,
        # making the sharded solve diverge from the dense one
        load = np.bincount(shard_of[shard_of < n_shards],
                           minlength=n_shards)
        per = max(-(-int(load.max(initial=1)) // 64) * 64,
                  n_obs_pad // n_shards)
        n_obs_pad = per * n_shards
        order = np.argsort(shard_of * n_obs_pad + np.arange(len(lm)),
                           kind="stable")
        out_idx = np.full(n_obs_pad, -1, np.int64)
        counts = np.zeros(n_shards, np.int64)
        for oi in order:
            s = shard_of[oi]
            if s >= n_shards:
                continue
            out_idx[s * per + counts[s]] = oi
            counts[s] += 1
        ok = out_idx >= 0
        safe = np.where(ok, out_idx, 0)
        return (jnp.asarray(np.where(ok, kf[safe], 0).astype(np.int32)),
                jnp.asarray(np.where(ok, lm[safe], 0).astype(np.int32)),
                jnp.asarray(np.where(ok[:, None], np.asarray(payload)[safe], 0)
                            .astype(np.float32)),
                jnp.asarray(np.where(ok, np.asarray(sigma2)[safe], 1)
                            .astype(np.float32)),
                jnp.asarray(ok & np.where(ok, valid[safe], False)),
                jnp.asarray(np.where(ok, out_idx, -1).astype(np.int32)))

    po = rebin(prob.po_kf, prob.po_lm, prob.po_uv, prob.po_sigma2,
               prob.po_valid, p_pad, op_pad)
    lo = rebin(prob.lo_kf, prob.lo_lm, prob.lo_le, prob.lo_sigma2,
               prob.lo_valid, l_pad, ol_pad)
    sharded = new._replace(po_kf=po[0], po_lm=po[1], po_uv=po[2],
                           po_sigma2=po[3], po_valid=po[4],
                           lo_kf=lo[0], lo_lm=lo[1], lo_le=lo[2],
                           lo_sigma2=lo[3], lo_valid=lo[4])
    if return_perm:
        return sharded, po[5], lo[5]
    return sharded


@partial(jax.jit, static_argnames=("cam", "mesh", "max_iters"))
def solve_ba_sharded(cam: CameraParams, prob: BAProblem, mesh: Mesh,
                     lambda0: float = 1e-3, lambda_k: float = 10.0,
                     max_iters: int = 20, tol: float = 1e-5) -> BAResult:
    """Landmark-sharded LM solve. ``prob`` must be pre-partitioned with
    :func:`shard_problem_by_landmark` for ``mesh`` size."""
    axis = mesh.axis_names[0]
    n = mesh.devices.size
    k = prob.kf_pose.shape[0]

    lm_spec = P(axis)
    rep = P()
    in_specs = BAProblem(
        kf_pose=rep, kf_free=rep, kf_valid=rep,
        pt_pos=lm_spec, pt_valid=lm_spec,
        ln_sp=lm_spec, ln_ep=lm_spec, ln_valid=lm_spec,
        po_kf=lm_spec, po_lm=lm_spec, po_uv=lm_spec, po_sigma2=lm_spec,
        po_valid=lm_spec,
        lo_kf=lm_spec, lo_lm=lm_spec, lo_le=lm_spec, lo_sigma2=lm_spec,
        lo_valid=lm_spec)
    out_specs = BAResult(
        kf_pose=rep, pt_pos=lm_spec, ln_sp=lm_spec, ln_ep=lm_spec,
        err=rep, iters=rep, po_inlier=lm_spec, lo_inlier=lm_spec)

    p_block = prob.pt_pos.shape[0] // n
    l_block = prob.ln_sp.shape[0] // n

    def local(prob_shard: BAProblem) -> BAResult:
        # observation lm ids are global; make them shard-local
        shard = jax.lax.axis_index(axis)
        local_prob = prob_shard._replace(
            po_lm=prob_shard.po_lm - shard * p_block,
            lo_lm=prob_shard.lo_lm - shard * l_block)
        lp = local_prob

        t_cw0 = jax.vmap(se3.inverse_se3)(lp.kf_pose)
        sel = ba_core.make_selectors(lp)
        kf_opt = lp.kf_free & lp.kf_valid

        def build_blocks(t_cw, pt, lsp, lep):
            """Shard-local blocks + GLOBAL robust error (psum'd so every
            device's lambda schedule stays identical)."""
            bk = ba_core.build_blocks(cam, lp, sel,
                                      ba_ref._point_residuals,
                                      ba_ref._line_residuals,
                                      t_cw, pt, lsp, lep)
            err = (jax.lax.psum(bk.err_sum, axis)
                   / jnp.maximum(jax.lax.psum(bk.err_cnt, axis), 1.0))
            return bk, err

        def step(bk, t_cw, pt, lsp, lep, lam):
            hpp_inv, hll_inv = ba_core.landmark_inverses(bk, lam)
            # local Schur reductions, then psum over the mesh — the
            # collective that makes this scale
            s_local, rhs_local = ba_core.schur_reduce(bk, hpp_inv, hll_inv)
            s_full = jax.lax.psum(s_local, axis)
            rhs = jax.lax.psum(rhs_local, axis)
            dx_cam = ba_core.camera_solve(s_full, rhs, kf_opt, lam)
            dx_pt, dx_ln = ba_core.back_substitute(bk, hpp_inv, hll_inv,
                                                   dx_cam)
            t_new, pt_new, sp_new, ep_new = ba_core.retract(
                bk, t_cw, pt, lsp, lep, dx_cam, dx_pt, dx_ln)
            # per-landmark acceptance — shard-local (landmarks and their
            # observations live on the same shard, no collective needed)
            pt_f, sp_f, ep_f = ba_core.accept_landmarks(
                sel, lp,
                ba_ref._point_chi2(cam, t_new, lp, pt),
                ba_ref._point_chi2(cam, t_new, lp, pt_new),
                ba_ref._line_chi2(cam, t_new, lp, lsp, lep),
                ba_ref._line_chi2(cam, t_new, lp, sp_new, ep_new),
                pt, pt_new, lsp, sp_new, lep, ep_new)
            return t_new, pt_f, sp_f, ep_f

        def cond(c):
            return (c[4] < max_iters) & jnp.logical_not(c[5])

        def body(c):
            x, bk, lam, err, it, _ = c
            cand = step(bk, *x, lam)
            bk_cand, new_err = build_blocks(*cand)
            improve = new_err < err
            lam2 = jnp.where(improve, lam / lambda_k, lam * lambda_k)
            x2 = tuple(jnp.where(improve, a, b) for a, b in zip(cand, x))
            bk2 = jax.tree.map(lambda a, b: jnp.where(improve, a, b),
                               bk_cand, bk)
            err2 = jnp.where(improve, new_err, err)
            done = improve & (err - new_err
                              < tol * jnp.maximum(new_err, 1e-12))
            return (x2, bk2, lam2, err2, it + 1, done)

        bk0, err0 = build_blocks(t_cw0, lp.pt_pos, lp.ln_sp, lp.ln_ep)
        x_fin, _, _, err, iters, _ = jax.lax.while_loop(
            cond, body, ((t_cw0, lp.pt_pos, lp.ln_sp, lp.ln_ep), bk0,
                         jnp.asarray(lambda0), err0,
                         jnp.asarray(0, jnp.int32), jnp.asarray(False)))
        t_cw, pt, lsp, lep = x_fin

        rp, _, _, _ = ba_ref._point_residuals(cam, t_cw, lp, pt)
        rl, _, _, _, _ = ba_ref._line_residuals(cam, t_cw, lp, lsp, lep)
        po_in = lp.po_valid & (jnp.sum(rp * rp, -1) * lp.po_sigma2 < 7.815)
        lo_in = lp.lo_valid & (jnp.sum(rl * rl, -1) * lp.lo_sigma2 < 7.815)
        return BAResult(kf_pose=jax.vmap(se3.inverse_se3)(t_cw), pt_pos=pt,
                        ln_sp=lsp, ln_ep=lep, err=err, iters=iters,
                        po_inlier=po_in, lo_inlier=lo_in)

    fn = shard_map(local, mesh=mesh, in_specs=(in_specs,),
                   out_specs=out_specs, check_vma=False)
    return fn(prob)
