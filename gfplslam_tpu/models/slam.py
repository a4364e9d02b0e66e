"""Full SLAM system: tracking front-end + mapping back-end + loop closure.

Role parity with ``plslam_mod``'s main loop + ``MapHandler`` orchestration
(app/plslam_mod.cpp:318-513, mapHandler.cpp:113-187, 2801-2868): per frame,
run VO; on a keyframe decision, insert the KF into the map, run local BA,
cull landmarks, score loop candidates, and on a verified loop run pose-graph
optimization with rigid landmark correction. The loop-closure state machine
(LC_IDLE -> LC_ACTIVE -> LC_READY, mapHandler.h:123-156) is host-side; all
numeric work stays in jitted device programs.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from gfplslam_tpu.config import Config
from gfplslam_tpu.models import ba as ba_ops
from gfplslam_tpu.models import loop as loop_ops
from gfplslam_tpu.models import map as map_ops
from gfplslam_tpu.models import mapping
from gfplslam_tpu.models import vo as vo_mod
from gfplslam_tpu.models.vo import VisualOdometry

LC_IDLE, LC_ACTIVE, LC_READY = 0, 1, 2


@jax.jit
def _pack_lc(cand, accepted, err, t_rel):
    """One [19] float32 array for the LC decision's host reads (single
    device->host transfer: cand, accepted, err, 4x4 t_rel)."""
    return jnp.concatenate([
        jnp.stack([cand.astype(jnp.float32), accepted.astype(jnp.float32),
                   err.astype(jnp.float32)]),
        t_rel.reshape(-1).astype(jnp.float32)])


@dataclass
class SLAMSystem:
    cfg: Config
    run_local_ba: bool = True
    run_loop_closure: bool = True
    # working version of the reference's declared-but-disabled
    # removeRedundantKFs (mapHandler.cpp:2632-2795); opt-in to mirror the
    # reference's shipped default
    cull_redundant_kfs: bool = False
    # asynchronous mapping: the capability the reference declared but never
    # built (addKeyFrame_multiThread/localMappingThread/loopClosureThread,
    # mapHandler.h:86-88). BA + loop-candidate scoring are DISPATCHED at KF
    # k (JAX async dispatch — device work overlaps host tracking of the
    # following frames) and their host-visible decisions (tracker rebase,
    # LC state machine) are harvested at KF k+1, so tracking never blocks
    # on mapping. Loop closures land one KF later than in sync mode.
    # DEFAULT ON (parity with sync covered by
    # tests/test_slam_loop_e2e.py::test_async_mapping_matches_sync);
    # pass async_mapping=False / --sync for the blocking driver.
    async_mapping: bool = True
    vo: VisualOdometry = None
    map: map_ops.MapState = None
    loop_state: loop_ops.LoopState = None
    lc_status: int = LC_IDLE
    # verified constraints accumulated while LC_ACTIVE: [(kf_prev, kf_curr,
    # t_rel), ...] — flushed as pose-graph edges when the revisit ends
    # (lc_idx_list/lc_pose_list, mapHandler.cpp:2820-2834)
    lc_pending: list = field(default_factory=list)
    lc_consecutive: int = 0
    n_loop_closures: int = 0
    n_fused_landmarks: int = 0
    kf_frame_ids: list = field(default_factory=list)
    kf_timestamps: list = field(default_factory=list)
    # observability counters (capped-work events that must not be silent)
    counters: dict = field(default_factory=dict)
    # async-mapping deferred results: (kf_idx, cand_dev, ver_dev) awaiting
    # harvest at the next KF boundary
    _deferred: tuple = None

    def __post_init__(self):
        if self.vo is None:
            self.vo = VisualOdometry(self.cfg)
        if self.map is None:
            self.map = map_ops.empty_map(self.cfg)
        if self.loop_state is None:
            self.loop_state = loop_ops.empty_loop_state(self.cfg)
        # host mirror of map.n_kf so async dispatch never forces the map
        self._n_kf_host = int(self.map.n_kf)

    # ------------------------------------------------------------------
    def process(self, img_l: np.ndarray, img_r: np.ndarray,
                timestamp: float):
        """One stereo frame through the full system."""
        rec = self.vo.process(img_l, img_r, timestamp)
        frame = self.vo.prev_frame  # the frame just processed

        if rec.is_kf and not self.vo.lost:
            kf_idx = self._n_kf_host
            if self.async_mapping:
                # harvest the PREVIOUS KF's mapping results (device work
                # overlapped the tracking of the frames in between)
                self._harvest_deferred()
            if kf_idx == 0:
                self.map = map_ops.initialize_map(self.cfg, self.map, frame)
                self.loop_state = loop_ops.insert_kf_bow(
                    self.cfg, self.loop_state, jnp.asarray(kf_idx), frame)
            else:
                # VO relative motion KF_{k-1} -> KF_k only; the map composes
                # it onto the *optimized* previous KF pose
                # (T_kf_w = T_prev_w * T_rel, mapHandler.cpp:126-128).
                # The whole per-KF mapping pipeline (association + local BA
                # + culling + BoW + LC scoring/verification) is ONE fused
                # device program (models/mapping.py).
                t_rel = self.vo.last_kf_rel
                res = mapping.mapping_step(
                    self.cfg, self.map, self.loop_state, frame,
                    jnp.asarray(t_rel.astype(np.float32)),
                    run_ba=self.run_local_ba,
                    run_lc=self.run_loop_closure,
                    cull_redundant=self.cull_redundant_kfs)
                self.map = res.map
                self.loop_state = res.loop_state
                if self.run_loop_closure:
                    if self.async_mapping:
                        # decisions harvested at the next KF boundary
                        self._deferred = (kf_idx, res.cand, res.verification)
                    else:
                        self._lc_decide(res.cand, res.verification,
                                        kf_idx)
            self.kf_frame_ids.append(self.vo.frame_idx - 1)
            self.kf_timestamps.append(timestamp)
            self._n_kf_host = kf_idx + 1
            if not self.async_mapping:
                # feed the corrected map pose back to the tracker so
                # subsequent frames ride the optimized map
                self.vo.rebase(self.kf_pose_world(kf_idx))
        return rec

    # ------------------------------------------------------------------
    def process_chunk(self, imgs_l: np.ndarray, imgs_r: np.ndarray,
                      timestamps: np.ndarray):
        """Streaming chunk driver: tracking for the whole chunk runs as ONE
        on-device ``lax.scan`` dispatch (models/vo.py run_vo_scan_chunk), the
        chunk's host-visible scalars come back as ONE packed transfer, and
        keyframe mapping slices the scan's stacked per-frame features on
        device. The per-frame driver pays several device<->host round trips
        per frame; chunking amortizes them over N frames at N frames of
        latency — the deployment-shaped throughput mode of the shipped
        system.

        Map corrections (BA/PGO) land between keyframes exactly as in the
        per-frame driver: the map composes each KF onto the OPTIMIZED
        previous KF pose, and the all-frame trajectory re-bases onto map
        poses. Adaptive-FAST feedback stays inside the scan carry.

        Implemented as dispatch (:meth:`_scan_chunk`) + harvest
        (:meth:`_process_scanned`) so :meth:`run_sequence` can pipeline:
        chunk k+1's scan is dispatched BEFORE chunk k's mapping work (the
        mapping never feeds the scan carry — map corrections re-base host
        records only), keeping the device busy while the host decodes
        chunk k's packed scalars and drives its keyframes.
        """
        scanned = self._scan_chunk(imgs_l, imgs_r, timestamps)
        self._process_scanned(scanned)

    def _scan_chunk(self, imgs_l, imgs_r, timestamps):
        """Dispatch one chunk's tracking scan on device with NO host sync.
        Returns the pending state _process_scanned consumes (None if the
        chunk held only the bootstrap frame)."""

        # images stay in their caller-provided dtype and placement: uint8
        # camera bytes cost 4x less host->device transfer than float32 (the
        # cast happens on device in process_stereo_pair), and already-staged
        # device arrays (run_sequence double-buffers chunk k+1 while chunk k
        # computes) pass through without a host round trip
        if not isinstance(imgs_l, jax.Array):
            imgs_l = np.asarray(imgs_l)
        if not isinstance(imgs_r, jax.Array):
            imgs_r = np.asarray(imgs_r)
        timestamps = np.asarray(timestamps, np.float64)
        # Normalize timestamps on the host in float64 BEFORE the float32
        # device cast: at EuRoC epoch scale (~1.4e9 s) float32 resolution is
        # 128 s, so absolute times round consecutive-frame dt to 0 and the
        # motion gate (trans < motion_step_th * dt, pose_opt) rejects all
        # real motion. The scan only ever consumes dt, so a per-sequence
        # base keeps every value microsecond-exact in float32.
        if getattr(self, "_ts_base", None) is None:
            self._ts_base = float(timestamps[0])
        ts_norm = timestamps - self._ts_base
        start = 0
        if getattr(self, "_scan_carry", None) is None:
            carry, frame0 = vo_mod.init_scan_carry(
                self.cfg, jnp.asarray(imgs_l[0]), jnp.asarray(imgs_r[0]),
                float(ts_norm[0]))
            self._scan_carry = carry
            self._abs_prev = np.eye(4)       # absolute VO pose, last frame
            self._abs_prev_kf = np.eye(4)    # absolute VO pose, last KF
            # device-resident mirror of _abs_prev_kf: keyframe mapping
            # computes t_rel on device (mapping_step_chunk), so no per-KF
            # 4x4 upload ever crosses to the device
            self._abs_prev_kf_dev = jnp.eye(4)
            # frame 0 initializes the map (first keyframe)
            self.map = map_ops.initialize_map(self.cfg, self.map, frame0)
            self.loop_state = loop_ops.insert_kf_bow(
                self.cfg, self.loop_state, jnp.asarray(0), frame0)
            self.kf_frame_ids.append(0)
            self.kf_timestamps.append(float(timestamps[0]))
            self._n_kf_host = 1
            self.vo.records.append(vo_mod.FrameRecord(
                float(timestamps[0]), np.eye(4), True, 0, 0, True,
                base_kf=0, t_rel_base=np.eye(4)))
            self.vo.frame_idx += 1
            self.vo.kf_count = 1
            start = 1
        if start >= len(imgs_l):
            return None

        il = imgs_l if start == 0 else imgs_l[start:]
        ir = imgs_r if start == 0 else imgs_r[start:]
        carry, poses, aux, frames = vo_mod.run_vo_scan_chunk(
            self.cfg, self._scan_carry, jnp.asarray(il), jnp.asarray(ir),
            jnp.asarray(ts_norm[start:], jnp.float32))
        self._scan_carry = carry
        packed_dev = vo_mod.pack_chunk_aux(self.cfg, poses, aux)
        return packed_dev, frames, poses, timestamps[start:]

    def _process_scanned(self, scanned) -> None:
        """Harvest one dispatched chunk: read the packed per-frame scalars
        (the chunk's ONE device->host transfer), drive keyframe mapping on
        the device-resident stacked features, and run the LC decisions."""
        if scanned is None:
            return
        # decisions for the PREVIOUS chunk's LC verifications first (their
        # mapping programs retired while this chunk's scan ran)
        self._drain_lc()
        packed_dev, frames, poses, ts_abs = scanned
        packed = np.asarray(packed_dev)

        lc_queue = []   # (kf_idx, cand, verification): decided AFTER all
        # of this chunk's mapping dispatches are queued, so the device runs
        # the mapping chain back-to-back instead of stalling on a host
        # round trip per keyframe (decisions land <= one chunk late — the
        # async-mapping semantics)
        for j in range(packed.shape[0]):
            is_kf = packed[j, 0] > 0.5
            accepted = packed[j, 1] > 0.5
            t_abs = packed[j, 5:21].reshape(4, 4).astype(np.float64)
            # the tracker's own cumulative loss counter (num_frame_loss in
            # the scan carry) persists across chunk boundaries; the packed
            # lost flag is its num_loss > max_num_frame_loss verdict
            if packed[j, 2] > 0.5:
                self.vo.lost = True
            ts_j = float(ts_abs[j])
            if is_kf and not self.vo.lost:
                kf_idx = self._n_kf_host
                res, self._abs_prev_kf_dev = mapping.mapping_step_chunk(
                    self.cfg, self.map, self.loop_state, frames, j, poses,
                    self._abs_prev_kf_dev,
                    run_ba=self.run_local_ba,
                    run_lc=self.run_loop_closure,
                    cull_redundant=self.cull_redundant_kfs)
                self.map = res.map
                self.loop_state = res.loop_state
                if self.run_loop_closure:
                    lc_queue.append((kf_idx, res.cand, res.verification))
                self.kf_frame_ids.append(self.vo.frame_idx)
                self.kf_timestamps.append(ts_j)
                self._n_kf_host = kf_idx + 1
                self.vo.kf_count += 1
                self._abs_prev_kf = t_abs.copy()
                base_kf = kf_idx
                t_rel_base = np.eye(4)
            else:
                base_kf = self._n_kf_host - 1
                t_rel_base = np.linalg.inv(self._abs_prev_kf) @ t_abs
            self.vo.records.append(vo_mod.FrameRecord(
                ts_j, t_abs, bool(is_kf), int(packed[j, 3]),
                int(packed[j, 4]), bool(accepted),
                base_kf=base_kf, t_rel_base=t_rel_base))
            self.vo.frame_idx += 1
            self._abs_prev = t_abs
        if lc_queue:
            # stack the chunk's LC decisions into ONE device array but DEFER
            # the host read to the next chunk boundary: reading now would
            # block the host on this chunk's whole mapping queue, idling the
            # device between chunks. Decisions land one chunk late — the async-mapping
            # semantics the driver already documents.
            rows_dev = jnp.stack([
                _pack_lc(jnp.asarray(c), v.accepted, v.err, v.t_rel)
                for _, c, v in lc_queue])
            self._lc_deferred = ([kf for kf, _, _ in lc_queue], rows_dev)

    def _drain_lc(self) -> None:
        """Read + apply a deferred chunk's LC decisions (one transfer)."""
        d = getattr(self, "_lc_deferred", None)
        if d is None:
            return
        self._lc_deferred = None
        kf_ids, rows_dev = d
        rows = np.asarray(rows_dev)
        for kf_idx, row in zip(kf_ids, rows):
            self._lc_decide_row(row, kf_idx)

    def run_sequence(self, imgs_l, imgs_r, timestamps,
                     chunk: int = 24) -> None:
        """Drive a whole sequence through the streaming chunk driver with
        DOUBLE-BUFFERED image upload: chunk k+1 is staged host->device
        (async ``jax.device_put``) before chunk k's scan is dispatched, so
        the host->device transfer rides under the device compute instead of
        serializing with it. Chunk boundaries are laid out so every scan is
        EXACTLY ``chunk`` frames long (frame 0 is consumed by map init) —
        one compiled scan shape for the whole sequence; only a shorter
        final remainder compiles a second shape."""
        n = len(imgs_l)
        if n == 0:
            return
        bounds = [0, min(chunk + 1, n)]
        while bounds[-1] < n:
            bounds.append(min(bounds[-1] + chunk, n))

        def stage(s, e):
            a, b = imgs_l[s:e], imgs_r[s:e]
            if not isinstance(a, jax.Array):
                a = jax.device_put(np.ascontiguousarray(a))
                b = jax.device_put(np.ascontiguousarray(b))
            return a, b

        nxt = stage(bounds[0], bounds[1])
        pending = None
        for k in range(len(bounds) - 1):
            s, e = bounds[k], bounds[k + 1]
            cur = nxt
            if k + 2 < len(bounds):
                nxt = stage(bounds[k + 1], bounds[k + 2])
            # pipeline: dispatch chunk k's scan BEFORE harvesting chunk
            # k-1's mapping — the scan never consumes map state, so the
            # device stays busy while the host decodes the previous chunk
            scanned = self._scan_chunk(cur[0], cur[1], timestamps[s:e])
            self._process_scanned(pending)
            pending = scanned
        self._process_scanned(pending)

    def _harvest_deferred(self):
        """Apply the previous KF's deferred mapping decisions (async mode):
        LC state machine on the now-complete device results, then tracker
        rebase onto the corrected map pose."""
        if self._deferred is not None:
            kf_idx, cand, ver = self._deferred
            self._deferred = None
            self._lc_decide(cand, ver, kf_idx)
        if self._n_kf_host > 0:
            self.vo.rebase(self.kf_pose_world(self._n_kf_host - 1))

    # ------------------------------------------------------------------
    def kf_pose_world(self, kf_idx: int) -> np.ndarray:
        return np.asarray(self.map.kf_pose[kf_idx])

    def _lc_decide(self, cand, ver, kf_curr: int):
        """The host-side LC state machine on computed candidate/verification
        results (shared by the sync and async paths). ``cand`` may be a
        device scalar — all device reads happen as ONE packed transfer
        (separate int()/bool()/asarray() materializations each cost a full
        device->host round trip)."""
        if ver is not None:
            packed = np.asarray(_pack_lc(jnp.asarray(cand), ver.accepted,
                                         ver.err, ver.t_rel))
            self._lc_decide_row(packed, kf_curr)
            return
        cand = int(cand)
        if self.lc_status == LC_ACTIVE:
            self.lc_status = LC_READY
            self._close_loop()

    def _lc_decide_row(self, packed: np.ndarray, kf_curr: int):
        """LC state machine on an already-transferred [19] _pack_lc row."""
        verified = False
        cand = int(packed[0])
        if cand >= 0 and packed[1] > 0.5:
            verified = True
            self.lc_consecutive += 1
            self.lc_pending.append(
                (cand, kf_curr,
                 packed[3:19].reshape(4, 4).astype(np.float64),
                 float(packed[2])))
            self.lc_status = LC_ACTIVE
        if not verified and self.lc_status == LC_ACTIVE:
            # the car has passed the already-visited street: close now
            # (LC_ACTIVE -> LC_READY -> optimize, mapHandler.cpp:2840-2861)
            self.lc_status = LC_READY
            self._close_loop()

    def _close_loop(self):
        if not self.lc_pending:
            return
        # verification GN error tracks constraint quality (measured: err
        # 1.13 <-> 1.03 m translation error, err 0.25 <-> 0.09 m on the
        # same revisit); constraints much worse than the best verified one
        # are dropped before they enter the pose graph as identity-weighted
        # edges.
        best_err = min(p[3] for p in self.lc_pending)
        keep = [p for p in self.lc_pending
                if p[3] <= max(2.0 * best_err, best_err + 0.1)]
        self.counters["lc_constraints_dropped"] = (
            self.counters.get("lc_constraints_dropped", 0)
            + len(self.lc_pending) - len(keep))
        self.lc_pending = keep
        m = self.map
        # LC edge measurements: T_prev^-1 T_curr = inverse of each verified
        # T_curr<-prev mapped into pose-graph convention. The constraint
        # set is PADDED to a fixed length: every distinct count otherwise
        # traces a fresh pose-graph program at full KF capacity (a
        # multi-second XLA compile per closure event).
        n_lc_max = 8
        # best-verification-error constraints survive the cap (taking the
        # FIRST n_lc_max could drop a later, better constraint)
        pend = sorted(self.lc_pending, key=lambda p: p[3])[:n_lc_max]
        self.counters["lc_constraints_over_cap"] = (
            self.counters.get("lc_constraints_over_cap", 0)
            + max(0, len(self.lc_pending) - n_lc_max))
        n_pad = n_lc_max - len(pend)
        lc_i = jnp.asarray([p[0] for p in pend] + [0] * n_pad, jnp.int32)
        lc_j = jnp.asarray([p[1] for p in pend] + [0] * n_pad, jnp.int32)
        lc_t = jnp.asarray(np.stack(
            [np.linalg.inv(p[2]).astype(np.float32) for p in pend]
            + [np.eye(4, dtype=np.float32)] * n_pad))
        lc_valid = jnp.asarray([True] * len(pend) + [False] * n_pad)
        kf_prev, kf_curr = pend[0][0], pend[0][1]
        # pose-graph size bucket: the dense GN solves a [6K x 6K] system per
        # iteration, so running at the full KF capacity (512 -> 3072^2 solve
        # x 50 iters, seconds per closure) for a 40-KF map wastes ~100x the
        # work. Power-of-two buckets over the OCCUPIED count keep shapes
        # static per bucket (one compile each) and the solve proportionate.
        k_cap = m.kf_pose.shape[0]
        n_kf = int(m.n_kf)
        k_b = 32
        while k_b < min(n_kf, k_cap):
            k_b *= 2
        k_b = min(k_b, k_cap)
        edges = loop_ops.build_edges(
            m.kf_pose[:k_b], m.kf_valid[:k_b], m.full_graph[:k_b, :k_b],
            self.cfg.slam.min_lm_ess_graph,
            lc_i, lc_j, lc_t,
            max_edges=int(k_b * 4),
            lc_valid=lc_valid)
        # The reference seeds each LC current-KF at the constraint-implied
        # pose (loopClosureOptimization*G2O vertex setup,
        # mapHandler.cpp:4005-4025). Hard-fixing EVERY constraint's KF bakes
        # the WORST verification's error into the chain (measured: a
        # 0.15 m-off constraint with GN err 0.84 alongside a 2 mm one with
        # err 0.002); verification error tracks constraint quality, so all
        # currents are seeded but only the BEST-error constraint's KF is
        # fixed — the rest stay soft pose-graph edges.
        kf_pose = m.kf_pose[:k_b]
        fixed = jnp.zeros(k_b, bool).at[0].set(True)
        best_err = min(p[3] for p in pend)
        for (p_i, c_i, t_rel_i, v_err) in pend:
            corrected = np.asarray(kf_pose[p_i]) @ np.linalg.inv(t_rel_i)
            kf_pose = kf_pose.at[c_i].set(
                jnp.asarray(corrected.astype(np.float32)))
            fixed = fixed.at[p_i].set(True)
            if v_err <= best_err:
                fixed = fixed.at[c_i].set(True)
        new_b = loop_ops.optimize_pose_graph(
            kf_pose, m.kf_valid[:k_b], edges, fixed,
            iters=min(self.cfg.slam.max_iters_pgo, 50))
        new_poses = m.kf_pose.at[:k_b].set(new_b)
        pt_pos = loop_ops.rigid_correct_landmarks(
            m.kf_pose[:k_b], new_b, m.pt_pos, m.pt_last_kf, m.pt_valid)
        ln_sp = loop_ops.rigid_correct_landmarks(
            m.kf_pose[:k_b], new_b, m.ln_sp, m.ln_last_kf, m.ln_valid)
        ln_ep = loop_ops.rigid_correct_landmarks(
            m.kf_pose[:k_b], new_b, m.ln_ep, m.ln_last_kf, m.ln_valid)
        self.map = m._replace(kf_pose=new_poses, pt_pos=pt_pos,
                              ln_sp=ln_sp, ln_ep=ln_ep)
        # merge duplicate landmarks across the junction
        # (loopClosureFuseLandmarks, mapHandler.cpp:4425-4714)
        self.map, n_fused, n_over = map_ops.fuse_loop_landmarks(
            self.cfg, self.map, jnp.asarray(kf_prev), jnp.asarray(kf_curr))
        self.n_fused_landmarks += int(n_fused)
        # no silent caps: surface candidates the N_FUSE compaction dropped
        self.counters["fuse_candidates_over_cap"] = (
            self.counters.get("fuse_candidates_over_cap", 0) + int(n_over))
        self.n_loop_closures += 1
        self.lc_pending = []
        self.lc_status = LC_IDLE
        self.lc_consecutive = 0
        # tracker rides the corrected trajectory from here on
        self.vo.rebase(self.kf_pose_world(int(self.map.n_kf) - 1))

    # ------------------------------------------------------------------
    def finish(self, run_global_ba: bool = False):
        """Flush deferred mapping results and any pending loop closure
        (finishSLAM, mapHandler.cpp:96-111); optionally refine everything
        with a global BA pass (globalBundleAdjustment,
        mapHandler.cpp:1844-1948) — solved distributed (landmark-sharded
        Schur over the device mesh, parallel/dist_ba.py) when more than one
        device is available, dense single-chip otherwise."""
        if self.async_mapping:
            self._harvest_deferred()
        self._drain_lc()
        if self.lc_pending:
            self._close_loop()
        self.counters["snapshot_features_over_cap"] = int(
            self.loop_state.n_snapshot_dropped)
        if run_global_ba and int(self.map.n_kf) >= 2:
            import jax
            (prob, win_ids, p_ids, l_ids, po_src,
             lo_src) = map_ops.build_local_ba_problem(
                self.cfg, self.map, global_ba=True)
            n_dev = len(jax.devices())
            if n_dev > 1:
                from gfplslam_tpu.parallel import dist_ba
                mesh = dist_ba.make_mesh(n_dev)
                sharded, po_perm, lo_perm = dist_ba.shard_problem_by_landmark(
                    prob, n_dev, return_perm=True)
                res = dist_ba.solve_ba_sharded(
                    self.cfg.camera, sharded, mesh,
                    lambda0=self.cfg.slam.lambda_lba_lm,
                    lambda_k=self.cfg.slam.lambda_lba_k,
                    max_iters=self.cfg.slam.max_iters_lba)
                # map the sharded solve's outlier marks back onto the
                # original problem's observation order (rebin permutation)
                po_in = jnp.ones(prob.po_kf.shape[0], bool).at[
                    jnp.where(po_perm >= 0, po_perm,
                              prob.po_kf.shape[0])].set(
                    res.po_inlier, mode="drop")
                lo_in = jnp.ones(prob.lo_kf.shape[0], bool).at[
                    jnp.where(lo_perm >= 0, lo_perm,
                              prob.lo_kf.shape[0])].set(
                    res.lo_inlier, mode="drop")
                # crop the shard padding back to the problem's pool sizes
                res = res._replace(
                    pt_pos=res.pt_pos[:p_ids.shape[0]],
                    ln_sp=res.ln_sp[:l_ids.shape[0]],
                    ln_ep=res.ln_ep[:l_ids.shape[0]],
                    po_inlier=po_in, lo_inlier=lo_in)
            else:
                res = ba_ops.solve_ba(self.cfg.camera, prob,
                                      lambda0=self.cfg.slam.lambda_lba_lm,
                                      lambda_k=self.cfg.slam.lambda_lba_k,
                                      max_iters=self.cfg.slam.max_iters_lba)
            self.map = map_ops.apply_ba_result(self.cfg, self.map, res,
                                               win_ids, p_ids, l_ids)
            # post-BA outlier-observation deletion (mapHandler.cpp:1714-1836)
            self.map = map_ops.apply_ba_outliers(self.cfg, self.map, res,
                                                 po_src, lo_src)

    def save(self, path: str) -> None:
        """Checkpoint the full map + loop + tracker state (capability the
        reference lacks — SURVEY.md section 5 'Checkpoint/resume: None')."""
        from gfplslam_tpu.utils import checkpoint
        checkpoint.save_state(path, map=self.map, loop=self.loop_state,
                              tracker=self.vo.state)

    def load(self, path: str) -> None:
        from gfplslam_tpu.utils import checkpoint
        from gfplslam_tpu.models import tracker as trk
        out = checkpoint.load_state(
            path, map=map_ops.empty_map(self.cfg),
            loop=loop_ops.empty_loop_state(self.cfg),
            tracker=trk.initial_state(self.cfg))
        self.map = out["map"]
        self.loop_state = out["loop"]
        self.vo.state = out["tracker"]
        self._n_kf_host = int(self.map.n_kf)

    @property
    def keyframe_trajectory(self) -> np.ndarray:
        """Optimized map KF poses — the reference writes its KF trajectory
        from these after BA/PGO (plslam_mod.cpp:538-566)."""
        n = int(self.map.n_kf)
        return np.asarray(self.map.kf_pose[:n])

    @property
    def all_frame_trajectory(self) -> np.ndarray:
        """Every frame re-based onto its base KF's *optimized* pose:
        T_frame = T_kf(map) @ T_rel(vo). Frames between KFs inherit the
        map correction of their base keyframe."""
        kf_pose = np.asarray(self.map.kf_pose)
        n_kf = int(self.map.n_kf)
        out = []
        for r in self.vo.records:
            k = min(r.base_kf, n_kf - 1) if n_kf > 0 else 0
            if r.t_rel_base is None or n_kf == 0:
                out.append(r.t_cam_w)
            else:
                out.append(kf_pose[k] @ r.t_rel_base)
        return np.stack(out)
