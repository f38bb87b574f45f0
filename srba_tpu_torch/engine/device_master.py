"""DeviceMaster — persistent device-resident copies of the pose/landmark
unknowns, with staged appends and zero-download per-keyframe stepping.
Port of :mod:`srba_tpu.engine.device_master`.

This class owns:

* the padded master tensors on ``device`` (power-of-two capacity, grown on
  the device),
* the staging queues of new edge/landmark rows created since the last step,
* the lazily synchronized host mirror (``sync_to_host``), refreshed either
  by one blocking download or by consuming an earlier asynchronous prefetch
  (a pinned host buffer filled by a non-blocking copy, plus a CUDA event),
  under the JAX package's sequence-based staleness rules.
"""

from __future__ import annotations

import time
from typing import List, Tuple

import numpy as np
import torch

from srba_tpu_torch.models.observations import calib_constants
from srba_tpu_torch.solver.master import (INFO_KEYS, grow_master,
                                          make_append_only, make_master_step,
                                          pack_window_ints)
from srba_tpu_torch.utils.device import resolve_device


def _bucket_pow2(n: int, minimum: int) -> int:
    cap = minimum
    while cap < n:
        cap *= 2
    return cap


class LazyInfo(dict):
    """``TOptimizeExtraOutputInfo``-style dict whose values stay on the
    device until first read: the step packs them into one small tensor, and
    the first read costs one ``.cpu()`` of it (a device sync), so the
    steady-state per-keyframe loop never pays it."""

    def __init__(self, dev_info):
        super().__init__()
        # One [len(INFO_KEYS)] f32 tensor (iters and num_obs are exact small
        # integers in f32).
        self._dev = torch.stack(
            [dev_info[k].to(torch.float32) for k in INFO_KEYS])

    def _fetch(self):
        if self._dev is not None:
            vals = self._dev.cpu().tolist()
            for k, v in zip(INFO_KEYS, vals):
                super().__setitem__(k, float(v))
            self._dev = None

    def __getitem__(self, k):
        self._fetch()
        return super().__getitem__(k)

    def get(self, k, default=None):
        self._fetch()
        return super().get(k, default)

    def __contains__(self, k):
        return k in INFO_KEYS if self._dev is not None \
            else super().__contains__(k)

    def keys(self):
        return iter(INFO_KEYS) if self._dev is not None else super().keys()

    def items(self):
        self._fetch()
        return super().items()

    def values(self):
        self._fetch()
        return super().values()

    def __iter__(self):
        return self.keys()

    def __len__(self):
        return len(INFO_KEYS) if self._dev is not None else super().__len__()

    def __repr__(self):
        self._fetch()  # repr is a debug path; users want numbers
        return dict.__repr__(self)


class DeviceMaster:
    """Device-authoritative master tensors + staging + step frontend."""

    INIT_EDGE_CAP = 16384
    INIT_LM_CAP = 65536
    PAD_E_MIN = 8
    PAD_L_MIN = 64

    def __init__(self, pose_dim: int, lm_dim: int, device="cuda"):
        self.device = resolve_device(device)
        self.pose_dim = pose_dim
        self.lm_dim = lm_dim
        self.pose = torch.zeros((self.INIT_EDGE_CAP, pose_dim),
                                dtype=torch.float32, device=self.device)
        # Edge measurement priors: [prior pose || weight] per edge row,
        # appended in lockstep with ``pose`` (write-once; never scattered).
        self.prior = torch.zeros((self.INIT_EDGE_CAP, pose_dim + 1),
                                 dtype=torch.float32, device=self.device)
        self.lm = torch.zeros((self.INIT_LM_CAP, lm_dim),
                              dtype=torch.float32, device=self.device)
        self.num_edges = 0          # rows materialized on device
        self.num_lms = 0
        self._pend_edges: List[np.ndarray] = []
        self._pend_priors: List[np.ndarray] = []
        self._pend_lms: List[np.ndarray] = []
        self._append_fn = make_append_only(pose_dim, lm_dim)
        # Mirror freshness is tracked by SEQUENCE: step_seq counts
        # device-state mutations; mirror_seq is the step the host mirror
        # reflects (see the JAX package for the staleness rules).
        self.step_seq = 0
        self.mirror_seq = 0
        # (host buffer, live buckets, n_e, n_l, seq, CUDA event or None)
        self._prefetch = None
        self.sync_stats = {"pf_hit": 0, "pf_hit_s": 0.0,
                           "miss": 0, "miss_s": 0.0}
        # Device-resident per-engine operands (uploaded once on first step).
        self._whitener_dev = None
        self._spinv_dev = None
        self._calib_dev = None

    # -- staging -------------------------------------------------------------

    def stage_edge(self, pose_row: np.ndarray, prior_w: float = 0.0) -> None:
        row = np.asarray(pose_row, np.float32)
        self._pend_edges.append(row)
        self._pend_priors.append(
            np.concatenate([row, [np.float32(prior_w)]]))

    def stage_landmark(self, lm_row: np.ndarray) -> None:
        self._pend_lms.append(np.asarray(lm_row, np.float32))

    def _take_staging(self) -> Tuple[np.ndarray, np.ndarray, int, int]:
        """Pack pending rows into one padded f32 buffer + offsets; advance
        the device row counts.  Pad rows are zeros — they land in
        not-yet-allocated slots and get overwritten by the next append
        before any gather can reach them."""
        n_e, n_l = len(self._pend_edges), len(self._pend_lms)
        pad_e = _bucket_pow2(max(n_e, 1), self.PAD_E_MIN)
        pad_l = _bucket_pow2(max(n_l, 1), self.PAD_L_MIN)
        pd1 = self.pose_dim + 1
        rows = np.zeros(pad_e * (self.pose_dim + pd1) + pad_l * self.lm_dim,
                        np.float32)
        if n_e:
            rows[: n_e * self.pose_dim] = np.concatenate(
                [r.ravel() for r in self._pend_edges])
            base = pad_e * self.pose_dim
            rows[base: base + n_e * pd1] = np.concatenate(
                [r.ravel() for r in self._pend_priors])
        if n_l:
            base = pad_e * (self.pose_dim + pd1)
            rows[base: base + n_l * self.lm_dim] = np.concatenate(
                [r.ravel() for r in self._pend_lms])
        offsets = np.asarray([self.num_edges, self.num_lms], np.int32)
        self._ensure_capacity(self.num_edges + pad_e, self.num_lms + pad_l)
        self.num_edges += n_e
        self.num_lms += n_l
        self._pend_edges.clear()
        self._pend_priors.clear()
        self._pend_lms.clear()
        return rows, offsets, pad_e, pad_l

    def _ensure_capacity(self, n_edges: int, n_lms: int) -> None:
        ecap = self.pose.shape[0]
        if n_edges > ecap:
            while ecap < n_edges:
                ecap *= 4
            self.pose = grow_master(self.pose, ecap)
            self.prior = grow_master(self.prior, ecap)
        lcap = self.lm.shape[0]
        if n_lms > lcap:
            while lcap < n_lms:
                lcap *= 4
            self.lm = grow_master(self.lm, lcap)

    # -- dispatch ------------------------------------------------------------

    def flush_append(self) -> None:
        """Append staged rows without optimizing (first KF / opt disabled)."""
        if not self._pend_edges and not self._pend_lms:
            return
        rows, offsets, pad_e, pad_l = self._take_staging()
        self.pose, self.prior, self.lm = self._append_fn(
            self.pose, self.prior, self.lm, rows, offsets, pad_e, pad_l)

    def step(self, cfg, whitener, sensor_pose_inv, calib,
             edge_ids, edge_opt, lm_ids, lm_opt, obs_lm, obs_valid,
             path_edge, path_sign, obs_z, iters_cap: int = 0) -> LazyInfo:
        """Append staged rows + solve one window, with ONE host->device
        upload.  ``iters_cap`` (0 = config max) is the LM iteration cap."""
        rows, offsets, pad_e, pad_l = self._take_staging()
        ints = pack_window_ints(edge_ids, edge_opt, lm_ids, lm_opt,
                                obs_lm, obs_valid, path_edge, path_sign)
        obs_z = np.asarray(obs_z, np.float32)
        cap = np.asarray([iters_cap if iters_cap > 0 else cfg.max_iters],
                         np.int32)
        wire = np.concatenate([
            rows, obs_z.ravel(),
            np.concatenate([offsets, cap, ints]).view(np.float32)])
        if self._whitener_dev is None:
            self._whitener_dev = torch.as_tensor(
                np.asarray(whitener, np.float32), device=self.device)
            self._spinv_dev = torch.as_tensor(
                np.asarray(sensor_pose_inv, np.float32), device=self.device)
            # Python floats: kernel arguments, no per-step upload.
            self._calib_dev = calib_constants(calib)
        fn = make_master_step(cfg)  # global per-config cache
        E, L, N = len(edge_ids), len(lm_ids), len(obs_lm)
        self.pose, self.prior, self.lm, info = fn(
            self.pose, self.prior, self.lm, wire,
            self._whitener_dev, self._spinv_dev, self._calib_dev,
            E, L, N, pad_e, pad_l, obs_z.shape[1])
        self.step_seq += 1
        return LazyInfo(info)

    def fence(self) -> None:
        """Wait for all queued device work WITHOUT downloading anything."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- host mirror ---------------------------------------------------------

    @property
    def dirty(self) -> bool:
        """Device ahead of the host mirror (seq-derived; settable:
        ``True`` bumps the step sequence, ``False`` marks the mirror
        current)."""
        return self.mirror_seq < self.step_seq

    @dirty.setter
    def dirty(self, value: bool) -> None:
        if value:
            self.step_seq += 1
        else:
            self.mirror_seq = self.step_seq

    def _live_buckets(self):
        b_e = min(_bucket_pow2(max(self.num_edges, 1), self.PAD_E_MIN),
                  self.pose.shape[0])
        b_l = min(_bucket_pow2(max(self.num_lms, 1), self.PAD_L_MIN),
                  self.lm.shape[0])
        return b_e, b_l

    def _copy_to_host_async(self, src: torch.Tensor):
        """Start a device->host copy of ``src``; returns the host tensor and
        an event that completes when the copy has landed (None on CPU)."""
        if self.device.type != "cuda":
            return src, None
        dst = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        dst.copy_(src, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return dst, ev

    def maybe_prefetch(self, max_age: int, force: bool = False) -> None:
        """Start (if useful) an ASYNC device->host copy of the live master
        slices so a later staleness-tolerant ``sync_to_host(max_age=...)``
        consumes it without blocking.  Cadence and ``force`` as in the JAX
        package: a new copy once the in-flight one has burned half of the
        ``max_age`` budget; ``force`` copies the current step regardless."""
        if self.mirror_seq >= self.step_seq:
            return
        pf_seq = self._prefetch[4] if self._prefetch is not None \
            else self.mirror_seq
        if force:
            if pf_seq >= self.step_seq:
                return
        elif self.step_seq - pf_seq < max(1, max_age // 2):
            return
        b_e, b_l = self._live_buckets()
        packed = torch.cat([self.pose[:b_e].reshape(-1),
                            self.lm[:b_l].reshape(-1)])
        host, ev = self._copy_to_host_async(packed)
        self._prefetch = (host, (b_e, b_l), self.num_edges, self.num_lms,
                          self.step_seq, ev)

    def _unpack_live(self, host: torch.Tensor, buckets):
        b_e, b_l = buckets
        flat = host.numpy()
        n_pose = b_e * self.pose_dim
        return (flat[:n_pose].reshape(b_e, self.pose_dim),
                flat[n_pose:].reshape(b_l, self.lm_dim))

    def sync_to_host(self, k2k_pose: np.ndarray, lm_state: np.ndarray,
                     max_age: int = 0, min_seq: int = 0) -> None:
        """Refresh the host mirror in place with ONE download of a
        power-of-two bucket of the LIVE rows (or by consuming a pending
        :meth:`maybe_prefetch` copy that satisfies the staleness bounds:
        ``max_age`` steps behind the device at most, and not older than
        ``min_seq``)."""
        target = max(self.step_seq - max_age, min_seq)
        if self.mirror_seq >= target:
            return
        pf = self._prefetch
        if pf is not None:
            host, buckets, n_e, n_l, seq, ev = pf
            if seq > self.mirror_seq and seq >= target:
                t0 = time.perf_counter()
                if ev is not None:
                    ev.synchronize()   # blocks only for the copy's remainder
                pose, lm = self._unpack_live(host, buckets)
                k2k_pose[:n_e] = pose[:n_e]
                lm_state[:n_l] = lm[:n_l]
                self.sync_stats["pf_hit"] += 1
                self.sync_stats["pf_hit_s"] += time.perf_counter() - t0
                self.mirror_seq = seq
                self._prefetch = None
                return
        t0 = time.perf_counter()
        n_e, n_l = self.num_edges, self.num_lms
        buckets = self._live_buckets()
        host = torch.cat([self.pose[: buckets[0]].reshape(-1),
                          self.lm[: buckets[1]].reshape(-1)]).cpu()
        pose, lm = self._unpack_live(host, buckets)
        k2k_pose[:n_e] = pose[:n_e]
        lm_state[:n_l] = lm[:n_l]
        self.sync_stats["miss"] += 1
        self.sync_stats["miss_s"] += time.perf_counter() - t0
        self.mirror_seq = self.step_seq
        self._prefetch = None

    def upload_from_host(self, k2k_pose: np.ndarray, lm_state: np.ndarray,
                         num_edges: int, num_lms: int,
                         k2k_prior: np.ndarray = None,
                         k2k_prior_w: np.ndarray = None) -> None:
        """Replace the device masters wholesale (the global PGO's
        write-back).  Priors default to the uploaded poses with weight 0 (no
        factors).  Staging is cleared, a pending prefetch (its pinned buffer
        and event) is dropped since it holds pre-upload state, and the host
        mirror is marked current."""
        self._pend_edges.clear()
        self._pend_priors.clear()
        self._pend_lms.clear()
        self.num_edges = num_edges
        self.num_lms = num_lms
        ecap = max(self.INIT_EDGE_CAP,
                   _bucket_pow2(num_edges + self.PAD_E_MIN, self.INIT_EDGE_CAP))
        lcap = max(self.INIT_LM_CAP,
                   _bucket_pow2(num_lms + self.PAD_L_MIN, self.INIT_LM_CAP))
        pose = np.zeros((ecap, self.pose_dim), np.float32)
        pose[:num_edges] = k2k_pose[:num_edges]
        prior = np.zeros((ecap, self.pose_dim + 1), np.float32)
        prior[:num_edges, : self.pose_dim] = (
            k2k_prior[:num_edges] if k2k_prior is not None
            else k2k_pose[:num_edges])
        if k2k_prior_w is not None:
            prior[:num_edges, self.pose_dim] = k2k_prior_w[:num_edges]
        lm = np.zeros((lcap, self.lm_dim), np.float32)
        lm[:num_lms] = lm_state[:num_lms]
        self.pose = torch.as_tensor(pose, device=self.device)
        self.prior = torch.as_tensor(prior, device=self.device)
        self.lm = torch.as_tensor(lm, device=self.device)
        self._prefetch = None
        self.dirty = False
