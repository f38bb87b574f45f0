"""Multi-process execution — the port of :mod:`srba_tpu.parallel.multihost`
on ``torch.distributed``: the process group, the coordinator's
per-keyframe broadcast and the engine front end that replays it.

The design is the JAX package's (see its module docstring): every process
runs one rank, every rank holds an identical replica of the host graph,
SLAM input arrives at the coordinator (rank 0), which encodes each keyframe
into a fixed-shape record and broadcasts it; every rank replays it into its
replica, so all ranks take bit-identical topology decisions, and the
numeric work is sharded over the global mesh (the observation-sharded
window solve of :mod:`srba_tpu_torch.parallel.sharding`, the
window-sharded sweep of :mod:`srba_tpu_torch.solver.multi_window`, the
edge-sharded PGO of :mod:`srba_tpu_torch.solver.global_graphslam`).

Backends: NCCL for one rank per card, gloo otherwise (the CPU, or several
ranks sharing a card, which NCCL refuses).  Every process group gets a
``timeout``, so a rank that diverges from the others fails within it
instead of hanging.  Replicated control flow reads only values every rank
computed from the same all-reduced inputs.
"""

from __future__ import annotations

import datetime
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from srba_tpu_torch.utils.device import resolve_device

OBS_AXIS = "obs"

# The device type this process's rank computes on, set by initialize(): the
# process group itself is process-wide state, and so is this.
_rank_device_type: Optional[str] = None


# ---------------------------------------------------------------------------
# Runtime wiring
# ---------------------------------------------------------------------------

def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None, device="cuda",
               timeout: float = 120.0) -> None:
    """Join the process group as rank ``process_id`` of ``num_processes``.

    ``coordinator_address`` is the rendezvous: ``"host:port"`` (rank 0
    listens there; ``tcp://`` is prepended) or any ``init_method`` URL,
    such as ``"file:///path/store"``.  ``device`` is what the rank computes
    on: ``"cuda"`` takes card ``process_id % device_count`` (and raises
    where there is none), ``"cpu"`` the CPU.  ``backend=None`` picks NCCL
    when the device is CUDA and there is a card per rank, gloo otherwise.
    ``timeout`` (seconds) bounds every collective.

    With ``num_processes <= 1`` (or None) and no coordinator, the process
    forms a world of one rank on an in-process store (no socket is opened),
    in which :func:`global_mesh` works; so call this unconditionally, as
    with the JAX package's ``initialize``.  A call in a process that
    already has a process group changes nothing."""
    global _rank_device_type
    single = coordinator_address is None and (num_processes or 1) <= 1
    if not single and (coordinator_address is None or num_processes is None
                       or process_id is None):
        raise ValueError("a multi-process world needs coordinator_address, "
                         "num_processes and process_id")
    if dist.is_initialized():
        return
    world = 1 if single else int(num_processes)
    rank = 0 if single else int(process_id)
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    if backend is None:
        backend = ("nccl" if dev.type == "cuda"
                   and torch.cuda.device_count() >= world else "gloo")
    kwargs = {"timeout": datetime.timedelta(seconds=timeout)}
    if single:
        kwargs["store"] = dist.HashStore()
    else:
        kwargs["init_method"] = (coordinator_address
                                 if "://" in coordinator_address
                                 else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, rank=rank, world_size=world, **kwargs)
    _rank_device_type = dev.type


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_coordinator() -> bool:
    return process_index() == 0


def rank_device(device_type: Optional[str] = None) -> torch.device:
    """The device this rank computes on (``device_type`` defaults to the
    one :func:`initialize` was given)."""
    return resolve_device(device_type or _rank_device_type or "cuda")


def global_mesh(axis_name: str = OBS_AXIS, n_devices: Optional[int] = None,
                device=None):
    """1-D ``DeviceMesh`` named ``axis_name`` over every rank of the world
    (the multi-process analog of :func:`srba_tpu_torch.parallel.sharding.
    make_mesh`).  Without a process group it first joins a world of one
    rank on ``device`` (default ``"cuda"``).  ``n_devices`` and ``device``,
    when given, must match the world: its size and its ranks' device
    type."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        initialize(device=device if device is not None else "cuda")
    world = dist.get_world_size()
    if n_devices is not None and int(n_devices) != world:
        raise ValueError(f"a mesh of {n_devices} devices in a world of "
                         f"{world} ranks: a mesh spans the whole world")
    dev_type = rank_device().type
    if device is not None and torch.device(device).type != dev_type:
        raise ValueError(f"device {str(device)!r}, but this rank computes "
                         f"on {dev_type}")
    return init_device_mesh(dev_type, (world,), mesh_dim_names=(axis_name,))


def _transport_device() -> torch.device:
    """Where a host record travels: NCCL moves only CUDA tensors, gloo
    host memory."""
    if dist.get_backend() == "nccl":
        return rank_device("cuda")
    return torch.device("cpu")


def broadcast_from_coordinator(tree: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Broadcast a flat dict of fixed-shape host arrays (int32 and float32
    leaves, numpy arrays or scalars) from rank 0 to every rank.  Every rank
    passes a dict of the same keys, shapes and dtypes (the values of the
    others are ignored).  The int32 leaves travel packed in one tensor and
    the float32 leaves in another: two broadcasts per call."""
    leaves = {k: np.asarray(v) for k, v in tree.items()}
    for k, v in leaves.items():
        if v.dtype not in (np.int32, np.float32):
            raise ValueError(f"leaf {k!r} is {v.dtype}; the wire carries "
                             "int32 and float32")
    dev = _transport_device()
    out = {}
    for dtype in (np.int32, np.float32):
        keys = [k for k, v in leaves.items() if v.dtype == dtype]
        if not keys:
            continue
        flat = torch.as_tensor(np.concatenate(
            [leaves[k].reshape(-1) for k in keys])).to(dev)
        dist.broadcast(flat, src=0)
        flat = flat.cpu().numpy()
        off = 0
        for k in keys:
            n = leaves[k].size
            out[k] = flat[off: off + n].reshape(leaves[k].shape)
            off += n
    return {k: out[k] for k in tree}


def sync_processes(name: str = "srba") -> None:
    """Barrier across all processes (around timed sections and before
    teardown, so no process exits while peers still expect collectives).
    ``name`` labels the call site, as in the JAX package."""
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[rank_device("cuda").index])
    else:
        dist.barrier()


# ---------------------------------------------------------------------------
# Per-keyframe wire format
# ---------------------------------------------------------------------------

class KeyframeCodec:
    """Fixed-shape encode/decode of one ``define_new_keyframe`` input for
    :func:`broadcast_from_coordinator` (which needs the same shapes on every
    rank — hence padded records, not pickles)."""

    def __init__(self, z_dim: int, lm_dim: int, pose_dim: int,
                 max_obs: int = 256, max_init_edges: int = 8):
        self.z_dim, self.lm_dim, self.pose_dim = z_dim, lm_dim, pose_dim
        self.max_obs, self.max_init_edges = max_obs, max_init_edges

    def zeros(self) -> Dict[str, np.ndarray]:
        M, E = self.max_obs, self.max_init_edges
        return {
            "n_obs": np.int32(0),
            "lm_ids": np.zeros(M, np.int32),
            "z": np.zeros((M, self.z_dim), np.float32),
            "has_fixed": np.zeros(M, np.int32),
            "has_init": np.zeros(M, np.int32),
            "rel": np.zeros((M, self.lm_dim), np.float32),
            "n_edges": np.int32(0),
            "e_targets": np.zeros(E, np.int32),
            "e_poses": np.zeros((E, self.pose_dim), np.float32),
            "run_opt": np.int32(1),
            "stop": np.int32(0),
            # Padding slot of a batched broadcast (MultiHostEngine.
            # broadcast_batch): replay ignores the record.
            "skip": np.int32(0),
        }

    def encode(self, observations, edge_init, run_opt: bool,
               stop: bool = False) -> Dict[str, np.ndarray]:
        msg = self.zeros()
        if stop:
            msg["stop"] = np.int32(1)
            return msg
        n = len(observations)
        if n > self.max_obs:
            raise ValueError(
                f"{n} observations exceed the wire cap max_obs="
                f"{self.max_obs}; raise MultiHostEngine(max_obs_per_kf=...)")
        msg["n_obs"] = np.int32(n)
        for i, o in enumerate(observations):
            msg["lm_ids"][i] = int(o.lm_id)
            msg["z"][i] = np.asarray(o.z, np.float32)
            if o.fixed_rel_pos is not None:
                msg["has_fixed"][i] = 1
                msg["rel"][i] = np.asarray(o.fixed_rel_pos, np.float32)
            elif o.init_rel_pos is not None:
                msg["has_init"][i] = 1
                msg["rel"][i] = np.asarray(o.init_rel_pos, np.float32)
        if edge_init:
            items = list(edge_init.items())
            if len(items) > self.max_init_edges:
                raise ValueError(
                    f"{len(items)} edge inits exceed the wire cap "
                    f"max_init_edges={self.max_init_edges}")
            msg["n_edges"] = np.int32(len(items))
            for i, (t, p) in enumerate(items):
                msg["e_targets"][i] = int(t)
                msg["e_poses"][i] = np.asarray(p, np.float32)
        msg["run_opt"] = np.int32(1 if run_opt else 0)
        return msg

    def decode(self, msg):
        """-> (observations, edge_init, run_opt, stop), the observations as
        the port's :class:`~srba_tpu_torch.engine.engine.Observation`."""
        from srba_tpu_torch.engine.engine import Observation
        msg = {k: np.asarray(v) for k, v in msg.items()}
        if int(msg["stop"]):
            return None, None, False, True
        obs: List[Any] = []
        for i in range(int(msg["n_obs"])):
            obs.append(Observation(
                lm_id=int(msg["lm_ids"][i]),
                z=np.asarray(msg["z"][i], np.float32),
                fixed_rel_pos=(np.asarray(msg["rel"][i], np.float32)
                               if int(msg["has_fixed"][i]) else None),
                init_rel_pos=(np.asarray(msg["rel"][i], np.float32)
                              if int(msg["has_init"][i]) else None),
            ))
        edge_init = None
        n_e = int(msg["n_edges"])
        if n_e:
            edge_init = {int(msg["e_targets"][i]):
                         np.asarray(msg["e_poses"][i], np.float32)
                         for i in range(n_e)}
        return obs, edge_init, bool(int(msg["run_opt"])), False


# ---------------------------------------------------------------------------
# The multi-process engine front end
# ---------------------------------------------------------------------------

class MultiHostEngine:
    """SPMD wrapper around :class:`~srba_tpu_torch.engine.engine.SrbaEngine`
    for multi-process runs (the JAX package's ``MultiHostEngine``).

    Every rank constructs an identical engine replica in the host-window
    mode over the global mesh.  The coordinator feeds real observations;
    every keyframe is broadcast and replayed everywhere, after which the
    window solve runs observation-sharded over the mesh.  On the other ranks
    call :meth:`define_new_keyframe` with no arguments (one broadcast round
    each), or :meth:`serve` to loop until the coordinator's stop record.

    ``broadcast_batch=B`` ships B encoded records as ONE round (the
    coordinator buffers them; skip records pad a partial round), at the
    price of B keyframes of input latency.  With ``B > 1`` the coordinator's
    :meth:`define_new_keyframe` returns ``None`` while buffering and the
    list of the round's ``TNewKeyFrameInfo`` at each flush; the other ranks
    return one such list per round.  Unlike the JAX package, nothing is
    lost at the end: :meth:`stop` returns the infos of the keyframes it
    flushes, and another rank's call that receives the last partial round
    with the stop returns that round's infos (``None`` when it held none).
    ``stopped`` turns True on every rank once the stop record is replayed.
    """

    def __init__(self, obs_model: str, max_obs_per_kf: int = 256,
                 max_init_edges: int = 8, mesh=None,
                 broadcast_batch: int = 1, **engine_kwargs):
        from srba_tpu_torch.engine.engine import SrbaEngine
        engine_kwargs.setdefault("device_master", False)
        self.mesh = mesh if mesh is not None else global_mesh()
        engine_kwargs.setdefault("device", rank_device(self.mesh.device_type))
        self.engine = SrbaEngine(obs_model, mesh=self.mesh, **engine_kwargs)
        self.broadcast_batch = max(1, int(broadcast_batch))
        self.stopped = False
        self._buf: List[Dict[str, np.ndarray]] = []
        self.codec = KeyframeCodec(
            z_dim=self.engine.model.z_dim,
            lm_dim=self.engine.lm_type.dim,
            pose_dim=self.engine.group.dim,
            max_obs=max_obs_per_kf, max_init_edges=max_init_edges)

    # -- the synchronized per-frame step ------------------------------------

    def _broadcast_round(self, msgs):
        """One broadcast round: pad ``msgs`` to the batch size with skip
        records, broadcast, replay every real record locally.  Returns
        ``(infos, stopped)``."""
        B = self.broadcast_batch
        if len(msgs) > B:
            raise ValueError(f"{len(msgs)} records in a round of {B}")
        msgs = list(msgs)
        while len(msgs) < B:
            m = self.codec.zeros()
            m["skip"] = np.int32(1)
            msgs.append(m)
        batch = broadcast_from_coordinator(
            {k: np.stack([m[k] for m in msgs]) for k in msgs[0]})
        infos = []
        for i in range(B):
            row = {k: v[i] for k, v in batch.items()}
            if int(row["skip"]):
                continue
            obs, e_init, run_opt, stop = self.codec.decode(row)
            if stop:
                self.stopped = True
                return infos, True
            infos.append(self.engine.define_new_keyframe(
                obs, run_local_optimization=run_opt, edge_init=e_init))
        return infos, False

    def define_new_keyframe(self, observations: Optional[Sequence] = None,
                            run_local_optimization: bool = True,
                            edge_init: Optional[dict] = None):
        """Coordinator: pass the real observation list.  Others: call with
        ``observations=None`` to receive keyframes.  With
        ``broadcast_batch == 1`` (default) returns the local replica's
        ``TNewKeyFrameInfo`` (``None`` on a stop record); the batched
        returns are in the class docstring."""
        if is_coordinator():
            if observations is None:
                raise ValueError("the coordinator must supply observations")
            msg = self.codec.encode(observations, edge_init,
                                    run_local_optimization)
            if self.broadcast_batch == 1:
                infos, _ = self._broadcast_round([msg])
                return infos[0]
            self._buf.append(msg)
            if len(self._buf) < self.broadcast_batch:
                return None
            msgs, self._buf = self._buf, []
            infos, _ = self._broadcast_round(msgs)
            return infos
        infos, stopped = self._broadcast_round([])
        if self.broadcast_batch == 1:
            return None if stopped else infos[0]
        return infos if infos or not stopped else None

    def flush(self):
        """Coordinator: broadcast any buffered partial batch now (before a
        collective that must see every fed keyframe, such as a mid-run
        :meth:`optimize_global`).  The other ranks take it as an ordinary
        skip-padded round.  Returns the flushed keyframes' infos."""
        if not is_coordinator():
            raise RuntimeError("flush() is the coordinator's")
        if not self._buf:
            return []
        msgs, self._buf = self._buf, []
        infos, _ = self._broadcast_round(msgs)
        return infos

    def stop(self) -> list:
        """Coordinator: flush the buffered keyframes, then release the
        :meth:`serve` loops of the other ranks.  Returns the infos of the
        keyframes it flushed (the JAX package drops them)."""
        if not is_coordinator():
            raise RuntimeError("stop() is the coordinator's")
        self._buf.append(self.codec.encode([], None, False, stop=True))
        msgs, self._buf = self._buf, []
        infos = []
        for i in range(0, len(msgs), self.broadcast_batch):
            got, _ = self._broadcast_round(msgs[i: i + self.broadcast_batch])
            infos.extend(got)
        return infos

    def serve(self) -> int:
        """The other ranks' event loop: replay broadcast keyframes until the
        coordinator sends stop.  Returns the number of keyframes
        processed."""
        if is_coordinator():
            raise RuntimeError("serve() is for the ranks other than 0")
        n = 0
        while True:
            infos, stopped = self._broadcast_round([])
            n += len(infos)
            if stopped:
                return n

    # -- global refinement over the same mesh --------------------------------

    def optimize_global(self, cfg=None, write_back: bool = True,
                        periodic: bool = False, use_edge_info: bool = False,
                        profiler=None):
        """The edge-sharded global PGO over the mesh (every rank holds the
        same exported problem; see :func:`srba_tpu_torch.solver.
        global_graphslam.make_pgo_spmd`).  With ``broadcast_batch > 1`` the
        coordinator must :meth:`flush` at the point every rank calls this."""
        return self.engine.optimize_global(
            cfg, write_back=write_back, mesh=self.mesh, periodic=periodic,
            use_edge_info=use_edge_info, profiler=profiler)

    # -- passthroughs ---------------------------------------------------------

    def __getattr__(self, name):
        if name == "engine":   # not built (yet): no recursion
            raise AttributeError(name)
        return getattr(self.engine, name)
