"""Device meshes and sharded execution on torch.distributed.

Counterpart of swiftwatcher_tpu/parallel/mesh.py.  A (data, model) mesh of
ranks, rank r at (r // model, r % model):

  * data parallelism over 21-frame windows ('data'): each data index takes
    B / data windows of a batch; tracking stays on rank 0, a sequential
    consumer of the (small) region tables;
  * sequence parallelism over pixels inside RPCA ('model'): each model
    index holds a block of the flat pixel axis (or of the crop's width);
    the T x T Grams and the scalar norms are summed (and maxed) over
    'model', then the motion image is gathered over 'model' and the
    stencil stages (K1, K2 and the CCL slow path, the label wrap and the
    region tables) divide the batch's frames across 'model';
  * dp x tp classifier training: the head conv's 512 input channels split
    over 'model' (its pre-activations summed over 'model'), the batch over
    'data' (gradients averaged over 'data').

JAX's mesh is one process driving every device.  Here the caller is rank
0, the controller: it keeps the source, the prefetcher, stabilisation,
the tracker, the classifier and the CSVs, and takes its own share of
every sharded step.  `make_mesh` spawns the other ranks as worker
processes.  `Mesh.run` runs a function of the port on every rank and
returns rank 0's result; the workers keep per-rank state between runs (a
head shard and its Adam moments).  Runs are serialised under the mesh's
lock, so threads (run_videos) may share one mesh.

Backend: NCCL where every rank has a card of its own (rank r on cuda:r);
gloo where ranks share a card, or run on the CPU.  Gloo takes only
broadcast and all_reduce on CUDA tensors, so every gather here is an
all_reduce sum of a zero-filled buffer in which each rank fills its own
block: exact, since each element has one nonzero term.

Every collective and every run has a deadline (`timeout`).  A rank that
raises, dies or overruns ends the mesh: its processes are killed, and the
caller gets a MeshError with the failed rank's traceback.
"""

from __future__ import annotations

import atexit
import dataclasses
import datetime
import itertools
import multiprocessing.connection
import os
import shutil
import sys
import tempfile
import threading
import time
import traceback
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
import torch.nn.functional as F

from .. import build
from ..config import DEFAULT_CONFIG, PipelineConfig
from ..device import pin_numerics
from ..models import train as train_mod
from ..ops.ccl import label_components, wrap_labels_uint8
from ..ops.ccl_local import converge_frames
from ..ops.ccl_sweep import sweep_chunk
from ..ops.color import bgr_to_gray
from ..ops.filtering import apply_postfilter
from ..ops.fused_motion import fused_motion_filter
from ..ops.ialm_front import ialm_front
from ..ops.props import RegionTable, region_tables
from ..ops.rank_compact import label_rank_fused, rank_seed_sweep
from ..ops.rpca import _DTYPES, ialm_gates_and_kwargs, ialm_rpca_batched, motion_from_E

DEFAULT_TIMEOUT = 300.0  # seconds a run, a collective or the start may take
_PACKAGE = __name__.split(".")[0]


class MeshError(RuntimeError):
    """A rank raised, died or overran the deadline; the mesh is closed."""


class AxisGroup:
    """The ranks along one mesh axis through this rank: the counterpart of
    a shard_map axis name, with sum (psum), max (pmax), gather (tiled
    all_gather) and index (axis_index).  `seconds` adds up the host time
    spent in its collectives."""

    def __init__(self, group, size: int, index: int):
        self.group, self.size, self.index = group, size, index
        self.seconds = 0.0

    def _all_reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        t0 = time.perf_counter()
        dist.all_reduce(t, op=op, group=self.group)
        self.seconds += time.perf_counter() - t0
        return t

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        if self.size == 1:
            return t
        return self._all_reduce(t.clone(memory_format=torch.contiguous_format),
                                dist.ReduceOp.SUM)

    def max(self, t: torch.Tensor) -> torch.Tensor:
        if self.size == 1:
            return t
        return self._all_reduce(t.clone(memory_format=torch.contiguous_format),
                                dist.ReduceOp.MAX)

    def gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's block of `dim`, concatenated in axis order."""
        if self.size == 1:
            return t
        src = t.to(torch.uint8) if t.dtype == torch.bool else t
        shape = list(src.shape)
        n = shape[dim]
        shape[dim] = n * self.size
        buf = src.new_zeros(shape)
        buf.narrow(dim, self.index * n, n).copy_(src)
        self._all_reduce(buf, dist.ReduceOp.SUM)
        return buf.bool() if t.dtype == torch.bool else buf


@dataclasses.dataclass
class RankContext:
    """What a rank's share of a run sees: its place in the mesh, its
    device, its axis groups and the state it keeps between runs."""

    rank: int
    shape: Tuple[int, int]
    device: torch.device
    data: AxisGroup
    model: AxisGroup
    world: AxisGroup
    state: Dict[str, Any]


def _init_rank(rank: int, shape, device, backend: str, store_path: str,
               timeout: float) -> RankContext:
    """Join the process group and form the axis groups (every rank forms
    every group, in the same order, as torch.distributed requires)."""
    D, M = shape
    dist.init_process_group(
        backend, store=dist.FileStore(store_path, D * M), rank=rank, world_size=D * M,
        timeout=datetime.timedelta(seconds=timeout))
    d, m = divmod(rank, M)
    model = data = None
    if M > 1:
        model = [dist.new_group([dd * M + mm for mm in range(M)]) for dd in range(D)][d]
    if D > 1:
        data = [dist.new_group([dd * M + mm for dd in range(D)]) for mm in range(M)][m]
    return RankContext(rank, (D, M), device, data=AxisGroup(data, D, d),
                       model=AxisGroup(model, M, m), world=AxisGroup(None, D * M, rank),
                       state={})


def _worker(rank, shape, device, backend, store_path, timeout, conn) -> None:
    """A worker rank: join the mesh, then run rank 0's commands until it
    sends None.  Any failure is sent to rank 0 with its traceback, and the
    process exits."""
    try:
        if device.type == "cuda":
            torch.cuda.set_device(device)
            pin_numerics()
        else:
            torch.set_num_threads(1)  # one thread per rank: ranks share the host's cores
        conn.send(("ok",))
        ctx = _init_rank(rank, shape, device, backend, store_path, timeout)
        conn.send(("ok",))
        while True:
            try:
                msg = conn.recv()
            except EOFError:  # rank 0 is gone
                os._exit(1)
            if msg is None:
                break
            fn, args, kwargs = msg
            fn(ctx, *args, **kwargs)
            conn.send(("ok",))
    except BaseException:
        try:
            conn.send(("err", traceback.format_exc()))
        finally:
            os._exit(1)
    dist.destroy_process_group()


@dataclasses.dataclass
class _Worker:
    rank: int
    proc: Any
    conn: Any


class Mesh:
    """A (data, model) mesh of ranks; this process is rank 0.

    shape: {"data": D, "model": M}; device: rank 0's device; backend: the
    process group's ("nccl" or "gloo"); timeout: the seconds the start, a
    run and (fixed at the start) a collective may take.  Close it
    (`close()`, or use it as a context manager); one mesh per process at a
    time."""

    def __init__(self, shape: Tuple[int, int], device: torch.device,
                 timeout: float = DEFAULT_TIMEOUT):
        D, M = shape
        if D < 1 or M < 1:
            raise ValueError(f"mesh shape must be positive, got {shape}")
        if dist.is_initialized():
            raise RuntimeError("this process already has a process group; close the "
                               "other mesh first")
        self.shape = {"data": D, "model": M}
        self.size = D * M
        self.timeout = float(timeout)
        device = torch.device(device)
        if device.type == "cuda":
            own = self.size <= torch.cuda.device_count()
            index = device.index if device.index is not None else torch.cuda.current_device()
            self.devices = ([torch.device("cuda", r) for r in range(self.size)] if own
                            else [torch.device("cuda", index)] * self.size)
            self.backend = "nccl" if own else "gloo"
        else:
            self.devices = [torch.device("cpu")] * self.size
            self.backend = "gloo"
        self.device = self.devices[0]
        self._lock = threading.Lock()
        self._closed = False
        self._slots = itertools.count()
        self._workers: List[_Worker] = []
        if self.device.type == "cuda":
            build.build_all()  # here, once, not by every rank at its first launch
        self._tmp = tempfile.mkdtemp(prefix="swt_mesh_")
        store = os.path.join(self._tmp, "store")
        spawn = mp.get_context("spawn")
        try:
            for r in range(1, self.size):
                parent, child = spawn.Pipe()
                proc = spawn.Process(
                    target=_worker, name=f"swt-mesh-rank{r}", daemon=True,
                    args=(r, (D, M), self.devices[r], self.backend, store, self.timeout, child))
                proc.start()
                child.close()
                self._workers.append(_Worker(r, proc, parent))
            self._step(lambda: None)  # every worker started
            if self.device.type == "cuda":
                pin_numerics()
            hook = sys.excepthook
            self._ctx = self._step(lambda: _init_rank(
                0, (D, M), self.device, self.backend, store, self.timeout))
            # init_process_group prefixes the caller's tracebacks with the rank
            sys.excepthook = hook
        except BaseException:
            self._abort()
            raise
        atexit.register(self.close)

    def __enter__(self) -> "Mesh":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape['data']}, model={self.shape['model']}, "
                f"backend={self.backend}, device={self.device})")

    def run(self, fn, *args, shards: Optional[Sequence] = None, **kwargs):
        """fn(ctx, [shards[rank],] *args, **kwargs) on every rank at once;
        rank 0's result.  fn is a module-level function of the port (sent
        by name); args, kwargs and the shards are pickled to the workers
        (rank 0's shard is passed as it is)."""
        if not getattr(fn, "__module__", "").startswith(_PACKAGE + "."):
            raise ValueError(f"Mesh.run takes a function of {_PACKAGE}, got {fn!r}")
        if shards is not None and len(shards) != self.size:
            raise ValueError(f"want {self.size} shards, got {len(shards)}")

        def argv(r):
            return ((shards[r],) if shards is not None else ()) + args

        with self._lock:
            if self._closed:
                raise MeshError("the mesh is closed")
            try:
                for w in self._workers:
                    w.conn.send((fn, argv(w.rank), kwargs))
            except OSError as e:
                self._abort()
                raise MeshError(f"a rank of the mesh is gone: {e}") from e
            return self._step(lambda: fn(self._ctx, *argv(0), **kwargs))

    def _step(self, local):
        """Run rank 0's part while a watcher thread waits for every worker's
        reply; on a failure, or past the deadline, the watcher kills the
        workers (so rank 0's collectives with them fail) and the mesh
        closes."""
        failure: List[str] = []
        stop = threading.Event()
        watcher = threading.Thread(target=self._watch, args=(stop, failure), daemon=True)
        watcher.start()
        try:
            result = local()
        except BaseException as e:
            stop.set()
            watcher.join()
            self._abort()
            if failure:
                raise MeshError(failure[0]) from e
            raise
        watcher.join()
        if failure:
            self._abort()
            raise MeshError(failure[0])
        return result

    def _watch(self, stop: threading.Event, failure: List[str]) -> None:
        deadline = time.monotonic() + self.timeout
        pending = {w.conn: w for w in self._workers}
        while pending and not stop.is_set() and not failure:
            left = deadline - time.monotonic()
            if left <= 0:
                failure.append(
                    f"mesh rank(s) {sorted(w.rank for w in pending.values())} did not "
                    f"finish within the timeout of {self.timeout:g} s")
                break
            for conn in multiprocessing.connection.wait(list(pending), timeout=min(left, 0.5)):
                w = pending.pop(conn)
                try:
                    msg = conn.recv()
                except (EOFError, OSError):
                    msg = ("err", "the process exited")
                if msg[0] != "ok":
                    failure.append(f"mesh rank {w.rank} failed:\n{msg[1]}")
                    break
        if failure:
            self._kill_workers()

    def _kill_workers(self) -> None:
        for w in self._workers:
            if w.proc.is_alive():
                w.proc.kill()
        for w in self._workers:
            w.proc.join(timeout=10)

    def _release(self) -> None:
        if dist.is_initialized():
            dist.destroy_process_group()
        for w in self._workers:
            w.conn.close()
        shutil.rmtree(self._tmp, ignore_errors=True)
        atexit.unregister(self.close)

    def _abort(self) -> None:
        self._closed = True
        self._kill_workers()
        try:
            self._release()
        except RuntimeError:
            pass  # the group died with its peers

    def close(self) -> None:
        """Stop the workers and leave the process group."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            for w in self._workers:
                try:
                    w.conn.send(None)
                except OSError:
                    pass
            for w in self._workers:
                w.proc.join(timeout=30)
            self._kill_workers()
            self._release()

    def _new_slot(self) -> str:
        """A fresh key for per-rank state."""
        return f"slot{next(self._slots)}"


def make_mesh(shape: Optional[Tuple[int, int]] = None, n_devices: Optional[int] = None, *,
              device="cuda", timeout: float = DEFAULT_TIMEOUT) -> Mesh:
    """A (data, model) mesh of shape[0] x shape[1] ranks, rank 0 on `device`.

    The default shape puts a factor of 2 on 'model' when n_devices is even
    (pixel and tensor sharding) and the rest on 'data' (window sharding);
    n_devices defaults to the cards present (on a CUDA device) or 1."""
    device = torch.device(device)
    if shape is None:
        n = n_devices or (torch.cuda.device_count() if device.type == "cuda" else 1)
        model = 2 if n % 2 == 0 and n > 1 else 1
        shape = (n // model, model)
    return Mesh((int(shape[0]), int(shape[1])), device, timeout)


def ping(ctx: RankContext, delay: float = 0.0) -> int:
    """Sleep `delay` seconds on each rank and return the rank: a run's round
    trip, and (with a delay per rank) a rank that stalls or raises."""
    time.sleep(delay)
    return ctx.rank


# the wrappers of K1-K6, whose launch counts rank_counters reports
_KERNELS = {f.__name__: f for f in (fused_motion_filter, label_rank_fused, sweep_chunk,
                                    converge_frames, rank_seed_sweep, ialm_front)}


def rank_counters(ctx: RankContext, reset: bool = False):
    """Every rank's kernel launches (K1-K6, by wrapper name) and host
    seconds in collectives since the last reset; with reset, zero them
    and return None.  Rank 0 gets {"launches": [{name: n}, ...],
    "collective_seconds": [s, ...]}, one entry per rank."""
    groups = (ctx.data, ctx.model, ctx.world)
    if reset:
        for w in _KERNELS.values():
            w.launches = 0
        for g in groups:
            g.seconds = 0.0
        return None
    row = [float(w.launches) for w in _KERNELS.values()] + [sum(g.seconds for g in groups)]
    rows = ctx.world.gather(torch.tensor([row], dtype=torch.float64, device=ctx.device))
    rows = rows.cpu().tolist()
    return {"launches": [{k: int(v) for k, v in zip(_KERNELS, r)} for r in rows],
            "collective_seconds": [r[-1] for r in rows]}


# ---- sharded localisation ------------------------------------------------


def _scatter(blocks: Sequence[torch.Tensor]) -> list:
    """Rank 0's block as it is; the others' as contiguous host arrays."""
    return [blocks[0]] + [b.contiguous().cpu().numpy() for b in blocks[1:]]


def _rpca_block(ctx: RankContext, X_u8: torch.Tensor, cfg: PipelineConfig):
    """IALM on this rank's pixel block, the Grams and norms summed over
    'model': (uint8 motion of the block, (b,) iterations)."""
    dtype = _DTYPES[cfg.rpca_dtype]
    X = X_u8.to(dtype)
    _, E, iters = ialm_rpca_batched(X, group=ctx.model,
                                    **ialm_gates_and_kwargs(cfg, dtype, X.device))
    return motion_from_E(E, X.shape[-1]), iters


def _stencil_tables(ctx: RankContext, motion: torch.Tensor, cfg: PipelineConfig,
                    with_bbox: bool) -> RegionTable:
    """The post-RPCA stages divided across 'model' by frame slices (JAX
    mesh.py:60-87): each rank filters, labels and tabulates bt / model
    frames of the (b, t, H, W) motion (zero frames pad bt to a multiple),
    then the tables are gathered over 'model'."""
    b, t, H, W = motion.shape
    m = ctx.model.size
    bt = b * t
    btp = -(-bt // m) * m
    flat = motion.reshape(bt, H, W)
    if btp != bt:
        flat = F.pad(flat, (0, 0, 0, 0, 0, btp - bt))
    k = btp // m
    mine = flat[ctx.model.index * k:(ctx.model.index + 1) * k].contiguous()
    filtered = apply_postfilter(mine, cfg)
    labels, _ = label_components(filtered > 0, cfg.ccl_max_iters)
    table = region_tables(wrap_labels_uint8(labels, cfg.label_modulus), with_bbox=with_bbox)
    return table.map(lambda a: ctx.model.gather(a, 0)[:bt].reshape(b, t, *a.shape[1:]))


def _to_rank0(ctx: RankContext, table: RegionTable, iters: torch.Tensor):
    """Gather the windows' tables and iterations over 'data' (the ranks of
    model index 0 hold them all): (RegionTable, iters) on rank 0."""
    if ctx.model.index != 0:
        return None
    table = table.map(lambda a: ctx.data.gather(a, 0))
    iters = ctx.data.gather(iters, 0)
    return (table, iters) if ctx.rank == 0 else None


def _localize_gray_rank(ctx: RankContext, block, H: int, W: int, cfg: PipelineConfig,
                        with_bbox: bool):
    local = torch.as_tensor(block).to(ctx.device)             # (b, T, P_pad / model)
    b, t, _ = local.shape
    motion, iters = _rpca_block(ctx, local, cfg)
    # reassemble the flat pixel axis and drop the mesh padding
    motion = ctx.model.gather(motion, 2)[..., : H * W]
    table = _stencil_tables(ctx, motion.reshape(b, t, H, W), cfg, with_bbox)
    return _to_rank0(ctx, table, iters)


def _localize_bgr_rank(ctx: RankContext, block, cfg: PipelineConfig, with_bbox: bool):
    gray = bgr_to_gray(torch.as_tensor(block).to(ctx.device))  # (b, T, H, W / model)
    b, t, h, w = gray.shape
    motion, iters = _rpca_block(ctx, gray.reshape(b, t, h * w), cfg)
    motion = ctx.model.gather(motion.reshape(b, t, h, w), 3)
    table = _stencil_tables(ctx, motion, cfg, with_bbox)
    return _to_rank0(ctx, table, iters)


def sharded_localize_windows(crops, mesh: Mesh, cfg: PipelineConfig = DEFAULT_CONFIG,
                             with_bbox: bool = False):
    """Window localisation over a mesh (JAX mesh.py:90-140): windows split
    over 'data', RPCA pixels over 'model' by width blocks, the stencil
    stages divided across 'model' after a gather of the motion image.

    crops: (B, T, H, W, 3) uint8 (a tensor or an array) with B % data == 0
    and W % model == 0.  Returns (RegionTable (B, T, 256), iters (B,)) on
    rank 0's device."""
    crops = torch.as_tensor(crops)
    B, T, H, W, _ = crops.shape
    D, M = mesh.shape["data"], mesh.shape["model"]
    if B % D or W % M:
        raise ValueError(f"want B % data == 0 and W % model == 0, got B={B}, W={W} "
                         f"on a {D}x{M} mesh")
    b, w = B // D, W // M
    blocks = [crops[d * b:(d + 1) * b, :, :, m * w:(m + 1) * w]
              for d in range(D) for m in range(M)]
    return mesh.run(_localize_bgr_rank, cfg, with_bbox, shards=_scatter(blocks))


def sharded_localize_windows_gray(gray, mesh: Mesh, cfg: PipelineConfig = DEFAULT_CONFIG,
                                  with_bbox: bool = False):
    """Sharded localisation of gray windows of any crop geometry, the
    runner's mesh mode (JAX mesh.py:143-202).  The flat pixel axis is
    split over 'model', zero-padded to a multiple of it (zero pixels are
    IALM-neutral; the padding is dropped before the stencil stages).

    gray: (B, T, H, W) uint8 (a tensor or an array) with B % data == 0.
    Returns (RegionTable (B, T, 256), iters (B,)) on rank 0's device."""
    gray = torch.as_tensor(gray)
    B, T, H, W = gray.shape
    D, M = mesh.shape["data"], mesh.shape["model"]
    if B % D:
        raise ValueError(f"batch of {B} windows does not divide over the mesh 'data' "
                         f"axis ({D})")
    P = H * W
    P_pad = -(-P // M) * M
    X = gray.reshape(B, T, P)
    if P_pad != P:
        X = F.pad(X, (0, P_pad - P))
    b, p = B // D, P_pad // M
    blocks = [X[d * b:(d + 1) * b, :, m * p:(m + 1) * p] for d in range(D) for m in range(M)]
    return mesh.run(_localize_gray_rank, H, W, cfg, with_bbox, shards=_scatter(blocks))


# ---- dp x tp classifier training -----------------------------------------


class _SumForward(torch.autograd.Function):
    """The sum over an axis forward and the identity backward: the loss is
    replicated over that axis, so each rank's partial pre-activations get
    the full gradient (torch.distributed.nn's all_reduce would sum it, M
    times too large)."""

    @staticmethod
    def forward(fctx, x, axis):
        return axis.sum(x)

    @staticmethod
    def backward(fctx, g):
        return g, None


@dataclasses.dataclass(frozen=True)
class Placed:
    """A value held by the mesh's ranks, sharded by its placement: the
    per-rank state under `slot` (a head and its Adam share one, features
    and labels another)."""

    mesh: Mesh
    slot: str


def _place_rank(ctx: RankContext, shard: dict, head_slot: str, feat_slot: str, lr: float):
    dev = ctx.device
    head = {k: torch.as_tensor(v).to(dev, torch.float32) for k, v in shard["head"].items()}
    opt = train_mod.make_optimizer(head, lr)
    count, mu, nu = shard["adam"]
    if count:
        train_mod.set_adam_state(opt, head, count, mu, nu)
    ctx.state[head_slot] = (head, opt)
    ctx.state[feat_slot] = (torch.as_tensor(shard["feats"]).to(dev, torch.float32),
                            torch.as_tensor(shard["labels"]).to(dev, torch.int64))


def _train_step_rank(ctx: RankContext, head_slot: str, feat_slot: str):
    head, opt = ctx.state[head_slot]
    feats, labels = ctx.state[feat_slot]
    w, bias = (head[k] for k in train_mod.HEAD_KEYS)
    opt.zero_grad(set_to_none=True)
    pre = F.conv2d(feats, w)                      # this rank's channels' partial sums
    if ctx.model.size > 1:
        pre = _SumForward.apply(pre, ctx.model)
    logits = F.relu(pre + bias[None, :, None, None]).mean(dim=(2, 3))
    loss = F.cross_entropy(logits, labels)
    loss.backward()
    D = ctx.data.size
    for p in (w, bias):
        p.grad = ctx.data.sum(p.grad) / D
    opt.step()
    total = ctx.data.sum(loss.detach()) / D       # the global batch mean
    return float(total) if ctx.rank == 0 else None


def _gather_head_rank(ctx: RankContext, head_slot: str):
    head, _ = ctx.state[head_slot]
    w, bias = (head[k].detach() for k in train_mod.HEAD_KEYS)
    w = ctx.model.gather(w, 1)
    if ctx.rank != 0:
        return None
    return {train_mod.HEAD_KEYS[0]: w.cpu(), train_mod.HEAD_KEYS[1]: bias.cpu()}


def gather_head(head: Placed) -> Dict[str, torch.Tensor]:
    """The placed head's tensors, whole, on the host."""
    return head.mesh.run(_gather_head_rank, head.slot)


def sharded_train_step(mesh: Mesh, lr: float = 1e-3):
    """A classifier-head train step over the mesh (JAX mesh.py:205-237).

    Placement: features dp over 'data' (batch) and tp over 'model' (their
    512 channels), the head weight's 512 input channels over 'model',
    labels over 'data'; the bias and Adam's step count replicated.

    Returns (step, place): place(head, opt_state, feats, labels) puts a
    head (port layout), its Adam (make_optimizer's, or None for a fresh
    one), (N, 512, h, w) features and (N,) labels on the ranks and returns
    them as Placed handles; step(head, opt_state, feats, labels) ->
    (head, opt_state, loss) takes one step on every rank, loss being the
    global batch mean."""
    D, M = mesh.shape["data"], mesh.shape["model"]

    def place(head, opt_state, feats, labels):
        head = {k: torch.as_tensor(head[k]).detach().cpu() for k in train_mod.HEAD_KEYS}
        feats, labels = torch.as_tensor(feats), torch.as_tensor(labels)
        C, N = head[train_mod.HEAD_KEYS[0]].shape[1], feats.shape[0]
        if C % M or N % D or feats.shape[1] != C:
            raise ValueError(f"want {C} channels divisible by model={M} and a batch of "
                             f"{N} divisible by data={D}, got features {tuple(feats.shape)}")
        count, mu, nu = (train_mod.adam_state(opt_state, _opt_head(opt_state))
                         if opt_state is not None else (0, {}, {}))
        c, n = C // M, N // D

        def cut(tree, m):
            """The weight's input channels of model index m; the rest whole."""
            return {k: (v[:, m * c:(m + 1) * c] if k == train_mod.HEAD_KEYS[0] else v)
                    .detach().cpu().numpy() for k, v in tree.items()}

        shards = [dict(head=cut(head, m), adam=(count, cut(mu, m), cut(nu, m)),
                       feats=feats[d * n:(d + 1) * n, m * c:(m + 1) * c].cpu().numpy(),
                       labels=labels[d * n:(d + 1) * n].cpu().numpy())
                  for d, m in (divmod(r, M) for r in range(mesh.size))]
        hs, fs = mesh._new_slot(), mesh._new_slot()
        mesh.run(_place_rank, hs, fs, lr, shards=shards)
        return Placed(mesh, hs), Placed(mesh, hs), Placed(mesh, fs), Placed(mesh, fs)

    def step(head: Placed, opt_state: Placed, feats: Placed, labels: Placed):
        if not (head.mesh is opt_state.mesh is feats.mesh is labels.mesh is mesh
                and head.slot == opt_state.slot and feats.slot == labels.slot):
            raise ValueError("step takes the handles of one place() on this mesh")
        loss = mesh.run(_train_step_rank, head.slot, feats.slot)
        return head, opt_state, loss

    return step, place


def _opt_head(opt: torch.optim.Adam) -> Dict[str, torch.Tensor]:
    """The head tensors an Adam of make_optimizer updates, by HEAD_KEYS."""
    return dict(zip(train_mod.HEAD_KEYS, opt.param_groups[0]["params"]))


def init_sharded_training(mesh: Mesh, params, lr: float = 1e-3):
    """Split params (a port state dict), make the head's Adam and the
    sharded step: (trunk, head, opt_state, step, place), trunk and head on
    rank 0's device (JAX mesh.py:240-250)."""
    trunk, head = train_mod.split_params(
        {k: torch.as_tensor(v).to(mesh.device) for k, v in params.items()})
    opt_state = train_mod.make_optimizer(head, lr)
    step, place = sharded_train_step(mesh, lr)
    return trunk, head, opt_state, step, place
