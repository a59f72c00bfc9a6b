"""Device meshes on torch.distributed (counterpart of
aphantasia_tpu.parallel.mesh).

The JAX package has one process drive every device and lets XLA insert
the collectives.  The port runs one process per rank: rank r works on
`cuda:<local rank>` over NCCL, or with `--device cpu` on the CPU over
gloo (the backend follows from the device), and the collectives are
written out here.  Ranks lie on a (data, model, spatial) grid with the
spatial axis innermost, then the model axis: global rank r = (d * model
+ m) * spatial + s (spatial = 1 without `--spatial`).

* The data axis splits a step's cutouts: each rank cuts, augments and
  encodes its own rows (`Mesh.rows`; shard sizes differ by one when the
  count does not divide), the encodings are gathered whole on every rank
  (`gather_rows`, whose backward keeps the rank's own rows), the terms on
  the whole image count their gradient on data rank 0 only
  (`replicated`), and the generator's gradients are summed over the data
  axis (`reduce_grads`).
* The model axis shards the CLIP transformer blocks tensor-parallel
  (`shard_clip_params`): each rank holds a group of heads of the
  attention and a slice of the MLP, and the blocks all-reduce over the
  model axis (`copy_to_model`, `reduce_from_model`; models/clip/model.py).
* The spatial axis (`make_mesh_spatial`, `--spatial`) shards the canvas
  itself: each rank holds a part of the params and decodes its rows of
  the image (parallel/spatial.py, parallel/spatial_dwt.py).

`launch` starts the ranks of a mesh: one process per local rank (start
method spawn), each joining the mesh's group, the results sent back to
the caller; a mesh of one rank runs in the caller's process.  The
launcher stops every child it started, and a rank that fails makes the
launch fail.  Every collective wrapper adds one to
`kernels.LAUNCHES[name]` where it launches its collective, so a CUDA
graph's replays count them (`kernels.CountedGraph`).
"""
from __future__ import annotations

import dataclasses
import multiprocessing.connection
import os
import pickle
import socket
import sys
import traceback
from typing import Any, Callable

import torch
import torch.distributed as dist

from aphantasia_torch import kernels

_MODEL_GROUP = None     # this rank's model-axis group, when model > 1
_MESH_RANK = None       # this process's global mesh rank, inside a mesh


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of a (data[, model][, spatial]) mesh: the axis
    names, their sizes, the rank's coordinates and device, the group of
    its data column (the ranks that share its model and spatial
    coordinates) and, with a spatial axis, the group of the ranks that
    share its data and model coordinates.  The group of its model row
    (the ranks that share its data and spatial coordinates) is the
    process's `_MODEL_GROUP`, which the sharded blocks read.  An axis the
    mesh lacks has size 1 and coordinate 0 (`size`, `coord`)."""
    axis_names: tuple
    shape: dict
    rank: int
    coords: dict
    device: torch.device
    data_group: Any
    spatial_group: Any = None

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def coord(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def sizes(self, n: int) -> list:
        """The rows of each data rank, `n` split as evenly as it goes (the
        first n % data ranks take one more)."""
        k = self.size("data")
        if n < k:
            raise ValueError(f"{n} samples cannot be split over a data axis "
                             f"of {k}")
        return [n // k + (i < n % k) for i in range(k)]

    def rows(self, n: int) -> slice:
        """This rank's rows of `n` samples."""
        sizes = self.sizes(n)
        d = self.coord("data")
        lo = sum(sizes[:d])
        return slice(lo, lo + sizes[d])


def mesh_primary() -> bool:
    """True outside a mesh and on its rank 0, which writes the outputs."""
    return _MESH_RANK in (None, 0)


def _device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _grid_mesh(data: int, model: int, axes: tuple, spatial: int = 1) -> Mesh:
    """The Mesh of this rank on the initialised default group, which must
    hold data * model * spatial ranks; `axes` names the axes the mesh has
    ("data", "model", "spatial" in that order, any of them absent).  Every
    rank creates every group, in one order, as torch.distributed asks."""
    global _MODEL_GROUP
    world = dist.get_world_size()
    sizes = {"data": data, "model": model, "spatial": spatial}
    n = data * model * spatial
    if world != n:
        raise ValueError(f"mesh {({a: sizes[a] for a in axes})} needs {n} "
                         f"devices, have {world}")
    rank = dist.get_rank()
    dm, s = divmod(rank, spatial)
    d, m = divmod(dm, model)

    def r(dd, mm, ss):
        return (dd * model + mm) * spatial + ss
    data_group = model_grp = spatial_grp = None
    for mm in range(model):
        for ss in range(spatial):
            g = dist.new_group([r(dd, mm, ss) for dd in range(data)])
            if (mm, ss) == (m, s):
                data_group = g
    for dd in range(data):
        for ss in range(spatial):
            g = dist.new_group([r(dd, mm, ss) for mm in range(model)])
            if (dd, ss) == (d, s):
                model_grp = g
    if "spatial" in axes:
        for dd in range(data):
            for mm in range(model):
                g = dist.new_group([r(dd, mm, ss) for ss in range(spatial)])
                if (dd, mm) == (d, m):
                    spatial_grp = g
    _MODEL_GROUP = model_grp if model > 1 else None
    coords = {"data": d, "model": m, "spatial": s}
    return Mesh(tuple(axes), {a: sizes[a] for a in axes}, rank,
                {a: coords[a] for a in axes}, _device(), data_group,
                spatial_grp)


def make_mesh(n_devices: int | None = None, axes=("data",)) -> Mesh:
    """A 1-D data mesh over the group's ranks, or with two axis names a
    (data, model) mesh whose model axis is the largest of 2 and 4 that
    divides the rank count (1 if neither does), innermost."""
    n = dist.get_world_size() if n_devices is None else n_devices
    if len(axes) == 1:
        return _grid_mesh(n, 1, ("data",))
    model = 1
    for cand in (2, 4):
        if n % cand == 0:
            model = cand
    return _grid_mesh(n // model, model, tuple(axes))


def make_mesh_2d(data: int, model: int) -> Mesh:
    """The explicit data x model mesh of an 'NxM' spec, model innermost."""
    return _grid_mesh(data, model, ("data", "model"))


def make_mesh_spatial(spatial: int, mesh_spec=None) -> Mesh:
    """The canvas axis composed with the cutout axes of a --mesh spec:
    ('data'[, 'model'], 'spatial') with the spatial axis innermost, as
    the JAX package lays it out ('N' a data axis, 'NxM' data x model; no
    spec, '0' or '1' the spatial axis alone).  'dcn' raises, as int()
    does on it in JAX."""
    axes, dims = [], {"data": 1, "model": 1}
    if mesh_spec and str(mesh_spec) not in ("0", "1"):
        s = str(mesh_spec).lower()
        if "x" in s:
            dims["data"], dims["model"] = (int(v) for v in s.split("x"))
            axes += ["data", "model"]
        else:
            dims["data"] = int(s)
            axes += ["data"]
    return _grid_mesh(dims["data"], dims["model"], tuple(axes) + ("spatial",),
                      int(spatial))


# ------------------------------------------------------------- collectives

def _count(name: str) -> None:
    kernels.LAUNCHES[name] += 1


class _GatherRows(torch.autograd.Function):
    """Every data rank's rows, whole on each.  Each rank computes the same
    loss from them, so the cotangent of the gathered rows is whole on
    every rank too, and the backward returns the rank's own rows (a sum
    over the ranks would count it `data` times)."""

    @staticmethod
    def forward(ctx, x, mesh: Mesh, n: int):
        sizes = mesh.sizes(n)
        ctx.rows = mesh.rows(n)
        top = max(sizes)
        if x.shape[0] < top:
            x = torch.cat([x, x.new_zeros((top - x.shape[0],)
                                          + tuple(x.shape[1:]))])
        parts = [torch.empty_like(x) for _ in sizes]
        dist.all_gather(parts, x.contiguous(), group=mesh.data_group)
        _count("all_gather")
        return torch.cat([p[:s] for p, s in zip(parts, sizes)])

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rows], None, None


def gather_rows(x, mesh: Mesh, n: int):
    """[rows of this rank, ...] -> [n, ...], the data ranks' rows in
    order (differentiable: see `_GatherRows`)."""
    return _GatherRows.apply(x, mesh, n)


class _CountOnce(torch.autograd.Function):
    """Identity; the gradient passes on data rank 0 and is zero on the
    others."""

    @staticmethod
    def forward(ctx, x, keep: bool):
        ctx.keep = keep
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.keep else torch.zeros_like(g)), None


def replicated(x, mesh: Mesh | None):
    """`x`, which every data rank holds whole, for the terms computed on
    it (the image-side loss terms): their gradient is whole on every rank,
    so it passes on data rank 0 only, and the sum over the data axis
    (`reduce_grads`) counts it once.  The identity without a mesh or on
    data rank 0."""
    if mesh is None or mesh.coord("data") == 0:
        return x
    return _CountOnce.apply(x, False)


@torch.no_grad()
def reduce_grads(grads, mesh: Mesh) -> None:
    """Sum the generator's gradients over the data axis, in place.  A
    gradient autograd leaves strided (the DWT pyramid's Yl, from the crop
    of the coarsest synthesis) is summed in a contiguous copy: gloo sums
    the storage in memory order, which a strided view does not share
    element for element."""
    for g in grads:
        buf = g if g.is_contiguous() else g.contiguous()
        dist.all_reduce(buf, group=mesh.data_group)
        _count("all_reduce")
        if buf is not g:
            g.copy_(buf)


class _CopyToModel(torch.autograd.Function):
    """Where a column-parallel product begins: identity forward, the
    input's gradient summed over the model axis backward."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=_MODEL_GROUP)
        _count("tp_all_reduce")
        return g


class _ReduceFromModel(torch.autograd.Function):
    """Where a row-parallel product ends: the partial products summed over
    the model axis forward, identity backward."""

    @staticmethod
    def forward(ctx, x):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=_MODEL_GROUP)
        _count("tp_all_reduce")
        return x

    @staticmethod
    def backward(ctx, g):
        return g


def copy_to_model(x):
    return _CopyToModel.apply(x)


def reduce_from_model(x):
    return _ReduceFromModel.apply(x)


# ---------------------------------------------------------------- sharding

def _tp_block(blk: dict, m: int, k: int) -> dict:
    """Block `blk` of model rank m of k: q, k and v each cut into k head
    groups (in_w [D, 3D] -> [D, 3D/k]), out_w row-parallel over the same
    heads, fc_w column-parallel, proj_w row-parallel; the biases that
    follow an all-reduce stay whole."""
    at, mlp = blk["attn"], blk["mlp"]
    d = at["out_w"].shape[0]
    w = d // k

    def heads(t):                     # [..., 3D] -> [..., 3D/k]
        return torch.cat([t[..., j * d + m * w:j * d + (m + 1) * w]
                          for j in range(3)], -1).contiguous()
    hid = mlp["fc_w"].shape[1] // k
    out = dict(blk)
    out["attn"] = dict(at, in_w=heads(at["in_w"]), in_b=heads(at["in_b"]),
                       out_w=at["out_w"][m * w:(m + 1) * w].contiguous())
    out["mlp"] = dict(mlp,
                      fc_w=mlp["fc_w"][:, m * hid:(m + 1) * hid].contiguous(),
                      fc_b=mlp["fc_b"][m * hid:(m + 1) * hid].contiguous(),
                      proj_w=mlp["proj_w"][m * hid:(m + 1) * hid].contiguous())
    return out


def shard_clip_params(params: dict, mesh_or_coords, cfg) -> dict:
    """The tensor-parallel shard of a CLIP param tree for one model rank
    (the layout of the JAX `shard_clip_params`, with in_w cut by heads):
    the transformer blocks of both towers (the text tower exists in every
    model, the ResNets included) are sliced by `_tp_block`, everything
    else is whole; the ResNet trunk and its attention pool stay whole.
    `mesh_or_coords` is a Mesh or a (model rank, model size) pair.  Raises
    when the model size does not divide a tower's heads."""
    if isinstance(mesh_or_coords, Mesh):
        m, k = mesh_or_coords.coord("model"), mesh_or_coords.size("model")
    else:
        m, k = mesh_or_coords
    if k == 1:
        return params
    heads = {"visual": cfg.vision_heads, "text": cfg.transformer_heads}
    out = dict(params)
    for tower in ("visual", "text"):
        tp = params.get(tower)
        if not isinstance(tp, dict) or "blocks" not in tp:
            continue
        if heads[tower] % k:
            raise ValueError(f"the {tower} tower's {heads[tower]} heads do "
                             f"not split over a model axis of {k}")
        out[tower] = dict(tp, blocks=[_tp_block(b, m, k)
                                      for b in tp["blocks"]])
    return out


def data_sharding(mesh: Mesh, n: int) -> slice:
    """This rank's rows of `n` samples along the data axis."""
    return mesh.rows(n)


def shard_batch(tree, mesh: Mesh, n: int):
    """This rank's rows of a tree (named tuples, tuples, dicts) of tensors
    whose leading axis holds `n` samples; None stays None."""
    rows = data_sharding(mesh, n)

    def cut(x):
        if x is None:
            return None
        if isinstance(x, torch.Tensor):
            return x[rows]
        if isinstance(x, dict):
            return {k: cut(v) for k, v in x.items()}
        vals = [cut(v) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else type(x)(vals)
    return cut(tree)


# ---------------------------------------------------------------- launching

@dataclasses.dataclass(frozen=True)
class Plan:
    """How a mesh's ranks start: `n_local` ranks on this host, host `host`
    of `hosts` (global rank = host * n_local + local rank), the group's
    rendezvous `addr` ('host:port') and the device type."""
    n_local: int
    addr: str
    device: str = "cpu"
    hosts: int = 1
    host: int = 0

    @property
    def world(self) -> int:
        return self.hosts * self.n_local


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def local_devices(device: str) -> int:
    """The ranks a host offers for a mesh: its GPUs, or one CPU."""
    return torch.cuda.device_count() if device == "cuda" else 1


def _join(plan: Plan, rank: int, local: int) -> None:
    global _MESH_RANK
    if plan.device == "cuda":
        torch.cuda.set_device(local)
    dist.init_process_group(
        "nccl" if plan.device == "cuda" else "gloo",
        init_method=f"tcp://{plan.addr}", world_size=plan.world, rank=rank)
    _MESH_RANK = rank


def _leave() -> None:
    global _MESH_RANK, _MODEL_GROUP
    if dist.is_initialized():
        dist.destroy_process_group()
    _MESH_RANK = _MODEL_GROUP = None


def _portable(x):
    """`x` for the parent: tensors on the CPU, dataclasses field by field,
    and whatever does not pickle (a loop and its graphs) as None."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: _portable(getattr(x, f.name))
            for f in dataclasses.fields(x) if f.init})
    if isinstance(x, dict):
        return {k: _portable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        vals = [_portable(v) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else type(x)(vals)
    try:
        pickle.dumps(x)
    except Exception:
        return None
    return x


def _rank_main(local: int, plan: Plan, fleet, coord, conn) -> None:
    """A spawned rank: take the call from the parent, join the group, run
    fn(*args), send the result."""
    from aphantasia_torch.parallel import multihost
    fn, args = pickle.loads(conn.recv_bytes())
    rank = plan.host * plan.n_local + local
    if plan.device != "cuda":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // plan.n_local))
    if rank != 0:
        sys.stdout = open(os.devnull, "w")
    multihost._adopt(fleet, coord)
    try:
        _join(plan, rank, local)
        # plain pickle: tensors by value, not as shared-memory handles
        # that die with this process
        conn.send_bytes(pickle.dumps(("ok", _portable(fn(*args)))))
    except BaseException as e:
        traceback.print_exc()
        conn.send_bytes(pickle.dumps(("error", f"{type(e).__name__}: {e}")))
        raise SystemExit(1)
    finally:
        conn.close()
        _leave()


def spawn(fn: Callable, args: tuple, plan: Plan) -> list:
    """Run fn(*args) on each of the plan's local ranks, one spawned
    process each; returns their results, by local rank.  `fn` must be a
    module-level function of a module that the child can import.  A rank
    that fails (an exception, or an exit without a result) raises here,
    and every child still running is stopped."""
    from aphantasia_torch.parallel import multihost
    ctx = multiprocessing.get_context("spawn")
    procs, conns = [], []
    fleet, coord = multihost.fleet_info(), multihost.coordinator()
    try:
        for local in range(plan.n_local):
            mine, theirs = ctx.Pipe()
            # not daemonic: rank 0's frame writer starts encoder processes
            # of its own, which a daemonic process may not; every way out
            # of this function stops the ranks (below)
            p = ctx.Process(target=_rank_main, daemon=False, args=(
                local, plan, fleet, coord, theirs))
            p.start()
            theirs.close()
            procs.append(p)
            conns.append(mine)
        # the call goes through the pipe once every child is starting: a
        # large argument in the Process would hold each start until its
        # child had read it, one child after the other
        call = pickle.dumps((fn, args))
        for c in conns:
            c.send_bytes(call)
        results = [None] * plan.n_local
        pending = set(range(plan.n_local))
        while pending:
            ready = multiprocessing.connection.wait(
                [conns[i] for i in pending]
                + [procs[i].sentinel for i in pending])
            for i in sorted(pending):
                r = plan.host * plan.n_local + i
                if conns[i] in ready or conns[i].poll():
                    try:
                        status, value = pickle.loads(conns[i].recv_bytes())
                    except EOFError:
                        status, value = "error", "no result"
                    if status != "ok":
                        raise RuntimeError(f"mesh rank {r} failed: {value}")
                    results[i] = value
                    pending.discard(i)
                elif procs[i].sentinel in ready:
                    raise RuntimeError(f"mesh rank {r} exited with code "
                                       f"{procs[i].exitcode} and no result")
        for i, p in enumerate(procs):
            p.join()
            if p.exitcode != 0:
                raise RuntimeError(f"mesh rank {plan.host * plan.n_local + i}"
                                   f" exited with code {p.exitcode}")
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
        for c in conns:
            c.close()


def launch(fn: Callable, args: tuple, plan: Plan) -> Any:
    """fn(*args) on every rank of the plan; returns local rank 0's result.
    A mesh of one rank in all runs in this process (its group is made and
    destroyed around the call); otherwise the local ranks are spawned."""
    if plan.world == 1:
        _join(plan, 0, 0)
        try:
            return fn(*args)
        finally:
            _leave()
    return spawn(fn, args, plan)[0]
