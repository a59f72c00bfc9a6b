"""One optimization whose data axis spans hosts (counterpart of
aphantasia_tpu.parallel.dcn).

The data axis runs over every rank of every host, hosts outer: global
rank = host * n_local + local rank, so a host's ranks are neighbours on
the axis.  Each host process spawns one rank per local device (its GPUs;
on the CPU `n_local` is an argument) and the ranks form one group; only
the encodings' gather and the generator's gradient sum cross hosts.  The
hosts agree on the group over the fleet's coordination group
(`multihost.init_fleet` with a coordinator): host 0 picks the group's
port, and every host must bring the same number of ranks, else it raises
(the JAX package keeps the first `n_local` devices of each host instead).

Surfaces
--------
* `plan_dcn(n_local, device)` on each host process and `make_mesh_dcn()`
  on each rank; `cli/common.py:setup_mesh('dcn')` routes here, so every
  CLI runs a host-spanning optimization with
  `--fleet R/W@coord:port --mesh dcn`.
* `python -m aphantasia_torch.parallel.dcn RANK WORLD COORD NLOCAL OUT
  [mode] [--device cpu|cuda]`: one host of the witness.  It joins the
  fleet (COORD 'none' for WORLD 1), runs one deterministic tiny train
  step over the global data axis on NLOCAL ranks, and writes a JSON
  record with the loss and digest.  Mode 'spatial' runs one sharded-canvas
  step (parallel/spatial.py) over a ('data', 'spatial') mesh of the same
  ranks (`make_mesh_dcn_spatial`): data = the hosts, spatial = a host's
  ranks, so the FFT transpose stays within a host and the gradient sum
  crosses hosts; one host splits its ranks into data 2, as the JAX
  witness's one-process anchor does.
"""
from __future__ import annotations

import json
import sys

import torch
import torch.distributed as dist

from aphantasia_torch.parallel import multihost
from aphantasia_torch.parallel.mesh import (Plan, _grid_mesh, free_port,
                                            launch, local_devices, make_mesh)


def plan_dcn(n_local: int | None = None, device: str = "cuda") -> Plan:
    """This host's share of the host-spanning data axis: `n_local` ranks
    (default: its devices), hosts as the fleet says.  With more than one
    host the fleet must have a coordinator; the hosts exchange their rank
    counts over it (uneven counts raise) and host 0's choice of port.
    One host uses the coordinator's address, or a free local port."""
    n_local = local_devices(device) if n_local is None else int(n_local)
    host, hosts = multihost.fleet_info()
    coord = multihost.coordinator()
    if hosts == 1:
        return Plan(n_local, coord or f"127.0.0.1:{free_port()}", device)
    if coord is None or not dist.is_initialized():
        raise ValueError("a data axis over several hosts needs the fleet's "
                         "coordinator: --fleet R/W@HOST:PORT")
    counts = [None] * hosts
    dist.all_gather_object(counts, n_local)
    if len(set(counts)) > 1:
        raise ValueError(f"uneven hosts: ranks per host {counts}; every "
                         "host must bring the same number")
    port = [free_port() if host == 0 else None]
    dist.broadcast_object_list(port, src=0)
    return Plan(n_local, f"{coord.rsplit(':', 1)[0]}:{port[0]}", device,
                hosts, host)


def make_mesh_dcn():
    """The global 1-D data mesh of a rank of a `plan_dcn` launch (its
    group is the launch's, hosts outer)."""
    return make_mesh(axes=("data",))


def make_mesh_dcn_spatial(data: int | None = None):
    """The ('data', 'spatial') mesh of a rank of a `plan_dcn` launch: one
    data row a host (hosts outer), its ranks the spatial axis.  With one
    host, `data` splits its ranks into that many rows (the anchor of the
    JAX witness); with several, `data` must be the host count."""
    hosts = multihost.fleet_info()[1]
    world = dist.get_world_size()
    if hosts == 1 and data and data > 1:
        rows = data
    elif data and data != hosts:
        raise ValueError(f"data={data} != hosts={hosts}")
    else:
        rows = hosts
    if world % rows:
        raise ValueError(f"{world} ranks do not split into {rows} data rows")
    return _grid_mesh(rows, 1, ("data", "spatial"), world // rows)


def _tiny():
    from aphantasia_torch.models.clip.model import CLIPConfig
    return CLIPConfig("dcn-witness", 32, 32, 2, 32, 16, context_length=16,
                      vocab_size=256, transformer_width=32,
                      transformer_heads=2, transformer_layers=2,
                      vision_heads_override=2)


def witness_step(mesh, inputs: dict | None = None):
    """One deterministic tiny train step over `mesh`'s data axis (any host
    count), as the JAX witness runs it: the tiny CLIP, a 48x48 spectrum,
    max(2n, 8) cutouts, the `fast` pipeline, adam_custom at 0.05.
    Returns (loss, digest), digest = sum |params| after the update, which
    passes through the same gradient sum as the training step.

    `inputs` replaces the seeded start: a dict of "clip" (a numpy tree in
    the JAX layout), "params" (the spectrum), "embs" ([1, 32]) and
    "draws" (the step's StepDraws)."""
    from aphantasia_torch.convert import clip_params_from_numpy
    from aphantasia_torch.models.clip.model import clip_init
    from aphantasia_torch.ops.optim import build_optimizer
    from aphantasia_torch.ops.sampler import CutoutSampler
    from aphantasia_torch.params.fft import FFTParameterizer
    from aphantasia_torch.step import (StepSettings, build_draw_fn,
                                       build_train_step, to_device)
    cfg = _tiny()
    dev = mesh.device
    samples = max(2 * mesh.shape["data"], 8)
    par = FFTParameterizer((48, 48), decay_power=1.5, colors=1.8)
    sampler = CutoutSampler((48, 48), samples, cfg.image_resolution,
                            align="uniform", macro=0.4)
    settings = StepSettings(sim="mix", transform="fast", total_steps=10)
    optimizer = build_optimizer("adam_custom", 0.05)
    step = build_train_step(par, sampler, cfg, settings, optimizer,
                            mesh=mesh)

    def seeded(seed):
        return torch.Generator(device=dev).manual_seed(seed)
    if inputs is None:
        clip = clip_init(seeded(0), cfg)
        params = par.init(seeded(1))
        embs = torch.randn((1, cfg.embed_dim), generator=seeded(2),
                           device=dev)
        draws = build_draw_fn(sampler, settings, tuple(params.shape))(
            seeded(3))
    else:
        clip = clip_params_from_numpy(inputs["clip"], dev)
        params = torch.as_tensor(inputs["params"])
        embs = torch.as_tensor(inputs["embs"])
        draws = inputs["draws"]
    params = params.to(dev).contiguous()
    prompts = ((embs.to(dev), torch.ones((1,), device=dev), -1.0),)
    prev = torch.zeros((samples, cfg.embed_dim), device=dev)
    params, _, _, loss = step(params, optimizer.init(params), prev, clip,
                              None, None, prompts, to_device(draws, dev), 0)
    return float(loss), float(params.abs().sum())


def witness_spatial_step(mesh, inputs: dict | None = None):
    """One deterministic sharded-canvas train step over a ('data',
    'spatial') mesh, as the JAX spatial witness runs it: the tiny CLIP, a
    (16 S)x64 spectrum (`SpatialFFT`), max(2 D, 4) cutouts, the `fast`
    pipeline, adam_custom at 0.05.  Returns (loss, digest), digest = sum
    |params| over the whole spectrum after the update.  `inputs` as
    `witness_step` takes them, "params" the canonical spectrum."""
    from aphantasia_torch.convert import clip_params_from_numpy
    from aphantasia_torch.models.clip.model import clip_init
    from aphantasia_torch.ops.optim import build_optimizer
    from aphantasia_torch.ops.sampler import CutoutSampler
    from aphantasia_torch.parallel.spatial import (SpatialFFT,
                                                   build_spatial_train_step)
    from aphantasia_torch.step import StepSettings, build_draw_fn, to_device
    cfg = _tiny()
    dev = mesh.device
    size = (16 * mesh.size("spatial"), 64)
    samples = max(2 * mesh.size("data"), 4)
    spar = SpatialFFT(size, 1.5, 1.8, mesh)
    sampler = CutoutSampler(size, samples, cfg.image_resolution,
                            align="uniform", macro=0.4)
    settings = StepSettings(sim="mix", transform="fast", total_steps=10)
    optimizer = build_optimizer("adam_custom", 0.05)
    step = build_spatial_train_step(spar, sampler, cfg, settings, optimizer)

    def seeded(seed):
        return torch.Generator(device=dev).manual_seed(seed)
    if inputs is None:
        clip = clip_init(seeded(0), cfg)
        params = spar.init(seeded(1), sd=0.01)
        embs = torch.randn((1, cfg.embed_dim), generator=seeded(2),
                           device=dev)
        draws = build_draw_fn(sampler, settings, spar.draw_shape)(seeded(3))
    else:
        clip = clip_params_from_numpy(inputs["clip"], dev)
        params = spar.shard(torch.as_tensor(inputs["params"]).to(dev))
        embs = torch.as_tensor(inputs["embs"])
        draws = inputs["draws"]
    prompts = ((embs.to(dev), torch.ones((1,), device=dev), -1.0),)
    prev = torch.zeros((samples, cfg.embed_dim), device=dev)
    params, _, _, loss = step(params, optimizer.init(params), prev, clip,
                              None, None, prompts, to_device(draws, dev), 0)
    digest = params.abs().sum().reshape(1)
    dist.all_reduce(digest, group=mesh.spatial_group)
    return float(loss), float(digest[0])


def _witness_rank():
    return witness_step(make_mesh_dcn())


def _witness_spatial_rank(world: int):
    return witness_spatial_step(
        make_mesh_dcn_spatial(2 if world == 1 else None))


def main(argv=None):
    """One host of the witness (module docstring)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    rank, world, coord, n_local, out_path = (
        int(argv[0]), int(argv[1]), argv[2], int(argv[3]), argv[4])
    mode = argv[5] if len(argv) > 5 else "data"
    if mode not in ("data", "spatial"):
        raise ValueError(f"unknown witness mode {mode!r}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu")
    spec = f"{rank}/{world}" + (f"@{coord}" if world > 1 else "")
    multihost.init_fleet(spec)
    plan = plan_dcn(n_local, device)
    if mode == "spatial":
        rows = 2 if world == 1 else world
        shape = {"data": rows, "spatial": plan.world // rows}
        loss, digest = launch(_witness_spatial_rank, (world,), plan)
    else:
        shape = {"data": plan.world}
        loss, digest = launch(_witness_rank, (), plan)
    rec = {"rank": rank, "world": world, "n_devices": plan.world,
           "n_local": plan.n_local, "mesh": shape,
           "loss": loss, "digest": digest}
    with open(out_path, "w") as f:
        json.dump(rec, f)
    print(f"dcn witness {rank}/{world}: loss={loss:.6f} "
          f"digest={digest:.4f} over {plan.world} ranks")
    return 0


if __name__ == "__main__":
    sys.exit(main())
