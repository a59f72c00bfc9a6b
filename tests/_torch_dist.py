"""Rank workers of the multi-rank tests (tests/test_torch_mesh.py,
test_torch_dcn.py, test_torch_spatial.py).  The
launcher spawns fresh processes that import the worker's module, so this
module imports neither JAX nor aphantasia_tpu; the tests make every input
with JAX in the pytest process and send it here as numpy arrays and the
port's draw structures."""
import numpy as np
import torch


def _clip(cfg_kw, tree):
    from aphantasia_torch.convert import clip_params_from_numpy
    from aphantasia_torch.models.clip import model as tm
    return tm.CLIPConfig(**cfg_kw), clip_params_from_numpy(tree)


def data_axis_worker(cfg_kw, clip_tree, cases):
    """Each case's free-running train steps on this rank's 1-D data mesh:
    per case the losses, the last encodings and the params after the last
    step, and the rank's cutout rows."""
    from aphantasia_torch import step as tstep
    from aphantasia_torch.convert import (aesthetic_params_from_numpy,
                                          lpips_params_from_numpy)
    from aphantasia_torch.ops import optim as to
    from aphantasia_torch.ops.sampler import CutoutSampler
    from aphantasia_torch.params.fft import FFTParameterizer
    from aphantasia_torch.parallel.mesh import make_mesh
    mesh = make_mesh()
    cfg, clip = _clip(cfg_kw, clip_tree)
    out = []
    for c in cases:
        h, w = c["size"]
        par = FFTParameterizer((h, w), 1.5, 1.8)
        sam = CutoutSampler((h, w), c["samples"], cfg.image_resolution,
                            "uniform", 0.4)
        sett = tstep.StepSettings(sim="mix", clip_dtype=torch.float32,
                                  **c["settings"])
        opt = to.build_optimizer("adam_custom", c["lr"], len(c["draws"]))
        train = tstep.build_train_step(par, sam, cfg, sett, opt, mesh=mesh)
        head = (aesthetic_params_from_numpy(c["head"]) if c.get("head")
                else None)
        bundle = ((lpips_params_from_numpy(c["lpips"]),
                   torch.tensor(c["img_in"])) if c.get("lpips") else None)
        embs, wts = c["prompts"]
        prompts = ((torch.tensor(embs), torch.tensor(wts), -1.0),)
        p = torch.tensor(c["p0"])
        st = opt.init(p)
        prev = torch.zeros((c["samples"], cfg.embed_dim))
        losses = []
        for i, d in enumerate(c["draws"]):
            p, st, prev, loss = train(p, st, prev, clip, head, bundle,
                                      prompts, d, i)
            losses.append(loss.item())
        rows = mesh.rows(c["samples"])
        out.append(dict(losses=losses, enc=prev.numpy(), params=p.numpy(),
                        rows=(rows.start, rows.stop)))
    return out


def model_axis_worker(spec, cases):
    """Each case's image and text encodings and their input gradients on
    this rank of a data x model mesh: the image rows of the rank's data
    coordinate with the gradient of sum(enc * cot) with respect to those
    images, and the text encodings of every prompt with the gradient of
    sum(enc * cot) with respect to the token-embedding table."""
    from aphantasia_torch.models.clip import model as tm
    from aphantasia_torch.parallel.mesh import make_mesh_2d, shard_clip_params
    mesh = make_mesh_2d(*spec)
    out = []
    for c in cases:
        cfg, clip = _clip(c["cfg"], c["clip"])
        clip = shard_clip_params(clip, mesh, cfg)
        rows = mesh.rows(c["images"].shape[0])
        x = torch.tensor(c["images"][rows], requires_grad=True)
        enc = tm.encode_image(clip, cfg, x)
        (gx,) = torch.autograd.grad(enc, x, torch.tensor(c["img_cot"][rows]))
        table = clip["text"]["token_embedding"].requires_grad_(True)
        tenc = tm.encode_text(clip, cfg, torch.tensor(c["tokens"]))
        (gt,) = torch.autograd.grad(tenc, table, torch.tensor(c["txt_cot"]))
        out.append(dict(rows=(rows.start, rows.stop), enc=enc.detach().numpy(),
                        gx=gx.numpy(), tenc=tenc.detach().numpy(),
                        gt=gt.numpy(), coords=dict(mesh.coords)))
    return out


def witness_worker(inputs):
    """The DCN witness step on this rank's data mesh: with the given
    inputs (JAX's) and with the port's own seeded ones."""
    from aphantasia_torch.parallel.dcn import make_mesh_dcn, witness_step
    mesh = make_mesh_dcn()
    return witness_step(mesh, inputs), witness_step(mesh)


# ViT-B/32's geometry (224 px, 32 px patches) cut to one block of width 128
# in each tower, two heads each, so that a model axis of 2 splits them
TINY_MESH_B32 = dict(name="ViT-B/32", embed_dim=32, image_resolution=224,
                     vision_layers=1, vision_width=128, vision_patch_size=32,
                     transformer_width=64, transformer_heads=2,
                     transformer_layers=1)


def tiny_clip_fft(a):
    """clip_fft's run body (`clip_fft._run`) on TINY_MESH_B32 in place of
    ViT-B/32: the body `common.run_cli` gives each mesh rank."""
    from aphantasia_torch.cli import clip_fft
    from aphantasia_torch.models.clip import model as tm
    tm.CLIP_CONFIGS["ViT-B/32"] = tm.CLIPConfig(**TINY_MESH_B32)
    return clip_fft._run(a)


def _tiny_run(module: str, a):
    import importlib
    from aphantasia_torch.models.clip import model as tm
    tm.CLIP_CONFIGS["ViT-B/32"] = tm.CLIPConfig(**TINY_MESH_B32)
    return importlib.import_module(f"aphantasia_torch.cli.{module}")._run(a)


def tiny_illustra(a):
    """illustra's run body on TINY_MESH_B32 (as `tiny_clip_fft`)."""
    return _tiny_run("illustra", a)


def tiny_illustrip(a):
    """illustrip's run body on TINY_MESH_B32 (as `tiny_clip_fft`)."""
    return _tiny_run("illustrip", a)


# ---------------------------------------------------------- spatial canvases

def _canvas(c, mesh):
    from aphantasia_torch.cli.common import spatial_canvas
    return spatial_canvas(c["canvas"], c["size"], mesh, c.get("decay", 1.5),
                          1.8, c.get("wave", "coif2"))


def _shard(spar, params):
    """The rank's shard of canonical numpy params (JAX's start)."""
    from aphantasia_torch.convert import spatial_shard_from_numpy
    return spatial_shard_from_numpy(spar, params)[0]


def _np(x):
    return ([v.detach().numpy() for v in x] if isinstance(x, (list, tuple))
            else x.detach().numpy())


def _amax(x) -> float:
    return float(x.abs().max()) if x.numel() else 0.0


def _pad_max(spar, params) -> float:
    """The largest |value| of this rank's pad entries (the spectrum's
    columns past Wf, the rows past each sharded level's or the image's
    real height)."""
    from aphantasia_torch.parallel.spatial import SpatialFFT
    from aphantasia_torch.parallel.spatial_dwt import SpatialDWT
    if isinstance(spar, SpatialFFT):
        col = spar.idx * spar.wloc + torch.arange(spar.wloc)
        return _amax(params[..., col >= spar.wf, :])
    if isinstance(spar, SpatialDWT):
        out = 0.0
        for j, p in enumerate(params):
            if spar._sharded(j):
                m = p.shape[3]
                row = spar.idx * m + torch.arange(m)
                bad = row >= spar.real_shapes[j][3]
                out = max(out, _amax(p[:, :, :, bad]))
        return out
    row = spar.idx * spar.hloc + torch.arange(spar.hloc)
    return _amax(params[:, :, row >= spar.size[0]])


def _sampler(c, count):
    from aphantasia_torch.ops.sampler import CutoutSampler
    return CutoutSampler(tuple(c["size"]), count, 32, "uniform",
                         c.get("macro", 0.0))


def _settings(c):
    from aphantasia_torch import step as tstep
    return tstep.StepSettings(clip_dtype=torch.float32, **c["settings"])


def _prompts(pr):
    embs, wts = pr
    return ((torch.tensor(embs), torch.tensor(wts), -1.0),)


def _spatial_cut(c, mesh):
    """Cuts, sharpness, anchors, render and the gradient of sum(cuts *
    co) + 3 sharp + sum(anchors * weights) from canonical params."""
    from aphantasia_torch.ops.optim import leaves
    from aphantasia_torch.ops.sampler import Boxes
    spar = _canvas(c, mesh)
    sam = _sampler(c, c["co"].shape[0])
    wy, wx = sam.weight_matrices(Boxes(*(torch.tensor(b)
                                         for b in c["boxes"])))
    p = _shard(spar, c["params"])
    ps = leaves(p)
    for q in ps:
        q.requires_grad_(True)
    shift = (None if c.get("shift") is None
             else spar.local_shift(torch.tensor(c["shift"])))
    rgb = spar.rgb_rows(p, shift)
    cuts = spar.cut(rgb, spar.pad_wy(wy), wx, torch.float32)
    loss = (cuts * torch.tensor(c["co"])).sum()
    out = {"cuts": cuts.detach().numpy()}
    if c.get("sharp"):
        sh = spar.sharp(rgb)
        loss = loss + 3.0 * sh
        out["sharp"] = float(sh.detach())
    if c.get("anchors"):
        m, s = spar.anchors(rgb)
        aw = torch.tensor(c["anchor_w"])
        loss = loss + (m * aw[0]).sum() + (s * aw[1]).sum()
        out["anchors"] = (m.detach().numpy(), s.detach().numpy())
    grads = list(torch.autograd.grad(loss, ps))
    spar.reduce_grads(grads)
    for q in ps:
        q.requires_grad_(False)
    g = grads if isinstance(p, list) else grads[0]
    out["grad"] = _np(spar.full(g))
    out["grad_pad"] = _pad_max(spar, g)
    out["render"] = spar.render(p).numpy()
    out["h_container"] = spar.h_container
    if hasattr(spar, "k_fine"):
        out["k_fine"] = spar.k_fine
    return out


def _spatial_warp(c, mesh):
    """The frame warp (with a depth map) and the depth preview."""
    from aphantasia_torch.parallel import spatial as sp
    from aphantasia_torch.models.clip import model as tm
    cfg = tm.CLIPConfig(**c["cfg"])
    spar = _canvas(c, mesh)
    fs = sp.build_spatial_frame_step(
        spar, _sampler(c, 2), cfg, _settings(c), None, 1, False,
        deptha=object(), depth=c["depth"])
    p = _shard(spar, c["params"])
    out = sp.spatial_frame_warp(fs, spar, p, torch.tensor(c["motion"]),
                                torch.tensor(c["dmap"]))
    return {"warped": _np(spar.full(out)),
            "preview": sp.spatial_depth_preview(spar, p).numpy()}


def _spatial_steps(c, mesh):
    """Free-running sharded train steps with the case's terms."""
    from aphantasia_torch.convert import (aesthetic_params_from_numpy,
                                          lpips_params_from_numpy)
    from aphantasia_torch.ops import optim as to
    from aphantasia_torch.parallel.spatial import build_spatial_train_step
    cfg, clip = _clip(c["cfg"], c["clip"])
    spar = _canvas(c, mesh)
    opt = to.build_optimizer("adam_custom", c["lr"])
    train = build_spatial_train_step(spar, _sampler(c, c["samples"]), cfg,
                                     _settings(c), opt)
    head = (aesthetic_params_from_numpy(c["head"]) if c.get("head")
            else None)
    bundle = ((lpips_params_from_numpy(c["lpips"]),
               torch.tensor(c["img_in"])) if c.get("lpips") else None)
    p = _shard(spar, c["params"])
    st, prev, losses = opt.init(p), torch.zeros((c["samples"], 32)), []
    for i, d in enumerate(c["draws"]):
        p, st, prev, loss = train(p, st, prev, clip, head, bundle,
                                  _prompts(c["prompts"]), d, i)
        losses.append(loss.item())
    return {"losses": losses, "enc": prev.numpy(),
            "params": _np(spar.full(p)), "pad_max": _pad_max(spar, p),
            "coords": dict(mesh.coords)}


def _spatial_loop(c, mesh):
    """The chunked frame loop with `dual=` (a second tower every
    `dm_every`-th step)."""
    from aphantasia_torch.ops import optim as to
    from aphantasia_torch.parallel.spatial import (
        build_spatial_train_loop_frames)
    cfg, clip = _clip(c["cfg"], c["clip"])
    cfg2, clip2 = _clip(c["cfg2"], c["clip2"])
    spar = _canvas(c, mesh)
    opt = to.build_optimizer("adam_custom", c["lr"])
    loop = build_spatial_train_loop_frames(
        spar, _sampler(c, c["samples"]), cfg, _settings(c), opt, 1,
        len(c["draws"]), dual=(cfg2, c["dm_every"]))
    p = _shard(spar, c["params"])
    p, _, prev, frames, losses = loop(
        p, opt.init(p), torch.zeros((c["samples"], 32)), clip, None, None,
        _prompts(c["prompts"]), clip2, None, _prompts(c["prompts2"]),
        lambda g: c["draws"][g], 0)
    return {"losses": losses.tolist(), "frames": frames.numpy(),
            "params": _np(spar.full(p)), "pad_max": _pad_max(spar, p)}


def _spatial_frame(c, mesh):
    """One illustrip frame (`build_spatial_frame_step`), with depth when
    the case has a depth map."""
    from aphantasia_torch.ops import optim as to
    from aphantasia_torch.parallel.spatial import build_spatial_frame_step
    cfg, clip = _clip(c["cfg"], c["clip"])
    spar = _canvas(c, mesh)
    opt = to.build_optimizer("adam_custom", c["lr"])
    depth = c.get("dmap") is not None
    fs = build_spatial_frame_step(
        spar, _sampler(c, c["samples"]), cfg, _settings(c), opt,
        len(c["draws"]), False, c["contrast"],
        deptha=object() if depth else None, depth=1.0 if depth else 0.0)
    p = _shard(spar, c["params"])
    args = (p, opt.init(p), torch.zeros((c["samples"], 32)), clip, None,
            _prompts(c["prompts"]), c["draws"], 1, tuple(c["motion"]))
    out = fs(*args, torch.tensor(c["dmap"])) if depth else fs(*args)
    res = {"losses": out[4].tolist(), "frame": out[3].numpy(),
           "params": _np(spar.full(out[0])), "pad_max": _pad_max(spar, out[0])}
    if depth:
        res["preview"] = out[5].numpy()
    return res


def spatial_worker(cases):
    """Each case on this rank's ('data'[, 'model'], 'spatial') mesh
    (`make_mesh_spatial(case["spatial"], case.get("mesh"))`), by its
    "kind": cut, warp, steps, loop, frame or witness (the spatial DCN
    witness step on JAX's inputs)."""
    from aphantasia_torch.parallel.mesh import make_mesh_spatial
    kinds = {"cut": _spatial_cut, "warp": _spatial_warp,
             "steps": _spatial_steps, "loop": _spatial_loop,
             "frame": _spatial_frame}
    out = []
    for c in cases:
        if c["kind"] == "witness":
            from aphantasia_torch.parallel.dcn import (make_mesh_dcn_spatial,
                                                       witness_spatial_step)
            out.append(witness_spatial_step(make_mesh_dcn_spatial(2),
                                            c["inputs"]))
            continue
        mesh = make_mesh_spatial(c["spatial"], c.get("mesh"))
        out.append(kinds[c["kind"]](c, mesh))
    return out


def failing_worker(bad_rank):
    """Rank `bad_rank` raises while the others wait in a collective."""
    import torch.distributed as dist
    if dist.get_rank() == bad_rank:
        raise ValueError("this rank fails on purpose")
    dist.barrier()
    return np.zeros(1)
