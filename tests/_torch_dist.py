"""Rank workers of the multi-rank tests (tests/test_torch_mesh.py,
test_torch_dcn.py).  The
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


def failing_worker(bad_rank):
    """Rank `bad_rank` raises while the others wait in a collective."""
    import torch.distributed as dist
    if dist.get_rank() == bad_rank:
        raise ValueError("this rank fails on purpose")
    dist.barrier()
    return np.zeros(1)
