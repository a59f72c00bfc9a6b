"""A cell's optimisation followed step by step by the plain reference:
the loss of a step (decode, cutouts, `fast` augmentation, image tower,
the prompts' `mix` similarity, for RGB video the brightness and contrast
pins), Adam with b1 = 0 (the CLIs' `adam_custom`: optax's adam with
b1 = 0, b2 = 0.999, eps 1e-8), and for video the frame's motion and the
optimiser's fresh state before its step."""
from __future__ import annotations

import math

import torch

from . import clip as C
from . import image as I
from . import vqgan as V
from .precision import REFERENCE


def sim_mix(v1, v2):
    """mean cosine similarity - 0.25 mean spherical distance."""
    n1 = torch.clamp(torch.linalg.norm(v1, dim=-1), min=1e-8)
    n2 = torch.clamp(torch.linalg.norm(v2, dim=-1), min=1e-8)
    cos = (v1 * v2).sum(-1) / (n1 * n2)
    u1 = v1 / torch.clamp(torch.linalg.norm(v1, dim=-1, keepdim=True),
                          min=1e-12)
    u2 = v2 / torch.clamp(torch.linalg.norm(v2, dim=-1, keepdim=True),
                          min=1e-12)
    d = torch.linalg.norm(u1 - u2, dim=-1)
    return cos.mean() - 0.25 * (2.0 * torch.arcsin(d / 2.0) ** 2).mean()


def _first_half(ts) -> tuple:
    """Each tensor's first half repeated over its whole length."""
    out = []
    for t in ts:
        n = t.shape[0]
        out.append(torch.cat([t[:n // 2], t[:n - n // 2]]))
    return tuple(out)


class Problem:
    """One cell's step as the reference computes it.  `settings` is the
    traffic file's `settings`; `paths` the weight files the run wrote.
    `half` is a fault that leaves out the second half of the batch, the
    means then over the first half: "cuts" puts the first half's cutouts
    in the second half's places; "loss" embeds every cutout and takes the
    similarity's means over the first half's embeddings alone.  `enc`
    holds the last loss's cutout embeddings."""

    def __init__(self, config: dict, settings: dict, paths: dict, device,
                 prec=REFERENCE, half: str | None = None):
        self.config, self.s, self.prec = config, settings, prec
        self.device, self.half = device, half
        self.clip = C.load_state_dict(paths["clip"], device)
        self.vq = (C.load_state_dict(paths["vqgan"], device)
                   if settings["kind"] == "vqgan" else None)

    def prompt(self, line: str):
        return C.prompt_embeddings(self.clip, self.config["text"], line,
                                   self.prec)

    def init(self, seed: int) -> torch.Tensor:
        """The start state the CLI draws first from its generator seeded
        with `seed` on the device: a spectrum, a latent or pixels."""
        s = self.s
        h, w = s["size"]
        gen = torch.Generator(device=self.device).manual_seed(seed)
        if s["kind"] == "fft":
            shape = (1, 3, h, w // 2 + 1, 2)
        elif s["kind"] == "vqgan":
            f = 2 ** (len(self.config["vqgan"]["ch_mult"]) - 1)
            shape = (1, self.config["vqgan"]["z_channels"], h // f, w // f)
        else:
            shape = (1, 3, h, w)
        return s["init_sd"] * torch.randn(shape, generator=gen,
                                          device=self.device)

    def image(self, params, contrast=1.0):
        s = self.s
        if s["kind"] == "fft":
            return I.fft_image(params, s["size"], s["decay"], s["colors"],
                               contrast, self.prec)
        if s["kind"] == "vqgan":
            return V.decode(self.vq, self.config["vqgan"], params, self.prec)
        return I.pixel_image(params, s["colors"], contrast, self.prec)

    def render(self, params) -> torch.Tensor:
        with torch.no_grad():
            return I.render(self.image(params, self.s.get("contrast", 1.0)))

    def loss(self, params, draws, groups, rows=None):
        """`draws` = ((csize, offx, offy), (endpoints, rot_idx,
        erasing)); `groups` = [(embs [K, D], wts [K], coeff)]; `rows`, a
        slice, takes the similarity's means over those cutouts alone."""
        s = self.s
        boxes, aug = draws
        if self.half == "cuts":
            boxes, aug = _first_half(boxes), (
                _first_half(aug[:2]) + (_first_half(aug[2]),))
        img = self.image(params)
        cuts = I.cut(img, boxes, s["size"], s["padded"], s["modsize"],
                     self.prec)
        cuts = I.augment_fast(aug, cuts, self.prec)
        enc = C.encode_image(self.clip, self.config["vision"], cuts,
                             self.prec)
        self.enc = enc.detach()
        if self.half == "loss":
            rows = slice(0, enc.shape[0] // 2)
        if rows is not None:
            enc = enc[rows]
        loss = torch.zeros((), device=params.device)
        for embs, wts, coeff in groups:
            g = torch.zeros((), device=params.device)
            for j in range(embs.shape[0]):
                g = g + wts[j] * sim_mix(embs[j:j + 1], enc)
            loss = loss + coeff * g
        if s.get("anchors"):
            loss = loss + torch.mean(torch.abs(img.mean(dim=(2, 3)) - 0.45))
            loss = loss + torch.mean(torch.abs(img.std(dim=(2, 3)) - 0.17))
        return loss


def probe(problem: Problem, p, draws, groups, motion=None,
          rows=None) -> tuple:
    """(loss, gradient, cutout embeddings) of one step at state `p`, a
    video frame's motion applied first; `rows` as in `Problem.loss`."""
    if motion is not None:
        with torch.no_grad():
            p = problem.prec.hi(I.frame_motion(p, *motion))
    p = p.detach().clone().requires_grad_(True)
    loss = problem.loss(p, draws, groups, rows)
    (g,) = torch.autograd.grad(loss, p)
    return float(loss.detach()), g, problem.enc


def follow(problem: Problem, p0, draws, groups, motion=None, steps=3):
    """The reference's trajectory from `p0` over `steps` steps (each its
    draws and prompt groups; with `motion`, a video frame each: the
    motion, a fresh Adam state, the step).  Returns each step's loss,
    gradient, cutout embeddings, the state after it, and its frame."""
    lr = problem.s["lr"]
    p = p0.clone()
    nu = torch.zeros_like(p)
    count = 0
    out = {"losses": [], "grads": [], "encs": [], "states": [],
           "frames": []}
    for k in range(steps):
        if motion is not None:
            with torch.no_grad():
                p = problem.prec.hi(I.frame_motion(p, *motion[k]))
            nu.zero_()
            count = 0
        loss, g, enc = probe(problem, p, draws[k], groups[k])
        with torch.no_grad():
            count += 1
            nu = 0.999 * nu + 0.001 * g * g
            c2 = 1.0 - math.pow(0.999, count)
            p = p - lr * g / (torch.sqrt(nu / c2) + 1e-8)
        out["losses"].append(loss)
        out["grads"].append(g)
        out["encs"].append(enc)
        out["states"].append(p.clone())
        out["frames"].append(problem.render(p))
    return out
