"""`--dualmod` in the port: `build_train_loop_frames(dual=(cfg2, dm_every))`
against the JAX package's dual loop, and the per-pattern groups against
the port's own eager steps and the CLI's per-step loop, on the CPU.

Global step g runs the second tower when g % dm_every == 0 and g > 0.
With opt_step 2 and dm_every 3 the frame groups of 8 steps take the
patterns (tower 1, tower 1), (1, 2), (1, 1), (2, 1): three patterns, of
which the loop builds one group each.  Tolerances against JAX as
tests/test_torch_loop.py holds the single-tower loop (losses 1e-4,
params 2e-3 / 5e-2 of the learning rate, prev_enc 1e-3, frames within
one uint8 level); against the port's eager steps, bit for bit.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import torch

from aphantasia_tpu.models.clip import model as jm
from aphantasia_tpu.parallel import step as jstep
from aphantasia_torch import step as tstep
from aphantasia_torch.cli import clip_fft
from aphantasia_torch.convert import clip_params_from_numpy
from aphantasia_torch.models.clip import model as tm
from aphantasia_torch.ops import optim as to

from _torch_parity import jax_step_draws, tree_np
from test_torch_loop import KW, LR, _close, _leaves, _start, _state
from test_torch_step import CFG_KW, _setup

OPT_STEP, DM, NF, CALLS = 2, 3, 2, 2
CFG2_KW = dict(CFG_KW, name="tiny2", vision_patch_size=16, vision_width=64)


def _second_tower():
    """A second tiny tower (patch 16: 5 tokens) with the first's embedding
    width, its prompts and head-free constants, on both sides."""
    jcfg2, tcfg2 = jm.CLIPConfig(**CFG2_KW), tm.CLIPConfig(**CFG2_KW)
    jclip2 = jm.clip_init(jax.random.PRNGKey(5), jcfg2)
    embs = np.random.RandomState(8).randn(3, 32).astype(np.float32)
    wts = np.asarray([1.0, 0.5, 0.25], np.float32)
    return dict(
        jcfg2=jcfg2, tcfg2=tcfg2, jclip2=jclip2,
        tclip2=clip_params_from_numpy(tree_np(jclip2)),
        jprompts2=((jnp.asarray(embs), jnp.asarray(wts),
                    jnp.float32(-1.0)),),
        tprompts2=((torch.tensor(embs), torch.tensor(wts), -1.0),))


def test_dual_frame_loop_matches_jax():
    """8 steps, 2 frame groups a call, 2 calls, with noise, expand and
    --prog; each global step gets JAX's own draws (fold_in(key, gstep)),
    whichever tower takes it."""
    c, d = _setup(KW), _second_tower()
    jopt, topt, jstate, tstate = _start(c, OPT_STEP * NF * CALLS)
    jloop = jstep.build_train_loop_frames(
        c["jpar"], c["jsam"], c["jcfg"], c["jset"], jopt, OPT_STEP, NF,
        contrast=1.1, dual=(d["jcfg2"], DM))
    tloop = tstep.build_train_loop_frames(
        c["tpar"], c["tsam"], c["tcfg"], c["tset"], topt, OPT_STEP, NF,
        contrast=1.1, dual=(d["tcfg2"], DM))
    key = jax.random.PRNGKey(4)

    def draws(gstep):
        return jax_step_draws(jax.random.fold_in(key, gstep), c["jsam"],
                              c["jset"], c["p0"].shape)
    for call in range(CALLS):
        *jstate, jframes, jl = jloop(
            *jstate, c["jclip"], None, None, c["jprompts"], d["jclip2"],
            None, d["jprompts2"], key, jnp.int32(call * NF))
        *tstate, tframes, tl = tloop(
            *tstate, c["tclip"], None, None, c["tprompts"], d["tclip2"],
            None, d["tprompts2"], draws, call * NF)
        diff = np.abs(tframes.numpy().astype(int) - np.asarray(jframes))
        assert diff.max() <= 1, diff.max()
        _close(c, jstate, tstate, jl, tl)
    assert sorted(tloop.groups) == [(0, 0), (0, 1), (1, 0)]
    assert int(tstate[1].count) == OPT_STEP * NF * CALLS


def test_dual_groups_equal_the_eager_steps():
    """The dual loop in one call of four groups and in four calls of one,
    against the steps one by one (tower 2 where g % 3 == 0 and g > 0) with
    a render after each group's first step, all from one generator's
    draws in step order: params, optimizer state, prev_enc, losses and
    frames bit for bit; each pattern's first group is recorded as its
    eager run (`first_runs`)."""
    c, d = _setup(dict(KW, enforce=0.3)), _second_tower()
    opt = to.build_optimizer("adam_custom", LR, 8, prog=True)
    draw = tstep.build_draw_fn(c["tsam"], c["tset"], c["p0"].shape)
    steps = [tstep.build_train_step(c["tpar"], c["tsam"], cfg, c["tset"],
                                    opt) for cfg in (c["tcfg"], d["tcfg2"])]
    consts = [(c["tclip"], None, None, c["tprompts"]),
              (d["tclip2"], None, None, d["tprompts2"])]
    render = tstep.build_render(c["tpar"])
    gen = torch.Generator().manual_seed(7)
    p, st, prev = _state(c, opt)
    losses, frames = [], []
    for g in range(4 * OPT_STEP):
        tower = int(g % DM == 0 and g > 0)
        p, st, prev, loss = steps[tower](p, st, prev, *consts[tower],
                                         draw(gen), g // OPT_STEP)
        losses.append(loss)
        if g % OPT_STEP == 0:
            frames.append(render(p, contrast=1.1))
    want = _leaves(p, st, prev) + [torch.stack(losses), torch.stack(frames)]
    for nf in (4, 1):
        loop = tstep.build_train_loop_frames(
            c["tpar"], c["tsam"], c["tcfg"], c["tset"], opt, OPT_STEP, nf,
            contrast=1.1, dual=(d["tcfg2"], DM))
        gen = torch.Generator().manual_seed(7)
        state = _state(c, opt)
        got_f, got_l, firsts = [], [], []
        for call in range(4 // nf):
            *state, f, dl = loop(*state, *consts[0], d["tclip2"], None,
                                 d["tprompts2"], lambda g: draw(gen),
                                 call * nf)
            got_f.append(f.clone())
            got_l.append(dl.clone())
            firsts += [call * nf + j for j in loop.first_runs]
        assert firsts == [0, 1, 3]
        got = _leaves(*state) + [torch.cat(got_l), torch.cat(got_f)]
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_cli_dualmod_chunked_and_per_step_paths_agree(tmp_path, monkeypatch):
    """`--dualmod 2` on the chunked path and on the per-step loop (forced
    by a step count opt_step does not divide): the same losses, bit for
    bit, and the `-dm2` out-name; the second tower is ViT-B/16."""
    seen = []
    real = clip_fft.build_train_loop_frames

    def spy(*args, **kwargs):
        seen.append(kwargs["dual"][0].name)
        return real(*args, **kwargs)
    monkeypatch.setattr(clip_fft, "build_train_loop_frames", spy)

    def run(extra, out):
        return clip_fft.run(clip_fft.get_args(
            ["-t", "x", "--size", "64-48", "--samples", "8", "-nv",
             "--dualmod", "2", "--device", "cpu",
             "--out_dir", str(tmp_path / out)] + extra))
    chunked = run(["--steps", "3", "--opt_step", "1"], "a")
    assert seen == ["ViT-B/16"]
    monkeypatch.setattr(clip_fft, "build_train_loop_frames", None)
    per_step = run(["--steps", "3", "--opt_step", "4"], "b")
    assert chunked.out_name == per_step.out_name == "x-dm2"
    assert chunked.samples == 1
    assert chunked.losses == per_step.losses
    assert os.path.isfile(os.path.join(tmp_path, "a", "x-dm2",
                                       "config.txt"))
