"""The port's step loops (aphantasia_torch/step.py: build_train_loop,
build_train_loop_frames, frames_per_dispatch) against the JAX package's, the
optimizer's step count on the device, the host tables cached per device, and
the CLI's chunked path with --profile, on the CPU.

Float32.  Tolerances as tests/test_torch_step.py::test_three_steps_match_jax
holds three free-running steps: params 2e-3 of the base learning rate in the
mean and 5e-2 of it at the worst element (Adam with b1 = 0 turns float32
noise in a near-zero gradient element into a full update of that element),
losses 1e-4 relative, prev_enc 1e-3; frames within one uint8 level (a
float32 difference can move a pixel across a rounding boundary).  The loops
against the port's own eager steps: bit for bit.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from aphantasia_tpu.ops import optim as jo
from aphantasia_tpu.parallel import step as jstep
from aphantasia_torch import step as tstep
from aphantasia_torch.cli import clip_fft
from aphantasia_torch.convert import fft_params_from_numpy
from aphantasia_torch.ops import optim as to
from aphantasia_torch.ops.sampler import CutoutSampler

from _torch_parity import jax_step_draws
from test_torch_step import _setup

LR = 0.05
KW = dict(transform="none", noise=0.1, expand=0.5)


def _start(c, steps):
    """Both sides' optimizers (adam_custom with --prog over `steps`) and
    start states."""
    s = c["jsam"].count
    jopt = jo.build_optimizer("adam_custom", LR, steps, prog=True)
    topt = to.build_optimizer("adam_custom", LR, steps, prog=True)
    jp = jnp.asarray(c["p0"])
    tp = fft_params_from_numpy(c["p0"])
    return (jopt, topt, (jp, jopt.init(jp), jnp.zeros((s, 32))),
            (tp, topt.init(tp), torch.zeros((s, 32))))


def _close(c, jstate, tstate, jl, tl):
    jp, _, jprev = jstate
    tp, ts, tprev = tstate
    np.testing.assert_allclose(np.asarray(tl), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    err = np.abs(tp.numpy() - np.asarray(jp))
    assert err.mean() <= 2e-3 * LR, err.mean()
    assert err.max() <= 5e-2 * LR, err.max()
    np.testing.assert_allclose(tprev.numpy(), np.asarray(jprev), atol=1e-3)


@pytest.mark.parametrize("step_index", ["frame", "global"])
def test_frame_loop_matches_jax(step_index):
    """opt_step 2, two frame groups a dispatch, two dispatches, with noise,
    expand and --prog; each global step gets JAX's own draws
    (fold_in(key, gstep), as the JAX loop folds them)."""
    opt_step, nf, calls = 2, 2, 2
    c = _setup(KW)
    jopt, topt, jstate, tstate = _start(c, opt_step * nf * calls)
    jloop = jstep.build_train_loop_frames(
        c["jpar"], c["jsam"], c["jcfg"], c["jset"], jopt, opt_step, nf,
        contrast=1.1, step_index=step_index)
    tloop = tstep.build_train_loop_frames(
        c["tpar"], c["tsam"], c["tcfg"], c["tset"], topt, opt_step, nf,
        contrast=1.1, step_index=step_index)
    key = jax.random.PRNGKey(4)

    def draws(gstep):
        return jax_step_draws(jax.random.fold_in(key, gstep), c["jsam"],
                              c["jset"], c["p0"].shape)
    for call in range(calls):
        *jstate, jframes, jl = jloop(*jstate, c["jclip"], None, None,
                                     c["jprompts"], key,
                                     jnp.int32(call * nf))
        *tstate, tframes, tl = tloop(*tstate, c["tclip"], c["tprompts"],
                                     draws, call * nf)
        assert tframes.shape == (nf, 48, 64, 3)
        assert tframes.dtype == torch.uint8
        assert tl.shape == (nf * opt_step,)
        diff = np.abs(tframes.numpy().astype(int) - np.asarray(jframes))
        assert diff.max() <= 1, diff.max()
        _close(c, jstate, tstate, jl, tl)
    assert int(tstate[1].count) == opt_step * nf * calls


def test_train_loop_matches_jax():
    """build_train_loop: three steps a dispatch, two dispatches from
    step0 = 0 and 3; the JAX loop folds each dispatch's key with the
    dispatch's step i, and the port is fed those draws."""
    n_inner, calls = 3, 2
    c = _setup(KW)
    jopt, topt, jstate, tstate = _start(c, n_inner * calls)
    jloop = jstep.build_train_loop(c["jpar"], c["jsam"], c["jcfg"],
                                   c["jset"], jopt, n_inner)
    tloop = tstep.build_train_loop(c["tpar"], c["tsam"], c["tcfg"],
                                   c["tset"], topt, n_inner)
    for call in range(calls):
        key = jax.random.fold_in(jax.random.PRNGKey(6), call)

        def draws(i, key=key):
            return jax_step_draws(jax.random.fold_in(key, i), c["jsam"],
                                  c["jset"], c["p0"].shape)
        *jstate, jl = jloop(*jstate, c["jclip"], None, None, c["jprompts"],
                            key, jnp.int32(call * n_inner))
        *tstate, tl = tloop(*tstate, c["tclip"], c["tprompts"], draws,
                            call * n_inner)
        assert tl.shape == (n_inner,)
        _close(c, jstate, tstate, jl, tl)


@pytest.mark.parametrize("size", [(64, 48), (720, 1280), (1080, 1920),
                                  (2160, 3840), (4320, 7680), (1, 1)])
@pytest.mark.parametrize("n_frames", [1, 2, 7, 8, 12, 17, 24, 100, 200])
def test_frames_per_dispatch_equals_jax(size, n_frames):
    assert (tstep.frames_per_dispatch(size, n_frames)
            == jstep.frames_per_dispatch(size, n_frames))


def _tiny(opt_step):
    c = _setup(dict(KW, enforce=0.3, sharp=0.2))
    opt = to.build_optimizer("adam_custom", LR, 8, prog=True)
    draw = tstep.build_draw_fn(c["tsam"], c["tset"], c["p0"].shape)
    return c, opt, draw


def _state(c, opt):
    p = fft_params_from_numpy(c["p0"])
    return p, opt.init(p), torch.zeros((c["tsam"].count, 32))


def _leaves(p, st, prev):
    return [p, st.count, st.mu, st.nu, prev]


@pytest.mark.parametrize("opt_step", [1, 2])
def test_frame_loop_does_not_depend_on_chunking(opt_step):
    """Four frame groups as one dispatch of four, four of one, and the
    eager steps with a render after each group's first step, all from one
    generator's draws in step order: the same params, optimizer state,
    prev_enc, losses and frames, bit for bit."""
    c, opt, draw = _tiny(opt_step)
    frames_eager, losses_eager = [], []
    step = tstep.build_train_step(c["tpar"], c["tsam"], c["tcfg"], c["tset"],
                                  opt)
    render = tstep.build_render(c["tpar"])
    gen = torch.Generator().manual_seed(7)
    p, st, prev = _state(c, opt)
    for i in range(4 * opt_step):
        p, st, prev, loss = step(p, st, prev, c["tclip"], c["tprompts"],
                                 draw(gen), i // opt_step)
        losses_eager.append(loss)
        if i % opt_step == 0:
            frames_eager.append(render(p, contrast=1.1))
    want = _leaves(p, st, prev) + [torch.stack(losses_eager),
                                   torch.stack(frames_eager)]
    for nf in (4, 1):
        loop = tstep.build_train_loop_frames(
            c["tpar"], c["tsam"], c["tcfg"], c["tset"], opt, opt_step, nf,
            contrast=1.1)
        gen = torch.Generator().manual_seed(7)
        state = _state(c, opt)
        frames, losses = [], []
        for call in range(4 // nf):
            *state, f, dl = loop(*state, c["tclip"], c["tprompts"],
                                 lambda g: draw(gen), call * nf)
            frames.append(f.clone())
            losses.append(dl.clone())
        got = _leaves(*state) + [torch.cat(losses), torch.cat(frames)]
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_loop_refuses_what_is_not_ported():
    c = _setup(KW)
    opt = to.build_optimizer("adam_custom", LR)
    args = (c["tpar"], c["tsam"], c["tcfg"], c["tset"], opt, 2, 1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tstep.build_train_loop_frames(*args, with_params=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tstep.build_train_loop_frames(*args, dual=(c["tcfg"], 2))
    with pytest.raises(ValueError, match="step_index"):
        tstep.build_train_loop_frames(*args, step_index="local")


def test_loop_copies_a_new_state_into_its_buffers():
    """A call with other tensors than the loop returned copies them into
    the loop's buffers (its graph reads those), so a loop resumed from a
    copy of its state continues as the loop itself does."""
    c, opt, draw = _tiny(1)
    loop = tstep.build_train_loop_frames(c["tpar"], c["tsam"], c["tcfg"],
                                         c["tset"], opt, 1, 1)
    gen = torch.Generator().manual_seed(3)
    state = loop(*_state(c, opt), c["tclip"], c["tprompts"],
                 lambda g: draw(gen), 0)[:3]
    p, st, prev = state
    copy = (p * 0.9, to.OptState(st.count + 1, st.mu * 0.5, st.nu * 2.0),
            prev * 0.7)
    g2 = torch.Generator().set_state(gen.get_state())
    out1 = loop(*copy, c["tclip"], c["tprompts"], lambda g: draw(gen), 1)
    assert out1[0] is p and out1[1] is st
    loop2 = tstep.build_train_loop_frames(c["tpar"], c["tsam"], c["tcfg"],
                                          c["tset"], opt, 1, 1)
    out2 = loop2(*copy, c["tclip"], c["tprompts"], lambda g: draw(g2), 1)
    for a, b in zip(_leaves(*out1[:3]) + list(out1[3:]),
                    _leaves(*out2[:3]) + list(out2[3:])):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="constant"):
        loop(*out1[:3], c["tclip"], ((c["tprompts"][0][0],
                                      c["tprompts"][0][1], 2.0),),
             lambda g: draw(gen), 2)


@pytest.mark.parametrize("name", ["adam", "adam_custom", "adamw",
                                  "adamw_custom"])
@pytest.mark.parametrize("prog", [False, True])
def test_optimizer_count_on_the_device_matches_optax(name, prog):
    """The step count is a 0-d int32 tensor on the params' device, moved
    in place; five updates match optax's chain (1e-5 relative), and so
    do the count and the second moment."""
    steps = 5
    rs = np.random.RandomState(11)
    p0 = rs.randn(3, 4, 5).astype(np.float32)
    grads = [rs.randn(3, 4, 5).astype(np.float32) for _ in range(steps)]
    jopt = jo.build_optimizer(name, LR, steps, prog)
    jp = jnp.asarray(p0)
    js = jopt.init(jp)
    topt = to.build_optimizer(name, LR, steps, prog)
    tp = torch.tensor(p0)
    ts = topt.init(tp)
    count = ts.count
    assert count.dtype == torch.int32 and count.shape == ()
    assert count.device == tp.device
    for g in grads:
        upd, js = jopt.update(jnp.asarray(g), js, jp)
        jp = optax.apply_updates(jp, upd)
        topt.step(tp, torch.tensor(g), ts)
    assert ts.count is count and int(count) == steps
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5,
                               atol=1e-6)
    leaves = [s for s in jax.tree.leaves(
        js, is_leaf=lambda x: hasattr(x, "nu")) if hasattr(s, "nu")]
    np.testing.assert_allclose(ts.nu.numpy(), np.asarray(leaves[0].nu),
                               rtol=1e-5)
    assert int(leaves[0].count) == int(ts.count)


def _sites():
    """(name, call) for every host table the step and the draws build,
    each now cached per device."""
    from aphantasia_torch.ops import augs, losses
    from aphantasia_torch.ops.perspective import perspective_endpoints
    from aphantasia_torch.params.color import clip_normalize, to_valid_rgb
    from aphantasia_torch.params.fft import FFTParameterizer
    gen = torch.Generator().manual_seed(1)
    img = torch.rand((1, 3, 20, 28), generator=gen)
    cuts = torch.rand((5, 3, 16, 16), generator=gen)
    idx = torch.arange(5) % 3
    over = CutoutSampler((40, 56), 5, 16, "overscan")

    def endpoints():
        return perspective_endpoints(torch.Generator().manual_seed(3), 5, 16,
                                     16)[1]

    def fast():
        gen = torch.Generator().manual_seed(4)
        return augs.transforms_fast_affine(augs.draw_fast(gen, 5, 16, 16),
                                           cuts)
    par = FFTParameterizer((20, 28), 1.5, 1.8)
    p = par.init(torch.Generator().manual_seed(5))
    return [
        ("color matrix", lambda: to_valid_rgb(img, 1.8)),
        ("clip mean and std", lambda: clip_normalize(cuts)),
        ("rotation angles", lambda: augs.random_rotate_affine(idx)),
        ("lucent scales", lambda: augs._scale_affine(idx,
                                                     augs._LUCENT_SCALES)),
        ("start points", fast),
        ("draw's start points", endpoints),
        ("scharr", lambda: losses.derivat(img, "scharr")),
        ("sobel", lambda: losses.derivat(img, "sobel")),
        ("overscan maps", lambda: over.tap_indices(
            over.sample_boxes(torch.Generator().manual_seed(6)))),
        ("decode", lambda: par.image(p)),
    ]


def _forbid_host_tables(monkeypatch):
    """torch.tensor and torch.as_tensor of host data raise from here on
    (as_tensor of a tensor stays: it copies nothing from the host)."""
    as_tensor = torch.as_tensor

    def no_table(data, *args, **kwargs):
        if isinstance(data, torch.Tensor):
            return as_tensor(data, *args, **kwargs)
        raise AssertionError("a tensor made from host data")
    monkeypatch.setattr(torch, "tensor", no_table)
    monkeypatch.setattr(torch, "as_tensor", no_table)


@pytest.mark.parametrize("site", range(10))
def test_host_tables_are_cached_per_device(monkeypatch, site):
    """After a first call, a second call of each site makes no tensor from
    host data (on the card that is a pageable copy, which makes the host
    wait for the card and which a CUDA graph's capture refuses) and
    returns the same."""
    name, call = _sites()[site]
    first = call()
    _forbid_host_tables(monkeypatch)
    again = call()
    monkeypatch.undo()
    for a, b in zip(first if isinstance(first, tuple) else (first,),
                    again if isinstance(again, tuple) else (again,)):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("transform,persp", [
    ("fast", "affine"), ("fast", "mixed"), ("fast", "exact"),
    ("custom", "affine"), ("elastic", "affine"), ("lucent", "affine"),
    ("openai", "affine")])
def test_step_and_draws_make_no_host_tables_after_the_first(monkeypatch,
                                                             transform, persp):
    """The whole draw and train step of each pipeline, with overscan taps,
    every loss term and --prog, builds no tensor from host data after its
    first step: the tables a capture would refuse are all cached."""
    c = _setup(dict(transform=transform, noise=0.1, expand=0.5, enforce=0.3,
                    sharp=0.2), tkw=dict(persp=persp))
    sam = CutoutSampler((48, 64), 4, 32, "overscan", 0.4)
    opt = to.build_optimizer("adam_custom", LR, 4, prog=True)
    step = tstep.build_train_step(c["tpar"], sam, c["tcfg"], c["tset"], opt)
    draw = tstep.build_draw_fn(sam, c["tset"], c["p0"].shape)
    gen = torch.Generator().manual_seed(8)
    p, st, prev = _state(c, opt)
    idx = torch.zeros((), dtype=torch.int32)
    for i in range(2):
        if i:
            _forbid_host_tables(monkeypatch)
        p, st, prev, loss = step(p, st, prev, c["tclip"], c["tprompts"],
                                 draw(gen), idx + i)
    monkeypatch.undo()
    assert torch.isfinite(loss) and int(st.count) == 2


def test_cli_chunked_path_with_profile(tmp_path, monkeypatch):
    """--steps 4 --opt_step 2 takes the chunked path (two frame groups in
    one dispatch): two frames, config.txt, four finite losses and step
    times, on_step once per step, and --profile writes a trace."""
    built = []
    real = clip_fft.build_train_loop_frames

    def spy(*args, **kwargs):
        built.append(args[5:7])
        return real(*args, **kwargs)
    monkeypatch.setattr(clip_fft, "build_train_loop_frames", spy)
    out, prof = str(tmp_path / "out"), str(tmp_path / "prof")
    seen = []
    res = clip_fft.run(clip_fft.get_args(
        ["-t", "x", "--size", "96-64", "--samples", "4", "--steps", "4",
         "--opt_step", "2", "-nv", "--device", "cpu", "--out_dir", out,
         "--profile", prof]), seen.append)
    assert built == [(2, 2)] and seen == [0, 1, 2, 3]
    run_dir = os.path.join(out, res.out_name)
    frames = sorted(f for f in os.listdir(run_dir) if f.endswith(".jpg"))
    assert frames == ["0000.jpg", "0001.jpg"]
    assert os.path.isfile(os.path.join(run_dir, "config.txt"))
    assert len(res.losses) == 4 and all(np.isfinite(res.losses))
    assert len(res.step_seconds) == 4 and min(res.step_seconds) > 0
    traces = [f for f in os.listdir(prof) if f.endswith(".json")]
    assert len(traces) == 1 and os.path.getsize(
        os.path.join(prof, traces[0])) > 0


def test_cli_chunked_and_per_step_paths_agree(tmp_path, monkeypatch):
    """The chunked path (opt_step 1 divides the steps) and the per-step
    loop (forced here by a step count the condition refuses) draw the
    same random stream: the first steps' losses and frames agree bit for
    bit."""
    def run(extra, out):
        return clip_fft.run(clip_fft.get_args(
            ["-t", "x", "--size", "96-64", "--samples", "4", "-nv",
             "--device", "cpu", "--out_dir", str(tmp_path / out)] + extra))
    chunked = run(["--steps", "3", "--opt_step", "1"], "a")
    monkeypatch.setattr(clip_fft, "build_train_loop_frames", None)
    per_step = run(["--steps", "3", "--opt_step", "4"], "b")
    assert chunked.losses == per_step.losses
    from aphantasia_torch.io.media import img_read
    a = img_read(os.path.join(tmp_path / "a", chunked.out_name, "0000.jpg"))
    b = img_read(os.path.join(tmp_path / "b", per_step.out_name, "0000.jpg"))
    np.testing.assert_array_equal(a, b)


def test_phase_timers_report_each_phase():
    """profiling.PhaseTimers (the JAX package's counterpart): a phase's
    calls and total time, largest first."""
    from aphantasia_torch.profiling import PhaseTimers, trace
    timers = PhaseTimers()
    for name in ("decode", "encode", "decode"):
        with timers.phase(name):
            pass
    assert timers.counts == {"decode": 2, "encode": 1}
    lines = timers.report().splitlines()
    assert len(lines) == 2 and all("ms/call" in ln for ln in lines)
    with trace(None):       # no dir: no profiler
        pass
