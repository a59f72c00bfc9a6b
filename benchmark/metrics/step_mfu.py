"""The step's share of the card's bf16 peak over the window: the tower's
forward and input gradient on the cutouts (and in a VQGAN cell the
decoder's forward, latent gradient and render) times the window's
steps, over the window's time and 989 TFLOP/s.  Read for `.still` and
`.video` alike."""
from benchmark.harness import layers


def read(lay: dict):
    return layers.step_mfu(lay)
