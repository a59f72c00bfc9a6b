"""Host ms a step of the draws (step.py `build_draw_fn`'s "draw" spans:
the spectrum noise, the cutout boxes and the augmentation parameters)
that start inside the window, over the window's steps."""
from benchmark.harness import spans


def read(lay: dict):
    return spans.window_ms(lay, ("draw",), "steps")
