"""Host ms a frame of the video cell's preparation: the "frame.plan"
(`IllustripSetup.frame`: prompts and motion) and "draw" spans that start
inside the window, over the window's frames."""
from benchmark.harness import spans


def read(lay: dict):
    return spans.window_ms(lay, ("frame.plan", "draw"), "frames")
