"""Host ms a step (a frame) that the loop blocks on the frame writer: the
"writer.wait" spans (io/media.py `AsyncFrameWriter._drain`, recorded only
where it waits) that start inside the window, over the window's steps
(frames).  Read for `.still` and `.video`."""
from benchmark.harness import spans


def read(lay: dict):
    per = "frames" if lay.get("kind") == "video" else "steps"
    return spans.window_ms(lay, ("writer.wait",), per)
