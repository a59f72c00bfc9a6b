"""Seconds of set-up spent loading CLIP (cli/common.py `ClipWrapper`: the
checkpoint's read and conversion and the copy to the card), the sum of
the run's "setup.clip" spans."""
from benchmark.harness import spans


def read(lay: dict):
    return spans.total_s("setup.clip")
