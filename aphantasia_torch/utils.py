"""Small host-side utilities (counterpart of aphantasia_tpu.utils)."""
from __future__ import annotations

import collections.abc
import os


def txt_clean(txt: str) -> str:
    """Filename-safe prompt text."""
    table = str.maketrans(dict.fromkeys(list("\n',.—|!?/:;\\"), ""))
    return txt.translate(table).replace(" ", "_").replace('"', "")


def intrl(a: list, b: list, step: int = 2) -> list:
    """Every `step`-th element of `b` (from index `step` on) put into `a`,
    in place; the lists must be equally long and `step` > 1."""
    assert len(a) == len(b), f" diff lengths: {len(a)} {len(b)}"
    assert step > 1
    for num in list(range(len(a)))[step::step]:
        a[num] = b[num]
    return a


def minmax(x) -> tuple:
    """(min, max) of an array or tensor, as floats."""
    import numpy as np
    if hasattr(x, "detach"):
        x = x.detach().cpu()
    x = np.asarray(x)
    return (float(x.min()), float(x.max()))


def save_cfg(args, dir: str = "./", file: str | None = "config.txt"):
    """Dump the sorted run config."""
    if dir != "":
        os.makedirs(dir, exist_ok=True)
    try:
        args = vars(args)
    except TypeError:
        pass
    if file is None:
        print_dict(args)
    else:
        with open(os.path.join(dir, file), "w") as cfg_file:
            print_dict(args, cfg_file)


def print_dict(d, file=None, path="", indent=""):
    for k in sorted(d.keys()):
        if isinstance(d[k], collections.abc.Mapping):
            line = indent + str(k)
            print(line) if file is None else file.write(line + " \n")
            print_dict(d[k], file, k if path == "" else f"{path}->{k}",
                       indent + "   ")
        else:
            line = f"{indent}{k}: {d[k]}"
            print(line) if file is None else file.write(line + " \n")


def read_text(in_txt: str) -> list:
    """Text input: a literal string, or a file of one scene a line, where
    blank lines stay (as empty prompts) and '#' lines are comments."""
    if os.path.isfile(in_txt):
        with open(in_txt, "r", encoding="utf-8") as f:
            lines = f.read().splitlines()
        texts = []
        for tt in lines:
            if len(tt.strip()) == 0:
                texts.append("")
            elif tt.strip()[0] != "#":
                texts.append(tt.strip())
    else:
        texts = [in_txt]
    return texts


def pick_(list_, num_, loop: bool = False):
    """list_[num_], clamped to the last item, or wrapped with `loop`; None
    for an empty list."""
    cnt = len(list_)
    if cnt == 0:
        return None
    num = num_ % cnt if loop else min(num_, cnt - 1)
    return list_[num]
