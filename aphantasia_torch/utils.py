"""Small host-side utilities (counterpart of aphantasia_tpu.utils)."""
from __future__ import annotations

import collections.abc
import os


def txt_clean(txt: str) -> str:
    """Filename-safe prompt text."""
    table = str.maketrans(dict.fromkeys(list("\n',.—|!?/:;\\"), ""))
    return txt.translate(table).replace(" ", "_").replace('"', "")


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
