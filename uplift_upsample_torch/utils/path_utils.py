"""Path helpers (parity with reference `path_utils.py:11-20`; copied from the
JAX package's `utils/path_utils.py`)."""

import os


def mkdirs(path: str) -> None:
    os.makedirs(path, exist_ok=True)


def expandpath(path: str) -> str:
    return os.path.abspath(os.path.expanduser(os.path.expandvars(path)))
