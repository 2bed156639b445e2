"""The user entry points of ``examples/``, ported: each
``nnueehcs_tpu_torch/examples/<dir>/<name>.py`` is the counterpart of
``examples/<dir>/<name>.py`` and runs as ``python -m
nnueehcs_tpu_torch.examples.<dir>.<name>``. They take ``--device`` (the
card unless ``cpu`` is asked for) in place of ``--platform``, argparse in
place of click, the port's config reader in place of PyYAML, and ``csv``
and numpy in place of pandas. Plots need matplotlib, imported when a plot
is drawn; ``--no_plots`` leaves them out where it is missing."""
from __future__ import annotations

import os
from pathlib import Path

# the directory that holds the package, so ``python -m`` finds it from any
# working directory
PACKAGE_ROOT = str(Path(__file__).resolve().parents[2])


def package_env(drop=()) -> dict:
    """The environment for a subprocess that runs one of the package's
    modules: this process's, without the variables in ``drop``, with the
    package's root first on ``PYTHONPATH``."""
    env = {k: v for k, v in os.environ.items() if k not in drop}
    rest = [p for p in env.get('PYTHONPATH', '').split(os.pathsep) if p]
    env['PYTHONPATH'] = os.pathsep.join([PACKAGE_ROOT] + rest)
    return env
